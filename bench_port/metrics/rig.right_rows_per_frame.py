"""Right-camera rows a frame: the rows of an unrectified pair's right
keypoints that the frame's tracking solves (each `pose_optimize` of the
cascade and the local map, and the inertial refinement) kept as inliers,
as the program counts them in its stats pack (`System.timing
["rig.right_rows"]`, one event a completed frame), averaged over the
window's frames. Layer: ops.pose_opt. A count; a rectified rig, or a
program without right rows, reads nothing."""


def read(rec):
    t = rec["timing"].get("rig.right_rows")
    if not t:
        return None
    return sum(t) / len(t)
