"""Host time of the motion-only pose optimizations
(`System.timing["pose_opt"]`: each `pose_optimize` call of the tracking
step, two to four a frame), summed over the window and divided by its
frames, in ms. Layer: ops.pose_opt. Host time, not device time."""


def read(rec):
    t = rec["timing"].get("pose_opt")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
