"""Host time of the track stage (`System.timing["track"]`: the tracking
dispatch, the next frame's prefetch and the completion of the frames in
flight, keyframe steps included), summed over the window and divided by
its frames, in ms. Layer: pipeline.tracking_ops (ops.pose_opt,
ops.matching; ops.inertial_opt in the inertial cell). Host time."""


def read(rec):
    t = rec["timing"].get("track")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
