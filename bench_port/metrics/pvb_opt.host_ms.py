"""Host time of the inertial tracking refinement (`System.timing
["pvb_opt"]`: `pose_vel_bias_optimize` and the selects of its solution,
once a frame of `track_full_imu`), summed over the window and divided by
its frames, in ms. Layer: ops.inertial_opt. Host time, not device time."""


def read(rec):
    t = rec["timing"].get("pvb_opt")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
