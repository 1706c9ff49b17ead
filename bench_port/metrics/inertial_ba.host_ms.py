"""Host time of the visual-inertial window BA of one keyframe
(`System.timing["inertial_window_ba"]`), averaged over the window's
keyframes that ran it, in ms. Layer: ops.inertial_opt (window BA). Host
time, not device time."""


def read(rec):
    t = rec["timing"].get("inertial_window_ba")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
