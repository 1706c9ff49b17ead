"""Host time of the frontend stage (`System.timing["frontend"]`: the
upload and ORB / stereo dispatch, or the wait for the prefetched frame),
summed over the window and divided by its frames, in ms. Layer:
pipeline.frontend (ops.orb, ops.stereo). Host time, not device time."""


def read(rec):
    t = rec["timing"].get("frontend")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
