"""Host time of one keyframe step (`System.timing["keyframe_step"]`:
insertion, triangulation, fusion, the window BA, culling), averaged over
the window's keyframes, in ms. Layer: pipeline.mapping_ops (ops.ba).
Host time, not device time."""


def read(rec):
    t = rec["timing"].get("keyframe_step")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
