"""Host time of the projection searches (`System.timing["search"]`: each
`search_by_projection` call of the tracking step, two or three a frame),
summed over the window and divided by its frames, in ms. Layer:
ops.matching. Host time, not device time."""


def read(rec):
    t = rec["timing"].get("search")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
