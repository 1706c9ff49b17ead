"""Host time of the local-map selection (`System.timing
["track.local_select"]`: the local-keyframe vote, the local-map mask and
the gather of its points, once a frame), summed over the window and
divided by its frames, in ms. Layer: models.map_state. Host time, not
device time."""


def read(rec):
    t = rec["timing"].get("track.local_select")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
