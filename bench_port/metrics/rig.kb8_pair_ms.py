"""Host time of an unrectified KB8 pair's matching in the frontend
(`System.timing["frontend.kb8_pair"]`: the mutual descriptor match, the
DLT, its two-step polish and the gates of `process_stereo_fisheye`, inside
`frontend`), summed over the window and divided by its frames, in ms.
Layer: pipeline.frontend. Host time, not device time; a rectified rig has
no such span and reads nothing."""


def read(rec):
    t = rec["timing"].get("frontend.kb8_pair")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
