"""Host time blocked at the tracking step's two host branches
(`System.timing["sync.track_wide"]` and `["sync.track_fallback"]`: the
inlier counts that decide the widened retry and the appearance fallback),
summed over the window and divided by its frames, in ms. Layer:
pipeline.tracking_ops. Host time waiting on the device."""

KEYS = ("sync.track_wide", "sync.track_fallback")


def read(rec):
    ts = [rec["timing"][k] for k in KEYS if k in rec["timing"]]
    if not ts or not rec["frames"]:
        return None
    return 1e3 * sum(sum(t) for t in ts) / rec["frames"]
