"""Host time of one sparsification window (the benchmark's span around
`pipeline.sparsification.sparsify_window`), averaged over the window's
sparsification windows, in ms. Layer: pipeline.sparsification
(ops.select). Host time, not device time."""


def read(rec):
    t = rec["spans"].get("sparsify_window")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
