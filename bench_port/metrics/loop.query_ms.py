"""Host time of one place-recognition query (the benchmark's span around
`pipeline.loop_closing.detect_and_verify`), averaged over the window's
queries, in ms. Layer: pipeline.loop_closing. Host time."""


def read(rec):
    t = rec["spans"].get("loop_query")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
