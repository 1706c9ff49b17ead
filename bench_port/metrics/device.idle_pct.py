"""Share of the profiler slice's wall time in which no kernel, copy or
fill ran on the card, in %. Layer: device. From the device trace."""


def read(rec):
    s = rec["slice"]
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
