"""Kernels launched on the card in the profiler slice, divided by the
slice's frames. Layer: device. From the device trace."""


def read(rec):
    s = rec["slice"]
    if not s or not s["frames"]:
        return None
    return s["kernels"] / s["frames"]
