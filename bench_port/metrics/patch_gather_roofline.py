"""The patch-gather kernel's share of its roofline: the least time its
calls in the profiler slice could take (their bytes at 3.35 TB/s,
scenes/roofline.py) over the device time of its kernels there, in %.
Layer: kernel csrc/patch_gather.cu. From the device trace."""


def read(rec):
    g = rec["slice"].get("gather") if rec["slice"] else None
    if not g or g["kernel_s"] <= 0:
        return None
    return 100.0 * g["bound_s"] / g["kernel_s"]
