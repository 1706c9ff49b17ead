"""Host time blocked on the device-to-host fetch of the frames' tracking
stats (`System.timing["stats_fetch"]`), summed over the window and divided
by the window's frames, in ms. Layer: pipeline.system (the software
pipeline's completion). Host time, not device time."""


def read(rec):
    t = rec["timing"].get("stats_fetch")
    if not t or not rec["frames"]:
        return None
    return 1e3 * sum(t) / rec["frames"]
