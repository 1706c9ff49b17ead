"""The program's marked blocking points a frame: the events of every
`sync.*` key of `System.timing` (each a call that waits for the device,
`ms_slam_tpu_torch/utils/trace.py`), counted over the window and divided
by its frames. Layer: pipeline.system. A count; unmarked syncs (small
host-to-device copies) are not in it."""


def read(rec):
    ts = [t for k, t in rec["timing"].items() if k.startswith("sync.")]
    if not ts or not rec["frames"]:
        return None
    return sum(len(t) for t in ts) / rec["frames"]
