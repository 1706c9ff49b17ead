"""The sharded global BA and an unrectified stereo pair.

`parallel/dist_ba.py` builds its factor table from the left keypoints
alone: it has no right-camera rows, and without them a stereo-fisheye map's
scale is free. So `dist_global_ba` refuses such a calibration, and the loop
closer sends such a map to `mapping_ops.global_ba` (which adds the right
rows) even where the System asks for a sharded solve.
"""
from types import SimpleNamespace

import pytest
import torch

from ms_slam_tpu_torch.parallel import dist_ba
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.loop_closing import LoopCloser

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 150.0, 0.4
KB8P = (FX, FX, W / 2, H / 2, 0.02, -0.005, 0.001, -0.0002)
RIG = dict(model=1, params=KB8P, bf=FX * BL, width=W, height=H,
           th_depth=BL * 40, fps=10.0, params2=KB8P,
           T_rl=(1.0, 0.0, 0.0, -BL, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0),
           lapping=(0, W - 1, 0, W - 1))
PINHOLE = dict(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL, width=W,
               height=H, th_depth=BL * 40, fps=10.0)


def test_dist_global_ba_refuses_a_kb8_pair():
    calib = Calib(**RIG)
    assert calib.is_fisheye_stereo
    with pytest.raises(ValueError, match="right-camera rows"):
        dist_ba.dist_global_ba(None, calib, None, 0, None)


@pytest.mark.parametrize("kw, sharded", [(RIG, False), (PINHOLE, True)],
                         ids=["kb8_pair", "pinhole"])
def test_loop_closer_routes_a_kb8_pair_to_the_local_solve(kw, sharded):
    """With two CPU shards asked for, a rectified System gets the mesh and
    a KB8 pair gets None: the local solve, with its right rows."""
    sys_ = SimpleNamespace(cfg=SimpleNamespace(dist_ba_devices=2),
                           device=torch.device("cpu"), calib=Calib(**kw))
    closer = SimpleNamespace(sys=sys_, _ba_mesh=None)
    mesh = LoopCloser._global_ba_mesh(closer)
    assert (mesh is not None) == sharded
