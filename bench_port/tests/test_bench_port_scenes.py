"""The frozen copies under scenes/ and reference/ against their sources in
the port, on the CPU at small sizes.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
torch.set_num_threads(2)

from bench_port.reference import frontend as ref_frontend  # noqa: E402
from bench_port.scenes import evaluate, motion, roofline, world  # noqa: E402
from ms_slam_tpu_torch.utils import evaluate as src_eval  # noqa: E402
from ms_slam_tpu_torch.utils import synth  # noqa: E402

K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]])


def _source_world():
    return synth.CorridorWorld(np.random.default_rng(3), half_w=2.0,
                               y_floor=1.0, tex_size=768)


@pytest.mark.parametrize("z,yaw", [(0.0, 0.0), (1.3, 0.2), (7.7, -0.4)])
def test_renderer_within_one_grey_level(z, yaw):
    src = _source_world()
    mine = world.CorridorWorld(torch.from_numpy(np.stack(src.tex)),
                               half_w=2.0, y_floor=1.0)
    T = np.eye(4)
    T[:3, :3] = motion._yaw(np.array([yaw]))[0]
    T[2, 3] = z
    want = [np.clip(im, 0, 255).astype(np.uint8)
            for im in src.render_stereo(K, T, 0.3, 48, 64)]
    rays = world.pinhole_rays(60.0, 60.0, 32.0, 24.0, 48, 64, "cpu")
    got = world.render_stereo_u8(mine, torch.from_numpy(T[None]), rays,
                                 0.3)[0].numpy()
    for g, w in zip(got, want):
        assert np.abs(g.astype(int) - w).max() <= 1


def test_texture_from_seed():
    a = world.CorridorWorld.from_seed(5, "cpu", tex_size=768).tex
    b = world.CorridorWorld.from_seed(5, "cpu", tex_size=768).tex
    c = world.CorridorWorld.from_seed(6, "cpu", tex_size=768).tex
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (4, 768, 768) and 15 <= float(a.min())
    assert float(a.max()) <= 240


def test_forward_motion_is_the_sources():
    got = motion.poses(40, {"speed_m_per_frame": 0.12}, 10.0)
    want = np.stack(synth.make_trajectory(40, "forward"))
    assert np.array_equal(got, want)


def test_imu_rows_equal_the_sources():
    P = motion.poses(12, {"speed_m_per_frame": 0.04,
                          "lateral_m": {"amp": 0.08, "hz": 0.8, "phase": 1.0},
                          "vertical_m": {"amp": 0.12, "hz": 1.0},
                          "yaw_rad": {"amp": 0.05, "hz": 0.1}}, 20.0)
    got = motion.make_imu(P, 0.05, imu_rate=200)
    want = synth.make_imu(list(P), 0.05, imu_rate=200)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_ate_equals_the_sources():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(30, 3))
    est = gt + 0.05 * rng.normal(size=(30, 3))
    assert evaluate.ate_rmse(est, gt) == src_eval.ate_rmse(est, gt)


def test_patch_gather_bytes():
    # chip_smoke.py phase 3's bytes at the stereo canvas, f32 and bf16
    assert roofline.patch_gather_bytes((2, 384, 5888), 4, 4096) == 51314688
    assert roofline.patch_gather_bytes((2, 384, 5888), 2, 4096) == 42270720


def test_plain_frontend_equals_the_ports():
    """The frozen plain frontend against the port's, slot by slot, on a
    rendered 320x240 pair (CPU: the port takes its plain gather here)."""
    from ms_slam_tpu_torch.ops import orb
    from ms_slam_tpu_torch.pipeline import frontend as port
    src = synth.CorridorWorld(np.random.default_rng(1), tex_size=768)
    Kf = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1.0]])
    T = np.eye(4)
    T[2, 3] = 2.0
    l, r = [np.clip(im, 0, 255).astype(np.uint8)
            for im in src.render_stereo(Kf, T, 0.11, 240, 320)]
    cfg = orb.OrbConfig(n_features=512, n_levels=4)
    calib = port.Calib(model=0, params=(200.0, 200.0, 160.0, 120.0),
                       bf=22.0, width=320, height=240)
    fr = port.process_stereo_stacked(torch.from_numpy(np.stack([l, r])),
                                     calib, cfg)
    ref = ref_frontend.stereo_frontend(
        l, r, ref_frontend.Orb(512, 4, 1.2, 20.0, 7.0), 22.0, 200.0, "cpu")
    f = fr.feats
    assert np.array_equal(f.valid.numpy(), ref["valid"])
    assert np.array_equal(f.xy.numpy(), ref["xy"])
    assert np.array_equal(f.octave.numpy(), ref["octave"])
    assert np.array_equal(f.angle.numpy(), ref["angle"])
    assert np.array_equal(f.desc.numpy(), ref["desc"])
    assert np.array_equal(fr.depth.numpy(), ref["depth"])
    assert np.array_equal(fr.u_right.numpy(), ref["u_right"])
    assert int(f.valid.sum()) > 300 and int((fr.depth > 0).sum()) > 100
