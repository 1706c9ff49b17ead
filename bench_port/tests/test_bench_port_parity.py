"""What the KB8 rig, the longer drive and the drive's wrap shift leave as
it was, on the CPU at small sizes: the pitch and roll waves and their
absence; the tiny drive's (its wrap shift taken out) and corridor's
rendered pairs, poses and IMU rows against digests of the harness before a
configuration could bring a KB8 rig; the pixels the wrap shift changes;
the frame counts against the corridor's distinct length, and `Feed`'s
bound.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

from bench_port.harness import inputs, registry, window  # noqa: E402
from bench_port.scenes import motion, world  # noqa: E402
from digest_parity import _sha  # noqa: E402
import test_bench_port_harness as th  # noqa: E402

SEED = 2 ** 31 + 17
N_FRAMES = 48
# the most pairs the drive may render on one period of its texture
CEILING = 349

# sha256 of the tiny cells' inputs on the configurations' own scenes, as
# the harness gave them with a rectified pinhole rig only
DIGESTS = {
    "drive": {
        "pairs":
            "ddcc3808f2dae58908e01009fceeda8e6608b65b841ce9332eb92cc0c1d4d6ec",
        "poses":
            "dfc4186b40bc2f3303ae3daff9640f193a0044a5f78918bbeed969988d470160",
        "imu": None,
    },
    "corridor": {
        "pairs":
            "75f594f1c209ccc12fa641052a811b692a33af3fac1d778c6cc24976a47fcef0",
        "poses":
            "e5ebab466315cb8e51c38d873a2ab18a20a04270abe33cc18d7d4a8fc4a24e08",
        "imu":
            "b267b2184a9cdacae03004413b926b811eb3b14e124778fb6d29033615a6217f",
    },
}


def digests(cfg, traffic) -> dict:
    """The digests of the inputs the harness makes: pairs, poses, IMU rows
    with the true bias. Nothing of the program's run: its numbers would
    move with any change to the program's arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = inputs.make(inputs.system_config(cfg), cfg, traffic, SEED,
                          8.0, "cpu", N_FRAMES)
    finally:
        torch.set_num_threads(threads)
    return {"pairs": _sha(x for p in inp.frames for x in p),
            "poses": _sha([inp.poses]),
            "imu": _sha(inp.imu + [inp.bias]) if inp.imu else None}


def _tiny(name, tmp_path):
    yaml = {"drive": th.TINY_YAML, "corridor": th.TINY_IMU_YAML}[name]
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml)
    cell = registry.cell({"drive": "kitti00-02-stereo.drive",
                          "corridor": "euroc-stereo-inertial.corridor"}[name])
    cfg = registry.config(cell["config"])
    cfg["yaml_path"] = str(path)
    return cfg, registry.traffic(cell["traffic"])


@pytest.mark.parametrize("name", ["drive", "corridor"])
def test_tiny_cells_equal_the_pinhole_harness(name, tmp_path):
    cfg, traffic = _tiny(name, tmp_path)
    cfg["scene"].pop("wrap_shift", None)
    assert digests(cfg, traffic) == DIGESTS[name]


def test_wrap_shift_changes_only_the_walls_past_the_first_period():
    """The drive's scene with and without its wrap shift, from a pose that
    sees past the texture's first period: the pixels that differ are
    those whose surface point lies past it (or within one texel of it),
    and past it the shift changes most of them."""
    scene = dict(registry.config("kitti00-02-stereo")["scene"])
    plain = {k: v for k, v in scene.items() if k != "wrap_shift"}
    period = scene["tex_scale"] * scene["tex_size"]
    rays = world.pinhole_rays(200.0, 200.0, 160.0, 120.0, 240, 320, "cpu")
    T = torch.eye(4, dtype=torch.float64)[None].clone()
    T[0, 2, 3] = period - 12.0
    shifted = world.CorridorWorld.from_seed(5, "cpu", **scene)
    img, depth, X = shifted.cast(T, rays)
    ref = world.CorridorWorld.from_seed(5, "cpu", **plain).cast(T, rays)[0]
    z = X[0, ..., 2]
    near = z < period - scene["tex_scale"]
    assert bool(torch.equal(img[0][near], ref[0][near]))
    past = z >= period
    assert int(past.sum()) > 1000
    assert float((img[0][past] != ref[0][past]).double().mean()) > 0.5


def test_the_drive_sees_no_wall_twice():
    """Every mix's frames at 51 s see less corridor than comes before its
    walls repeat: the drive's 1,695 pairs (300 + 27 x 51 + 18) thanks to
    its wrap shift, which it needs (one period of the texture holds
    349 pairs at most); the corridor keeps its 983 on the plain texture."""
    for cell, count in (("kitti00-02-stereo.drive", 1695),
                        ("euroc-stereo-inertial.corridor", 983)):
        c = registry.cell(cell)
        cfg, traffic = registry.config(c["config"]), registry.traffic(
            c["traffic"])
        n = inputs.frame_count(traffic, 51)
        assert n == count
        cam = inputs.camera(inputs.system_config(cfg).calib)
        seen = inputs.seen_length(cfg["scene"], cam, traffic["motion"], n)
        assert seen < inputs.distinct_length(cfg["scene"])
    drive = registry.config("kitti00-02-stereo")
    cam = inputs.camera(inputs.system_config(drive).calib)
    scene = {k: v for k, v in drive["scene"].items() if k != "wrap_shift"}
    move = registry.traffic("drive")["motion"]
    period = inputs.distinct_length(scene)
    assert inputs.seen_length(scene, cam, move, CEILING) < period
    assert inputs.seen_length(scene, cam, move, CEILING + 1) >= period
    assert inputs.distinct_length(drive["scene"]) == 4 * period


def test_wrap_shift_too_small_is_refused():
    scene = dict(registry.config("kitti00-02-stereo")["scene"],
                 wrap_shift=256)
    with pytest.raises(ValueError, match="strips 256 rows apart"):
        inputs.distinct_length(scene)


WAVES = {"speed_m_per_frame": 0.05,
         "lateral_m": {"amp": 0.08, "hz": 0.8, "phase": 1.0},
         "yaw_rad": {"amp": 0.1, "hz": 0.25}}


def test_no_pitch_or_roll_keeps_the_poses():
    """A mix without the new waves gets the yaw alone, bit for bit."""
    n, fps = 60, 20.0
    got = motion.poses(n, WAVES, fps)
    t = np.arange(n) / fps
    want = np.tile(np.eye(4), (n, 1, 1))
    want[:, 0, 3] = 0.08 * np.sin(2 * np.pi * 0.8 * t + 1.0)
    want[:, 2, 3] = 0.05 * np.arange(n, dtype=np.float64)
    want[:, :3, :3] = motion._yaw(0.1 * np.sin(2 * np.pi * 0.25 * t + 0.0))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("keys", [("pitch_rad",), ("roll_rad",),
                                  ("pitch_rad", "roll_rad")])
def test_pitch_and_roll_waves(keys):
    from scipy.spatial.transform import Rotation
    n, fps = 50, 20.0
    mix = dict(WAVES)
    waves = {"pitch_rad": {"amp": 0.05, "hz": 0.4, "phase": 0.5},
             "roll_rad": {"amp": 0.04, "hz": 0.3, "phase": 2.0}}
    for k in keys:
        mix[k] = waves[k]
    P = motion.poses(n, mix, fps)
    t = np.arange(n) / fps

    def wave(k):
        w = mix.get(k)
        if w is None:
            return np.zeros(n)
        return w["amp"] * np.sin(2 * np.pi * w["hz"] * t + w.get("phase", 0))

    want = Rotation.from_euler(
        "YXZ", np.stack([wave("yaw_rad"), wave("pitch_rad"),
                         wave("roll_rad")], 1)).as_matrix()
    np.testing.assert_allclose(P[:, :3, :3], want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(P[:, :3, 3],
                                  motion.poses(n, WAVES, fps)[:, :3, 3])
    for k in keys:
        assert np.abs(wave(k)).max() > 0.5 * mix[k]["amp"]


class _Stub:
    def __init__(self):
        self.calls = 0

    def track_stereo(self, left, right, ts, next_images=None):
        self.calls += 1


def test_drive_feeds_thirty_frames_a_second():
    """After the longest warm-up a drive run has seen (144 frames), 30
    frames/s over 51 s and the traced slice's 14 frames stay inside the
    rendered sequence; the frame after its end raises."""
    n = inputs.frame_count(registry.traffic("drive"), 51)
    inp = types.SimpleNamespace(frames=[(None, None)] * n, fps=10.0,
                                imu=None)
    slam = _Stub()
    feed = window.Feed(slam, inp)
    last = 144 + 30 * 51 + 14
    for i in range(last):
        feed.call(i)
    assert slam.calls == last
    with pytest.raises(window.SequenceExhausted):
        feed.call(n - 1)
