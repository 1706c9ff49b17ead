"""The port's own copies of the numpy-only utilities, its import boundary,
and the patch gather's plain version at keypoint counts that are no
multiple of four.

- Boundary: after importing every module of the port, no loaded module is
  named jax* or ms_slam_tpu*, and none was executed from a file of the
  reference package (a file run by path would hide behind the port's name).
- Copies: `utils.synth` and `utils.evaluate` give what the reference's
  modules give from the same seed, array for array (exact: same code).
- Patch gather: the CUDA kernel writes keypoints in aligned groups of four
  and the remaining n % 4 on a scalar path; its CPU-side reference is the
  plain version, held here against the reference's gather at n = 1, 5 and
  4095. Bit-exact (a copy).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.utils import evaluate as jevaluate
from ms_slam_tpu.utils import synth as jsynth
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.utils import evaluate, synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_runs_no_file_of_the_reference():
    code = (
        "import pkgutil, importlib, os, sys\n"
        "import ms_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from ms_slam_tpu_torch.utils import synth, evaluate\n"
        "assert len(mods) >= 17, mods\n"
        "ref = os.path.join(os.path.dirname(os.path.dirname("
        "os.path.abspath(p.__file__))), 'ms_slam_tpu') + os.sep\n"
        "bad = [n for n, m in list(sys.modules.items())\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'ms_slam_tpu')\n"
        "       or os.path.abspath(getattr(m, '__file__', None) or '')"
        ".startswith(ref)]\n"
        "assert not bad, bad\n"
        "assert synth.__name__ == 'ms_slam_tpu_torch.utils.synth'\n"
        "assert evaluate.__name__ == 'ms_slam_tpu_torch.utils.evaluate'\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_synth_copy_renders_the_same_stereo_frame():
    h, w, fx = 48, 64, 60.0
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    T = jsynth.make_trajectory(5, "forward")[3]
    frames = []
    for mod in (jsynth, synth):
        world = mod.CorridorWorld(np.random.default_rng(7), tex_size=768)
        frames.append(world.render_stereo(K, T, 0.2, h, w))
    for ref, got in zip(*frames):
        assert ref.shape == (h, w) and ref.std() > 1.0
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pattern", ["arc", "forward"])
def test_synth_copy_make_trajectory(pattern):
    np.testing.assert_array_equal(synth.make_trajectory(12, pattern),
                                  jsynth.make_trajectory(12, pattern))


def test_evaluate_copy_ate_rmse():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    est = gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) \
        + rng.normal(0, 0.01, gt.shape) + 2.0
    for with_scale in (False, True):
        a = evaluate.ate_rmse(est, gt, with_scale)
        assert a == jevaluate.ate_rmse(est, gt, with_scale)
        assert 0.0 < a < 0.05


@pytest.mark.parametrize("n", [1, 5, 4095])
def test_patch_gather_plain_when_n_is_no_multiple_of_four(n):
    rng = np.random.default_rng(n)
    B, H, Wc, R = 2, 64, 256, torb.EXTRACT_R
    canvas = rng.uniform(0, 255, (B, H, Wc)).astype(np.float32)
    # from the low clip edge upward and beyond the high edges (below R the
    # reference's dynamic_slice counts a negative start from the far end)
    ys = rng.integers(R, H + 6, n).astype(np.int32)
    xs = rng.integers(R, Wc + 6, n).astype(np.int32)
    bi = rng.integers(0, B, n).astype(np.int32)
    ys[-1], xs[-1], bi[-1] = H + 5, Wc + 5, B - 1      # the tail's last patch
    ref = np.asarray(jorb.extract_patches_canvas(
        jnp.asarray(canvas), jnp.asarray(bi), jnp.asarray(ys), jnp.asarray(xs)))
    args = [torch.from_numpy(a) for a in (canvas, bi, ys, xs)]
    out = torb.extract_patches_canvas(*args)
    assert out.shape == (n, 45, 45) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)
    # the last patch is the canvas's bottom-right corner of image B-1
    np.testing.assert_array_equal(out[-1].numpy(), canvas[-1, -45:, -45:])
