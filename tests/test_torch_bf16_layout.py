"""The layout rule of the patch gather's bf16 entry point, on the CPU.

The bf16 entry point loads its tiles through a TMA tensor map, which needs
a 16-byte-aligned canvas and a row pitch of a multiple of 16 bytes
(Wc % 8 == 0). `ops/orb.py::_bf16_kernel_layout_error` states the rule; the
wrapper refuses a CUDA canvas that breaks it (tests/test_torch_cuda.py).
Here: every canvas the port builds under MSSLAM_FORCE_TPU_NUMERICS meets
it (every file under configs/, and the geometries chip_smoke.py drives),
and the two ways to break it are named. Exact: the rule is integer.
"""
import glob
import os

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import _native, orb
from ms_slam_tpu_torch.utils.config import Settings

# the calls that took the gather's plain version, in _native.calls
PLAIN = "extract_patches_canvas"

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "*.yaml")))

# chip_smoke.py's geometries: (images, height, width, OrbConfig)
SMOKE = {
    "stereo": (2, 384, 1248, orb.OrbConfig(n_features=2048, n_levels=8)),
    "mono_rgbd": (1, 384, 1248, orb.OrbConfig(n_features=2048, n_levels=8)),
    "fisheye": (2, 512, 512, orb.OrbConfig(n_features=1024, n_levels=8)),
    "euroc": (2, 480, 752, orb.OrbConfig(n_features=1280, n_levels=8)),
    "vga": (1, 480, 640, orb.OrbConfig()),
}


def _bf16_canvas(B, h, w, cfg):
    """The canvas the frontend builds under the switch: the f32 pyramid
    packed and cast once to bf16 (as extract_canvas_multi does)."""
    imgs = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (B, h, w)).astype(np.float32))
    return orb.build_canvas_multi(imgs, cfg).contiguous().to(torch.bfloat16)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_every_config_canvas_suits_the_bf16_kernel(path):
    s = Settings(path)
    calib, cfg = s.calib(), s.orb()
    assert calib.width > 0 and calib.height > 0
    canvas = _bf16_canvas(1, calib.height, calib.width, cfg)
    assert canvas.shape[2] == orb.canvas_layout(calib.height, calib.width,
                                                cfg)[1]
    assert orb._bf16_kernel_layout_error(canvas.shape,
                                         canvas.data_ptr()) is None


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_chip_smoke_canvases_suit_the_bf16_kernel(name):
    canvas = _bf16_canvas(*SMOKE[name])
    assert canvas.shape[0] == SMOKE[name][0]
    assert orb._bf16_kernel_layout_error(canvas.shape,
                                         canvas.data_ptr()) is None


@pytest.mark.parametrize("width", [45, 1244, 1250, 5887])
def test_width_not_a_multiple_of_8_is_refused(width):
    why = orb._bf16_kernel_layout_error((2, 64, width), 1 << 20)
    assert why is not None and "multiple of 8" in why


@pytest.mark.parametrize("offset", [1, 4, 7])
def test_base_off_16_bytes_is_refused(offset):
    """A contiguous view `offset` bf16 elements into a fresh allocation
    (which PyTorch aligns) starts 2 * offset bytes off."""
    flat = torch.zeros(64 * 256 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    view = flat[offset:offset + 64 * 256].view(1, 64, 256)
    assert view.is_contiguous()
    why = orb._bf16_kernel_layout_error(view.shape, view.data_ptr())
    assert why is not None and "16-byte aligned" in why
    assert f"{2 * offset} bytes off" in why


def test_cpu_wrapper_takes_the_plain_version_whatever_the_layout():
    """On the CPU the wrapper takes the plain version for any bf16 canvas:
    the rule is the kernel's, and only a CUDA canvas reaches the kernel."""
    flat = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, 2 * 64 * 250 + 8).astype(np.float32)).to(torch.bfloat16)
    view = flat[1:1 + 2 * 64 * 250].view(2, 64, 250)
    bi = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
    ys = torch.tensor([0, 30, 63, 40, 22], dtype=torch.int32)
    xs = torch.tensor([249, 0, 100, 227, 300], dtype=torch.int32)
    before = _native.calls[PLAIN]
    out = orb.extract_patches_canvas(view, bi, ys, xs)
    assert _native.calls[PLAIN] == before + 1
    assert out.dtype == torch.float32 and out.shape == (5, 45, 45)
    assert torch.equal(out, orb.extract_patches_canvas_plain(
        view.contiguous(), bi, ys, xs).float())
