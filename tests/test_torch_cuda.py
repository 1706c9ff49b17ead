"""The patch-gather CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so the test marked `cuda` skips on a machine
without a card. It needs neither jax nor this directory's conftest.py, so
on a GPU machine that has only PyTorch it runs as

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: bit-exact (the kernel is a copy).
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import orb


def _inputs(rng, B=2, H=384, Wc=5888, n=512):
    canvas = rng.uniform(0, 255, (B, H, Wc)).astype(np.float32)
    ys = rng.integers(-8, H + 8, B * n).astype(np.int32)
    xs = rng.integers(-8, Wc + 8, B * n).astype(np.int32)
    # centres beyond each clip edge: top, bottom, left, right, corners
    ys[:6] = [0, H - 1, 100, 120, -4, H + 3]
    xs[:6] = [50, 60, 0, Wc - 1, -2, Wc + 5]
    bi = np.repeat(np.arange(B, dtype=np.int32), n)
    return canvas, bi, ys, xs


@pytest.mark.cuda
def test_patch_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(np.random.default_rng(0))]
    before = orb.patch_gather_launches
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert orb.patch_gather_launches == before + 1
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args))
    with pytest.raises(ValueError):          # f64 canvas: refused, not cast
        orb.extract_patches_canvas(args[0].double(), *args[1:])


def test_patch_gather_refuses_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel (CUDA) or raises."""
    canvas, bi, ys, xs = (torch.from_numpy(a).to("meta") for a in
                          _inputs(np.random.default_rng(0), H=64, Wc=256,
                                  n=4))
    with pytest.raises(ValueError, match="no patch gather"):
        orb.extract_patches_canvas(canvas, bi, ys, xs)


@pytest.mark.cuda
def test_argmin_ties_first_index_on_card():
    """bow_vector's word votes take the first of tied Hamming minima on the
    card too, as jnp.argmin does (tests/test_torch_relocalization.py pins
    the CPU side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.models import vocab
    d = torch.randint(0, 4, (512, 300), device="cuda")
    d[:, [7, 11]] = -1
    assert bool((torch.argmin(d, dim=1) == 7).all())
    cb = vocab.make_codebook(16, device="cuda")
    cb[9] = cb[2]
    h = vocab.bow_vector(cb, cb[[2, 2]],
                         torch.ones(2, dtype=torch.bool, device="cuda"))
    assert h[2].item() == pytest.approx(2 / 3)
    assert h[9].item() == pytest.approx(1 / 3)
