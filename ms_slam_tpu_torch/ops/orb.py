"""ORB feature extraction on canvas-packed pyramids.

Port of the canvas path of `ms_slam_tpu/ops/orb.py`: all pyramid levels of
an image sit side by side in one (H, Wc) plane; FAST-9, 3x3 NMS and the
per-cell / per-level top-k run on that plane; orientation and steered BRIEF
run on one 45x45 raw patch per keypoint. The patch gather is the
hand-written CUDA kernel `csrc/patch_gather.cu` (the reference's one Pallas
kernel); everything else is plain torch.

The canvas stays float32 on the card (the reference's bf16 canvas is a TPU
bandwidth choice). Descriptors are (N,8) int32 with the reference's uint32
bits. Parity hazards handled here (see tests/test_torch_orb.py):

- resize: `jax.image.resize(..., "bilinear")` antialiases; its weight
  matrices are rebuilt in numpy from JAX's formula (`_resize_weights`);
- detection packing `round(rank*64)*1024 + pos` and the 4x8 sub-block
  maxima are kept bit for bit (`detect_canvas`); `torch.round` rounds half
  to even like `jnp.round`;
- top-k ties break to the lowest index (`indexing.top_k`);
- descriptor bits compare bf16-rounded blurred values, evaluated only at
  the keypoint's angle bin (`descriptors_from_patches`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _native
from .indexing import to_int32_bits, top_k


class OrbConfig(NamedTuple):
    """Static extraction parameters (defaults mirror the reference YAMLs:
    nFeatures=2000, scaleFactor=1.2, nLevels=8, iniThFAST=20, minThFAST=7)."""

    n_features: int = 2048
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell_size: int = 32
    cell_top_k: int = 8
    edge: int = 19
    patch_radius: int = 15

    def level_scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def level_quotas(self):
        inv = 1.0 / self.scale_factor
        base = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        q = [int(round(base * inv ** l)) for l in range(self.n_levels)]
        q[0] += self.n_features - sum(q)
        return q


class Features(NamedTuple):
    """One image's features, capacity N = cfg.n_features."""

    xy: torch.Tensor        # (N,2) float32 level-0 pixel coords
    response: torch.Tensor  # (N,) float32 FAST score
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N,8) int32 packed 256-bit descriptor
    valid: torch.Tensor     # (N,) bool


_FAST_CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32)

PATCH_R = 19                  # blurred patch radius available to BRIEF
EXTRACT_R = PATCH_R + 3       # raw patch radius extracted per keypoint
N_ANGLE_BINS = 30             # steered-BRIEF angle quantization


@functools.lru_cache()
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 0x0B12EF):
    """Seeded Gaussian BRIEF pairs (n_bits, 4) [dy1,dx1,dy2,dx2] — the same
    numpy construction as the reference, so descriptors are bit-compatible."""
    rs = np.random.RandomState(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 2
    pts = np.clip(np.round(rs.normal(0.0, sigma, size=(n_bits, 4))), -lim, lim)
    return pts.astype(np.int32)


def pyramid_shapes(h: int, w: int, cfg: OrbConfig):
    return [(int(round(h / s)), int(round(w / s))) for s in cfg.level_scales()]


@functools.lru_cache()
def canvas_layout(h: int, w: int, cfg: OrbConfig):
    """Per-level column offsets (cell-aligned) + canvas width (a multiple of
    lcm(cell, 128), as in the reference, so the layouts agree)."""
    shapes = pyramid_shapes(h, w, cfg)
    cs = cfg.cell_size
    offs, x = [], 0
    for (lh, lw) in shapes:
        offs.append(x)
        x += ((lw + cs - 1) // cs) * cs
    lcm = cs * 128 // np.gcd(cs, 128)
    Wc = ((x + lcm - 1) // lcm) * lcm
    return tuple(offs), Wc, tuple(shapes)


@functools.lru_cache()
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of `jax.image.resize(..., "bilinear")` along one
    axis, from JAX's compute_weight_mat: a triangle kernel widened by
    1/scale when downsampling (antialias=True), normalised per output
    sample, zeroed where the sample falls outside the input. Built in f64
    and cast to f32, as the reference does under x64."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None]
               ) / kernel_scale
    wts = np.maximum(0.0, 1.0 - np.abs(x))
    tot = np.sum(wts, axis=0, keepdims=True)
    wts = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(tot != 0, tot, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], wts, 0).astype(np.float32)


@functools.lru_cache()
def _resize_weights(in_size: int, out_size: int, device: torch.device):
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


def build_canvas_multi(imgs: torch.Tensor, cfg: OrbConfig) -> torch.Tensor:
    """(B,H,W) float32 -> (B,H,Wc) packed canvases (level l at columns
    [off_l, off_l+w_l), rows [0, h_l)). Each level is the antialiased
    bilinear resize as two matmuls with the reference's weights."""
    B, h, w = imgs.shape
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    parts = []
    for l, (lh, lw) in enumerate(shapes):
        if l == 0:
            img_l = imgs
        else:
            wy = _resize_weights(h, lh, imgs.device)
            wx = _resize_weights(w, lw, imgs.device)
            img_l = wy.T @ imgs @ wx
        seg_w = (offs[l + 1] if l + 1 < len(offs) else Wc) - offs[l]
        parts.append(F.pad(img_l, (0, seg_w - lw, 0, h - lh)))
    return torch.cat(parts, dim=2)


@functools.lru_cache()
def _canvas_masks_np(h: int, w: int, cfg: OrbConfig):
    """Static in-bounds mask (H,Wc) (border max(edge, EXTRACT_R+1), so every
    extraction patch lies inside its level) + grid sizes."""
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    e = max(cfg.edge, EXTRACT_R + 1)
    m = np.zeros((h, Wc), bool)
    for l, (lh, lw) in enumerate(shapes):
        m[e:lh - e, offs[l] + e:offs[l] + lw - e] = True
    cs = cfg.cell_size
    return m, -(-h // cs), Wc // cs


@functools.lru_cache()
def _canvas_mask(h: int, w: int, cfg: OrbConfig, device: torch.device):
    return torch.from_numpy(_canvas_masks_np(h, w, cfg)[0]).to(device)


def fast_score_batched(stack: torch.Tensor, min_th: float) -> torch.Tensor:
    """Per-pixel FAST-9 score on (L,H,W): max over the 16 circular 9-arcs of
    the min |I(c)-I(p)| on a consistently brighter (or darker) arc; 0 below
    min_th. Rolls wrap like jnp.roll."""
    d = [torch.roll(stack, shifts=(-int(dy), -int(dx)), dims=(1, 2)) - stack
         for dy, dx in _FAST_CIRCLE]

    def arc_scores(d16):
        m = d16
        for span in (1, 2, 4):
            m = [torch.minimum(m[i], m[(i + span) % 16]) for i in range(16)]
        m9 = [torch.minimum(m[i], d16[(i + 8) % 16]) for i in range(16)]
        best = m9[0]
        for i in range(1, 16):
            best = torch.maximum(best, m9[i])
        return best

    score = torch.maximum(arc_scores(d), arc_scores([-x for x in d]))
    return torch.where(score >= min_th, score, torch.zeros_like(score))


_FY, _FX = 4, 8     # fine sub-block (rows x cols) of the two-stage cell top-k


def detect_canvas(canvas: torch.Tensor, w: int, cfg: OrbConfig):
    """All-level detection on packed canvases (B,H,Wc). Returns per-image
    (B,N) tensors: level, y, x_canvas, score, valid.

    The reference's default two-stage cell top-k (orb.py:523-562): the
    best (score, position)-packed corner of every 4x8 sub-block, then an
    exact top-k over each cell's sub-block maxima; candidate order is
    level-major so each level's candidates form one contiguous slice."""
    B, h, Wc = canvas.shape
    cs = cfg.cell_size
    k = min(cfg.cell_top_k, cs * cs)
    if cs % _FY or cs % _FX or (cs // _FY) * (cs // _FX) < k:
        raise NotImplementedError(
            "only the sub-block detection path (cell_size a multiple of 8 "
            "with (cell/4)*(cell/8) >= cell_top_k) is ported")
    dev = canvas.device
    score = fast_score_batched(canvas, cfg.min_th)
    _, ghc, gwc = _canvas_masks_np(h, w, cfg)
    score = torch.where(_canvas_mask(h, w, cfg, dev)[None], score,
                        torch.zeros_like(score))
    mx = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    score = torch.where(score >= mx, score, torch.zeros_like(score))
    rank = torch.where(score >= cfg.ini_th, score + 1e4, score)

    nc = ghc * gwc
    rank = F.pad(rank, (0, 0, 0, ghc * cs - h))
    npos = cs * cs
    nf_y, nf_x = cs // _FY, cs // _FX
    H2 = rank.shape[1]
    yy = torch.arange(H2, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(Wc, device=dev, dtype=torch.int32)[None, :]
    lpos = (yy % cs) * cs + (xx % cs)
    # pack: round(score * 64) * npos + position within the cell
    # (scores < ~1.1e4 after the bonus -> 656k * 1024 < 2^31)
    packed = torch.round(rank * 64.0).to(torch.int32) * npos + lpos[None]
    fine = packed.view(B, H2 // _FY, _FY, Wc // _FX, _FX).amax(dim=(2, 4))
    fine = fine.view(B, ghc, nf_y, gwc, nf_x).permute(0, 3, 1, 2, 4)
    fine = fine.reshape(B, nc, nf_y * nf_x)            # level-major cells
    bm, _ = top_k(fine, k)
    bm = torch.clamp(bm.reshape(B, nc * k), min=0)
    ti = bm % npos
    top_v = (bm // npos).to(torch.float32) * (1.0 / 64.0)
    cell = torch.arange(nc * k, device=dev, dtype=torch.int32)[None] // k
    cy = (cell % ghc) * cs + ti // cs
    cx = (cell // ghc) * cs + ti % cs

    offs, _, _ = canvas_layout(h, w, cfg)
    ys, xs, lv, sc, va = [], [], [], [], []
    for l, quota in enumerate(cfg.level_quotas()):
        gx0 = offs[l] // cs
        gx1 = (offs[l + 1] // cs) if l + 1 < cfg.n_levels else gwc
        sl = slice(gx0 * ghc * k, gx1 * ghc * k)
        n_l = (gx1 - gx0) * ghc * k
        # the reference's approx_max_k is exact on the CPU: exact top-k
        v, i = top_k(top_v[:, sl], min(quota, n_l))
        if quota > n_l:
            v = F.pad(v, (0, quota - n_l))
            i = F.pad(i, (0, quota - n_l))
        ys.append(torch.gather(cy[:, sl], 1, i))
        xs.append(torch.gather(cx[:, sl], 1, i))
        lv.append(torch.full((B, quota), l, dtype=torch.int32, device=dev))
        sc.append(torch.where(v >= 1e4, v - 1e4, v))
        va.append(v > 0.0)
    return (torch.cat(lv, 1), torch.cat(ys, 1), torch.cat(xs, 1),
            torch.cat(sc, 1), torch.cat(va, 1))


# ---------------------------------------------------------------------------
# Patch gather: the hand-written CUDA kernel and its plain version
# ---------------------------------------------------------------------------

# kernel launches made through extract_patches_canvas (read by chip_smoke.py)
patch_gather_launches = 0


def extract_patches_canvas_plain(canvas: torch.Tensor, bi: torch.Tensor,
                                 ys: torch.Tensor, xs: torch.Tensor
                                 ) -> torch.Tensor:
    """One (2R+1)^2 raw patch per keypoint from its image's canvas, as an
    index-arithmetic gather from the flattened canvas. Centres clip to
    [R, H-R-1] x [R, Wc-R-1], which is what the reference's dynamic_slice
    start clamp and its Pallas kernel's clip both do."""
    B, H, Wc = canvas.shape
    R = EXTRACT_R
    E = 2 * R + 1
    b = bi.long().clamp(0, B - 1)
    y = ys.long().clamp(R, H - R - 1)
    x = xs.long().clamp(R, Wc - R - 1)
    base = (b * H + (y - R)) * Wc + (x - R)
    ar = torch.arange(E, device=canvas.device)
    off = (ar[:, None] * Wc + ar[None, :]).reshape(-1)
    flat = canvas.reshape(-1)
    return flat[base[:, None] + off[None, :]].view(-1, E, E)


def extract_patches_canvas(canvas: torch.Tensor, bi: torch.Tensor,
                           ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(B,H,Wc) float32 canvas, (n,) int32 image index / row / column ->
    (n,45,45) float32 patches.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/patch_gather.cu) on the current stream or raises."""
    global patch_gather_launches
    if canvas.device.type == "cpu":
        return extract_patches_canvas_plain(canvas, bi, ys, xs)
    if canvas.device.type != "cuda":
        raise ValueError(f"no patch gather for device {canvas.device}")
    E = 2 * EXTRACT_R + 1
    if canvas.dtype != torch.float32 or canvas.dim() != 3 \
            or not canvas.is_contiguous():
        raise ValueError("canvas must be a contiguous (B,H,Wc) float32 "
                         f"tensor, got {canvas.dtype} {tuple(canvas.shape)}")
    B, H, Wc = canvas.shape
    if H < E or Wc < E:
        raise ValueError(f"canvas {H}x{Wc} is smaller than one {E}x{E} patch")
    if canvas.numel() >= 2 ** 31:
        raise ValueError("the kernel's offsets are 32-bit: canvas has "
                         f"{canvas.numel()} elements, 2^31 or more")
    n = bi.shape[0]
    for name, t in (("bi", bi), ("ys", ys), ("xs", xs)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() \
                or t.device != canvas.device:
            raise ValueError(f"{name} must be a contiguous ({n},) int32 "
                             f"tensor on {canvas.device}")
    out = torch.empty((n, E, E), dtype=torch.float32, device=canvas.device)
    lib = _patch_gather_lib()
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    rc = lib.msslam_patch_gather_f32(
        canvas.data_ptr(), bi.data_ptr(), ys.data_ptr(), xs.data_ptr(),
        out.data_ptr(), n, B, H, Wc, stream)
    if rc != 0:
        raise RuntimeError(f"patch_gather kernel launch failed: CUDA error {rc}")
    patch_gather_launches += 1
    return out


def _patch_gather_lib():
    lib = _native.load("patch_gather")
    fn = lib.msslam_patch_gather_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Orientation (intensity centroid) and steered BRIEF on the patches
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _moment_matrix_np():
    """(E*E, 2) circular-mask [y, x] moment weights (radius 15)."""
    E = 2 * EXTRACT_R + 1
    yy, xx = np.mgrid[-EXTRACT_R:EXTRACT_R + 1, -EXTRACT_R:EXTRACT_R + 1]
    mask = (yy ** 2 + xx ** 2) <= 15 ** 2
    return np.stack([(yy * mask), (xx * mask)], -1).reshape(E * E, 2) \
        .astype(np.float32)


@functools.lru_cache()
def _const(name: str, device: torch.device):
    """Host-built constants, uploaded once per device."""
    return torch.from_numpy(globals()[name]()).to(device)


def orientation_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle: (n,45,45) -> (n,) radians."""
    n = patches.shape[0]
    mom = patches.reshape(n, -1) @ _const("_moment_matrix_np", patches.device)
    return torch.atan2(mom[:, 0], mom[:, 1])


@functools.lru_cache()
def _blur_kernel():
    x = np.arange(-3, 4)
    k = np.exp(-x * x / (2 * 2.0 ** 2))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def blur_patches(patches: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian (sigma=2), valid region: (n,45,45) ->
    (n,39,39), summed in the reference's order."""
    kj = _blur_kernel()
    P = 2 * PATCH_R + 1
    ph = sum(kj[i] * patches[:, :, i:i + P] for i in range(7))
    return sum(kj[i] * ph[:, i:i + P, :] for i in range(7))


@functools.lru_cache()
def _binned_pair_index_np():
    """(Q, 2, 256) int64 flat blurred-patch indices [p1, p2] of every BRIEF
    pair rotated to angle bin q — the nonzeros of the reference's
    (Q, P*P, 256) ±1 pattern matrices (bit = I(p2) - I(p1) > 0)."""
    pat = _brief_pattern()
    P = 2 * PATCH_R + 1
    Q = N_ANGLE_BINS
    out = np.zeros((Q, 2, 256), np.int64)
    for q in range(Q):
        th = 2 * np.pi * q / Q
        ca, sa = np.cos(th), np.sin(th)
        for b in range(256):
            dy1, dx1, dy2, dx2 = pat[b]
            r1y = int(round(dx1 * sa + dy1 * ca))
            r1x = int(round(dx1 * ca - dy1 * sa))
            r2y = int(round(dx2 * sa + dy2 * ca))
            r2x = int(round(dx2 * ca - dy2 * sa))
            out[q, 0, b] = (r1y + PATCH_R) * P + (r1x + PATCH_R)
            out[q, 1, b] = (r2y + PATCH_R) * P + (r2x + PATCH_R)
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) bool -> (N,8) int32 (uint32 bits, little-endian in words)."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, 8, 32).long() << shifts).sum(-1)
    return to_int32_bits(words)


def descriptors_from_patches(patches: torch.Tensor,
                             angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256. The reference evaluates all 30 angle bins as a
    bf16 einsum and keeps one; each bit there is exactly
    bf16(b[p2]) - bf16(b[p1]) > 0 (two ±1 terms, f32 accumulation). Here
    the blurred patch is rounded to bf16 and only the keypoint's bin is
    evaluated, as 256 pair differences: the same bits."""
    n = patches.shape[0]
    Q = N_ANGLE_BINS
    blurred = blur_patches(patches).reshape(n, -1)
    blurred = blurred.to(torch.bfloat16).to(torch.float32)
    q = torch.round(angle * (Q / (2 * np.pi))).to(torch.int64) % Q
    pairs = _const("_binned_pair_index_np", patches.device)[q]  # (n,2,256)
    v1 = torch.gather(blurred, 1, pairs[:, 0])
    v2 = torch.gather(blurred, 1, pairs[:, 1])
    return pack_bits((v2 - v1) > 0)


def extract_canvas_multi(imgs: torch.Tensor, cfg: OrbConfig):
    """Canvas-packed extraction for B images (B,H,W) float32. Returns
    (Features batched (B,...), canvases (B,H,Wc))."""
    B, h, w = imgs.shape
    offs, _, _ = canvas_layout(h, w, cfg)
    canvas = build_canvas_multi(imgs, cfg).contiguous()
    lv, ys, xs, sc, va = detect_canvas(canvas, w, cfg)   # (B,N) each
    n = cfg.n_features
    bi = torch.arange(B, device=imgs.device, dtype=torch.int32)[:, None] \
        .expand(B, n).reshape(-1)
    patches = extract_patches_canvas(
        canvas, bi.contiguous(), ys.reshape(-1).to(torch.int32).contiguous(),
        xs.reshape(-1).to(torch.int32).contiguous())
    ang = orientation_from_patches(patches)
    desc = descriptors_from_patches(patches, ang)

    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32,
                          device=imgs.device)
    offs_t = torch.tensor(offs, dtype=torch.int64, device=imgs.device)
    x_lvl = (xs - offs_t[lv]).to(torch.float32)
    xy0 = torch.stack([x_lvl, ys.to(torch.float32)], dim=-1) \
        * scales[lv][..., None]
    feats = Features(xy=xy0, response=sc, angle=ang.reshape(B, n), octave=lv,
                     desc=desc.reshape(B, n, 8), valid=va)
    return feats, canvas


def extract(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """Full ORB extraction for one (H,W) float32 image in [0,255]."""
    feats, _ = extract_canvas_multi(img[None], cfg)
    return Features(*[a[0] for a in feats])
