"""The plain stereo frontend: ORB on canvas-packed pyramids and rectified
stereo matching, in plain PyTorch float32.

A frozen copy of the port's canvas path as it stood when the benchmark was
written (`ms_slam_tpu_torch/ops/orb.py`: `extract_canvas_multi` with the
plain patch gather; `ops/stereo.py`: `match_stereo_canvas`; `ops/hamming.py`
and `ops/indexing.py`'s `top_k`), with no kernel and no switch: the canvas
is float32, the patches are an index gather, TF32 is off. It imports
nothing of the port, so a later change to the port's frontend is held
against this copy. `stereo_frontend` returns, per slot of the left image,
what a keyframe stores of it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_FAST_CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32)
PATCH_R = 19
EXTRACT_R = PATCH_R + 3
N_ANGLE_BINS = 30
_FY, _FX = 4, 8
DESC_GATE = 75
SAD_W = 5
SAD_SEARCH = 5


class Orb(NamedTuple):
    """Extraction parameters (the settings reader's, n_features rounded up
    to a multiple of 128)."""

    n_features: int
    n_levels: int
    scale_factor: float
    ini_th: float
    min_th: float
    cell_size: int = 32
    cell_top_k: int = 8
    edge: int = 19

    def level_scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def level_quotas(self):
        inv = 1.0 / self.scale_factor
        base = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        q = [int(round(base * inv ** l)) for l in range(self.n_levels)]
        q[0] += self.n_features - sum(q)
        return q


def _top_k(x: torch.Tensor, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


@functools.lru_cache()
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 0x0B12EF):
    rs = np.random.RandomState(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 2
    pts = np.clip(np.round(rs.normal(0.0, sigma, size=(n_bits, 4))), -lim, lim)
    return pts.astype(np.int32)


def pyramid_shapes(h: int, w: int, cfg: Orb):
    return [(int(round(h / s)), int(round(w / s))) for s in cfg.level_scales()]


@functools.lru_cache()
def canvas_layout(h: int, w: int, cfg: Orb):
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
    """Antialiased bilinear resize weights (in, out), built in float64."""
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


def _resize(imgs: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    h, w = imgs.shape[-2:]
    wh = torch.from_numpy(_resize_weights_np(h, lh)).to(imgs.device)
    ww = torch.from_numpy(_resize_weights_np(w, lw)).to(imgs.device)
    return wh.T @ imgs @ ww


def build_canvas(imgs: torch.Tensor, cfg: Orb) -> torch.Tensor:
    B, h, w = imgs.shape
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    parts = []
    for l, (lh, lw) in enumerate(shapes):
        img_l = imgs if l == 0 else _resize(imgs, lh, lw)
        seg_w = (offs[l + 1] if l + 1 < len(offs) else Wc) - offs[l]
        parts.append(F.pad(img_l, (0, seg_w - lw, 0, h - lh)))
    return torch.cat(parts, dim=2)


@functools.lru_cache()
def _canvas_masks_np(h: int, w: int, cfg: Orb):
    offs, Wc, shapes = canvas_layout(h, w, cfg)
    e = max(cfg.edge, EXTRACT_R + 1)
    m = np.zeros((h, Wc), bool)
    for l, (lh, lw) in enumerate(shapes):
        m[e:lh - e, offs[l] + e:offs[l] + lw - e] = True
    cs = cfg.cell_size
    return m, -(-h // cs), Wc // cs


def fast_score(stack: torch.Tensor, min_th: float) -> torch.Tensor:
    """FAST-9 score per pixel of (B, H, W); rolls wrap."""
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


def _nms3(score: torch.Tensor) -> torch.Tensor:
    s = score.reshape(-1, 1, *score.shape[-2:])
    m = F.max_pool2d(s, 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= m, score, torch.zeros_like(score))


def _level_top(cand_v, cand_y, cand_x, quota: int):
    n_l = cand_v.shape[1]
    v, i = _top_k(cand_v, min(quota, n_l))
    if quota > n_l:
        v = F.pad(v, (0, quota - n_l))
        i = F.pad(i, (0, quota - n_l))
    return (torch.gather(cand_y, 1, i), torch.gather(cand_x, 1, i),
            torch.where(v >= 1e4, v - 1e4, v), v > 0.0)


def detect(canvas: torch.Tensor, w: int, cfg: Orb):
    """Per image (B, N): level, y, x on the canvas, score, valid. FAST and
    3x3 NMS, the 4x8 sub-block maxima, the per-cell top-k over them, the
    per-level quota."""
    B, h, Wc = canvas.shape
    cs = cfg.cell_size
    k = min(cfg.cell_top_k, cs * cs)
    dev = canvas.device
    score = fast_score(canvas, cfg.min_th)
    mask_np, ghc, gwc = _canvas_masks_np(h, w, cfg)
    score = torch.where(torch.from_numpy(mask_np).to(dev)[None], score,
                        torch.zeros_like(score))
    score = _nms3(score)
    rank = torch.where(score >= cfg.ini_th, score + 1e4, score)
    nc = ghc * gwc
    rank = F.pad(rank, (0, 0, 0, ghc * cs - h))
    npos = cs * cs
    cell = torch.arange(nc * k, device=dev, dtype=torch.int32)[None] // k
    nf_y, nf_x = cs // _FY, cs // _FX
    H2 = rank.shape[1]
    yy = torch.arange(H2, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(Wc, device=dev, dtype=torch.int32)[None, :]
    lpos = (yy % cs) * cs + (xx % cs)
    packed = torch.round(rank * 64.0).to(torch.int32) * npos + lpos[None]
    fine = packed.view(B, H2 // _FY, _FY, Wc // _FX, _FX).amax(dim=(2, 4))
    fine = fine.view(B, ghc, nf_y, gwc, nf_x).permute(0, 3, 1, 2, 4)
    fine = fine.reshape(B, nc, nf_y * nf_x)
    bm, _ = _top_k(fine, k)
    bm = torch.clamp(bm.reshape(B, nc * k), min=0)
    ti = bm % npos
    top_v = (bm // npos).to(torch.float32) * (1.0 / 64.0)
    cy = (cell % ghc) * cs + ti // cs
    cx = (cell // ghc) * cs + ti % cs
    offs, _, _ = canvas_layout(h, w, cfg)
    ys, xs, lv, sc, va = [], [], [], [], []
    for l, quota in enumerate(cfg.level_quotas()):
        gx0 = offs[l] // cs
        gx1 = (offs[l + 1] // cs) if l + 1 < cfg.n_levels else gwc
        sl = slice(gx0 * ghc * k, gx1 * ghc * k)
        y, x, v, ok = _level_top(top_v[:, sl], cy[:, sl], cx[:, sl], quota)
        ys.append(y)
        xs.append(x)
        lv.append(torch.full((B, quota), l, dtype=torch.int32, device=dev))
        sc.append(v)
        va.append(ok)
    return (torch.cat(lv, 1), torch.cat(ys, 1), torch.cat(xs, 1),
            torch.cat(sc, 1), torch.cat(va, 1))


def gather_patches(canvas, bi, ys, xs) -> torch.Tensor:
    """(n, 45, 45) raw patches, centres clipped into the canvas."""
    B, H, Wc = canvas.shape
    R = EXTRACT_R
    E = 2 * R + 1
    b = bi.long().clamp(0, B - 1)
    y = ys.long().clamp(R, H - R - 1)
    x = xs.long().clamp(R, Wc - R - 1)
    base = (b * H + (y - R)) * Wc + (x - R)
    ar = torch.arange(E, device=canvas.device)
    off = (ar[:, None] * Wc + ar[None, :]).reshape(-1)
    return canvas.reshape(-1)[base[:, None] + off[None, :]].view(-1, E, E)


def _moment_matrix(device):
    E = 2 * EXTRACT_R + 1
    yy, xx = np.mgrid[-EXTRACT_R:EXTRACT_R + 1, -EXTRACT_R:EXTRACT_R + 1]
    mask = (yy ** 2 + xx ** 2) <= 15 ** 2
    m = np.stack([(yy * mask), (xx * mask)], -1).reshape(E * E, 2)
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _blur_kernel():
    x = np.arange(-3, 4)
    k = np.exp(-x * x / (2 * 2.0 ** 2))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def _blur(patches: torch.Tensor) -> torch.Tensor:
    kj = _blur_kernel()
    P = 2 * PATCH_R + 1
    ph = sum(kj[i] * patches[:, :, i:i + P] for i in range(7))
    return sum(kj[i] * ph[:, i:i + P, :] for i in range(7))


@functools.lru_cache()
def _pair_index_np():
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


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _to_int32_bits((bits.reshape(n, 8, 32).long() << shifts).sum(-1))


def descriptors(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 on the bf16-rounded blurred patch, at the
    keypoint's angle bin."""
    n = patches.shape[0]
    Q = N_ANGLE_BINS
    blurred = _blur(patches).reshape(n, -1)
    blurred = blurred.to(torch.bfloat16).to(torch.float32)
    q = torch.round(angle * (Q / (2 * np.pi))).to(torch.int64) % Q
    pairs = torch.from_numpy(_pair_index_np()).to(patches.device)[q]
    v1 = torch.gather(blurred, 1, pairs[:, 0])
    v2 = torch.gather(blurred, 1, pairs[:, 1])
    return _pack_bits((v2 - v1) > 0)


def extract(imgs: torch.Tensor, cfg: Orb):
    """(B, H, W) float32 -> dict of (B, N) features and the canvases."""
    B, h, w = imgs.shape
    offs, _, _ = canvas_layout(h, w, cfg)
    canvas = build_canvas(imgs, cfg).contiguous()
    lv, ys, xs, sc, va = detect(canvas, w, cfg)
    n = cfg.n_features
    bi = torch.arange(B, device=imgs.device, dtype=torch.int32)[:, None] \
        .expand(B, n).reshape(-1)
    patches = gather_patches(canvas, bi, ys.reshape(-1).to(torch.int32),
                             xs.reshape(-1).to(torch.int32))
    mom = patches.reshape(patches.shape[0], -1) @ _moment_matrix(imgs.device)
    ang = torch.atan2(mom[:, 0], mom[:, 1])
    desc = descriptors(patches, ang)
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32,
                          device=imgs.device)
    offs_t = torch.tensor(offs, dtype=torch.int64, device=imgs.device)
    x_lvl = (xs - offs_t[lv]).to(torch.float32)
    xy0 = torch.stack([x_lvl, ys.to(torch.float32)], dim=-1) \
        * scales[lv][..., None]
    feats = {"xy": xy0, "angle": ang.reshape(B, n), "octave": lv,
             "desc": desc.reshape(B, n, 8), "valid": va}
    return feats, canvas


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances of (N, 8) and (M, 8) int32 words, as a
    +-1 float32 product (exact with TF32 off)."""
    sh = torch.arange(32, dtype=torch.int32, device=a.device)

    def pm1(p):
        bits = (p[:, :, None] >> sh) & 1
        return (2 * bits.reshape(p.shape[0], 256) - 1).to(torch.float32)

    return ((256 - pm1(a) @ pm1(b).T) * 0.5).to(torch.int32)


def _median_nan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    s = torch.sort(x).values
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, float("nan")),
                       mid)


def _clip(v, a, b):
    return torch.minimum(torch.maximum(v, torch.as_tensor(a, device=v.device)),
                         torch.as_tensor(b, device=v.device))


def match_stereo(fl: dict, fr: dict, canvas_l, canvas_r, w: int, bf: float,
                 min_z: float, cfg: Orb):
    """Row-band descriptor match, 11-tap SAD sweep of +-5 px with a parabola
    fit on the keypoint's level of the canvases, 1.5 * 1.48 * median gate:
    (u_right, depth), -1 where unmatched."""
    dev = canvas_l.device
    h, Wc = canvas_l.shape
    offs, _, shapes = canvas_layout(h, w, cfg)
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32, device=dev)
    lo = fl["octave"].long()
    dist = _hamming(fl["desc"], fr["desc"])
    band = 2.0 * scales[lo][:, None]
    row_ok = torch.abs(fl["xy"][:, 1][:, None] - fr["xy"][:, 1][None, :]) \
        <= band
    oct_ok = torch.abs(fl["octave"][:, None] - fr["octave"][None, :]) <= 1
    disp = fl["xy"][:, 0][:, None] - fr["xy"][:, 0][None, :]
    max_disp = bf / min_z
    ok = row_ok & oct_ok & (disp > 0.1) & (disp < max_disp) \
        & fl["valid"][:, None] & fr["valid"][None, :]
    dist = torch.where(ok, dist, torch.full_like(dist, 10_000))
    best = torch.argmin(dist, dim=1)
    matched = torch.gather(dist, 1, best[:, None])[:, 0] <= DESC_GATE

    inv_s = 1.0 / scales[lo]
    ul = fl["xy"][:, 0] * inv_s
    vl = fl["xy"][:, 1] * inv_s
    ur0 = fr["xy"][best, 0] * inv_s
    lh = torch.tensor([s[0] for s in shapes], device=dev)[lo]
    lw = torch.tensor([s[1] for s in shapes], device=dev)[lo]
    off = torch.tensor(offs, device=dev)[lo]
    yi = _clip(torch.round(vl).long(), SAD_W, lh - SAD_W - 1)
    xi = _clip(torch.round(ul).long(), SAD_W + SAD_SEARCH,
               lw - SAD_W - SAD_SEARCH - 1)
    xri = _clip(torch.round(ur0).long(), SAD_W + SAD_SEARCH,
                lw - SAD_W - SAD_SEARCH - 1)
    base = yi * Wc + off
    o1 = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    ow = torch.arange(-(SAD_W + SAD_SEARCH), SAD_W + SAD_SEARCH + 1,
                      device=dev)
    lp = canvas_l.reshape(-1)[(base + xi)[:, None] + o1[None, :]].float()
    rwin = canvas_r.reshape(-1)[(base + xri)[:, None] + ow[None, :]].float()

    lp = lp - torch.mean(lp, dim=1, keepdim=True)
    sweeps = []
    for s in range(2 * SAD_SEARCH + 1):
        rp = rwin[:, s:s + 2 * SAD_W + 1]
        rp = rp - torch.mean(rp, dim=1, keepdim=True)
        sweeps.append(torch.sum(torch.abs(lp - rp), dim=1))
    sad = torch.stack(sweeps, dim=1)
    k = torch.argmin(sad, dim=1)
    kc = torch.clamp(k, 1, 2 * SAD_SEARCH - 1)
    s_m1 = torch.gather(sad, 1, (kc - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, kc[:, None])[:, 0]
    s_p1 = torch.gather(sad, 1, (kc + 1)[:, None])[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (s_m1 - s_p1) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    off_px = (kc.to(torch.float32) - SAD_SEARCH + delta
              + xri.to(torch.float32) - ur0)

    ur = (ur0 + off_px) * scales[lo]
    disparity = fl["xy"][:, 0] - ur
    matched = matched & (disparity > 0.01) & (disparity < max_disp)
    med = _median_nan(torch.where(matched, s_0,
                                  torch.full_like(s_0, float("nan"))))
    med = torch.nan_to_num(med, nan=float("inf"))
    matched = matched & (s_0 <= 1.5 * 1.48 * med)
    depth = torch.where(matched, bf / torch.clamp(disparity, min=1e-6),
                        torch.full_like(disparity, -1.0))
    u_right = torch.where(matched, ur, torch.full_like(ur, -1.0))
    return u_right, depth


def stereo_frontend(img_l: np.ndarray, img_r: np.ndarray, orb: Orb,
                    bf: float, fx: float, device) -> dict:
    """One rectified uint8 pair -> numpy arrays of the left image's slots:
    xy (N, 2), octave, angle, desc (N, 8) int32, valid, u_right, depth."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            imgs = torch.from_numpy(np.stack([img_l, img_r])).to(device)
            feats, canvas = extract(imgs.to(torch.float32), orb)
            fl = {k: v[0] for k, v in feats.items()}
            fr = {k: v[1] for k, v in feats.items()}
            u_right, depth = match_stereo(fl, fr, canvas[0], canvas[1],
                                          imgs.shape[2], bf,
                                          max(bf / fx, 0.1), orb)
            out = {k: v.cpu().numpy() for k, v in fl.items()}
            out["u_right"] = u_right.cpu().numpy()
            out["depth"] = depth.cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return out
