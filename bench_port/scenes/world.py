"""The corridor world, rendered on the device.

A frozen PyTorch copy of `ms_slam_tpu_torch/utils/synth.py`'s
`CorridorWorld` (side walls at x = +-half_w, floor at y = y_floor, ceiling
at y = y_ceil; x right, y down, z forward) and of its `mondrian_texture`,
so that a run makes its frames on the card from the seed instead of ray
casting them in numpy on the host. The ray-plane arithmetic and the
bilinear texture sample are the source's, in float64; the texture's
rectangles are drawn by a `torch.Generator` instead of numpy's, so a seed
gives another texture than the source's, of the same statistics.

One addition of the harness's own: with `wrap_shift` set, the texture's
rows move by that many at each wrap of its columns along the corridor (z),
so that a route longer than one texture period does not meet the same
walls again (`inputs.distinct_length` says how far it may go). Without it
the texture wraps as the source's does.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def mondrian_texture(gen: torch.Generator, size: int, n_rects: int,
                     device, rect_max: int | None = None) -> torch.Tensor:
    """(size, size) float32 grey texture: n_rects flat rectangles of side
    8 .. rect_max (the source's size // 6 by default) and level 15 .. 240
    painted over 128, the later on top. The rectangles' parameters come
    from one draw of `gen`."""
    rect_max = rect_max or size // 6
    u = torch.rand((n_rects, 5), generator=gen, device=device, dtype=F64)
    y0 = (u[:, 0] * (size - 8)).long()
    x0 = (u[:, 1] * (size - 8)).long()
    h = 8 + (u[:, 2] * (rect_max - 8)).long()
    w = 8 + (u[:, 3] * (rect_max - 8)).long()
    val = 15.0 + 225.0 * u[:, 4]
    rects = torch.stack([y0, x0, h, w], 1).tolist()
    vals = val.tolist()
    tex = torch.full((size, size), 128.0, dtype=torch.float32, device=device)
    for (a, b, hh, ww), v in zip(rects, vals):
        tex[a:a + hh, b:b + ww] = v
    return tex


class CorridorWorld:
    """Four textured planes along +z. `textures` (4, S, S) float32 on the
    device: the walls at +half_w and -half_w, the floor, the ceiling."""

    def __init__(self, textures: torch.Tensor, half_w: float = 3.0,
                 y_floor: float = 1.6, y_ceil: float = -2.2,
                 tex_scale: float = 0.05, wrap_shift: int = 0):
        self.tex = textures
        self.wrap_shift = int(wrap_shift)
        self.half_w = float(half_w)
        self.y_floor = float(y_floor)
        self.y_ceil = float(y_ceil)
        self.tex_scale = float(tex_scale)

    @classmethod
    def from_seed(cls, seed: int, device, half_w=3.0, y_floor=1.6,
                  y_ceil=-2.2, tex_scale=0.05, tex_size=4096, rect_max=None,
                  n_rects=None, wrap_shift=0):
        """Textures from the seed; by default the source's rectangle count
        400 * (tex_size // 768) ** 2 and side tex_size // 6."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        n_rects = n_rects or 400 * (tex_size // 768) ** 2
        tex = torch.stack([mondrian_texture(gen, tex_size, n_rects, device,
                                            rect_max) for _ in range(4)])
        return cls(tex, half_w, y_floor, y_ceil, tex_scale, wrap_shift)

    def planes(self):
        """(axis, value, texture index, (texture axes)), the source's order."""
        return [(0, self.half_w, 0, (1, 2)), (0, -self.half_w, 1, (1, 2)),
                (1, self.y_floor, 2, (0, 2)), (1, self.y_ceil, 3, (0, 2))]

    def _sample(self, k: int, a: torch.Tensor, b: torch.Tensor):
        tex = self.tex[k]
        size = tex.shape[0]
        if self.wrap_shift:
            # b runs along the corridor on every plane
            wraps = torch.floor(b / self.tex_scale / size)
            ia = torch.remainder(a / self.tex_scale + wraps * self.wrap_shift,
                                 size)
        else:
            ia = torch.remainder(a / self.tex_scale, size)
        ib = torch.remainder(b / self.tex_scale, size)
        i0 = torch.remainder(torch.floor(ia).long(), size)
        j0 = torch.remainder(torch.floor(ib).long(), size)
        i1 = torch.remainder(i0 + 1, size)
        j1 = torch.remainder(j0 + 1, size)
        fa = ia - torch.floor(ia)
        fb = ib - torch.floor(ib)
        return (tex[i0, j0].to(F64) * (1 - fa) * (1 - fb)
                + tex[i1, j0].to(F64) * fa * (1 - fb)
                + tex[i0, j1].to(F64) * (1 - fa) * fb
                + tex[i1, j1].to(F64) * fa * fb)

    def cast(self, T_wc: torch.Tensor, rays_c: torch.Tensor):
        """Nearest hit of the rays (h, w, 3) from the poses T_wc (B, 4, 4):
        (grey (B, h, w) float64, ray parameter t (B, h, w), world points
        (B, h, w, 3)); t is inf where no plane is hit."""
        R = T_wc[:, :3, :3]
        O = T_wc[:, :3, 3]
        d = torch.einsum("hwj,bij->bhwi", rays_c, R)
        B, h, w = d.shape[:3]
        img = torch.zeros((B, h, w), dtype=F64, device=d.device)
        depth = torch.full((B, h, w), float("inf"), dtype=F64, device=d.device)
        Xbest = torch.zeros((B, h, w, 3), dtype=F64, device=d.device)
        for ax, val, k, (a_ax, b_ax) in self.planes():
            da = d[..., ax]
            big = torch.abs(da) > 1e-9
            da_s = torch.where(big, da, torch.full_like(da, 1e-9))
            t = torch.where(big, (val - O[:, ax, None, None]) / da_s,
                            torch.full_like(da, -1.0))
            ok = (t > 0.1) & (t < depth)
            X = O[:, None, None, :] + t[..., None] * d
            v = self._sample(k, X[..., a_ax], X[..., b_ax])
            img = torch.where(ok, v, img)
            depth = torch.where(ok, t, depth)
            Xbest = torch.where(ok[..., None], X, Xbest)
        return img, depth, Xbest


def pinhole_rays(fx, fy, cx, cy, h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3) float64 camera rays with z = 1, as the source builds them."""
    vs, us = torch.meshgrid(torch.arange(h, dtype=F64, device=device),
                            torch.arange(w, dtype=F64, device=device),
                            indexing="ij")
    return torch.stack([(us - cx) / fx, (vs - cy) / fy, torch.ones_like(us)],
                       -1)


def render_stereo_u8(world: CorridorWorld, T_wc: torch.Tensor,
                     rays_c: torch.Tensor, baseline: float) -> torch.Tensor:
    """(B, 2, h, w) uint8 rectified pairs: the right camera sits baseline
    along the left camera's +x. Values are clipped to 0..255 and truncated,
    as `np.clip(im, 0, 255).astype(np.uint8)` does."""
    T_r = T_wc.clone()
    off = torch.tensor([baseline, 0.0, 0.0], dtype=F64, device=T_wc.device)
    T_r[:, :3, 3] = T_wc[:, :3, 3] + T_wc[:, :3, :3] @ off
    left = world.cast(T_wc, rays_c)[0]
    right = world.cast(T_r, rays_c)[0]
    out = torch.stack([left, right], 1).to(torch.float32)
    return out.clamp(0, 255).to(torch.uint8)


def render_sequence(world: CorridorWorld, poses: np.ndarray, rays_c,
                    baseline: float, batch: int = 16) -> list:
    """Every pose's pair rendered on the device and copied to host uint8
    arrays (cameras deliver host frames): a list of (left, right)."""
    dev = rays_c.device
    frames = []
    for s in range(0, len(poses), batch):
        T = torch.as_tensor(poses[s:s + batch], dtype=F64, device=dev)
        pairs = render_stereo_u8(world, T, rays_c, baseline).cpu().numpy()
        frames.extend((p[0], p[1]) for p in pairs)
    return frames
