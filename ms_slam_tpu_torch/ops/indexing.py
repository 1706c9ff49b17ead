"""Index helpers that pin down the reference's tie and scatter semantics.

Two parity hazards live here, so every site on the slice shares one rule:

- **Top-k ties.** `jax.lax.top_k` (and `approx_max_k`, which is exact on the
  CPU) returns the LOWEST index first among equal values; `torch.topk` does
  not promise that. `top_k` is a stable descending sort, then a slice.
- **Scatter with drop.** `.at[idx].set(v, mode="drop")` wraps negative
  indices once, drops indices still out of range, and on the CPU keeps the
  LAST write of a duplicate index. Torch's `index_put_` raises on an
  out-of-range index and leaves the duplicate winner undefined on CUDA.
  `set_at_` resolves the last write first and makes every write to one
  target carry the winner's value, so the launch order cannot matter and
  no host sync is needed.

The `*_at_` functions update `x` in place and return it.
"""
from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; ties break
    to the lowest index, as `jax.lax.top_k` does."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _flat(x: torch.Tensor, idx):
    """Linear index into x's leading len(idx) axes + in-range mask."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = torch.broadcast_tensors(*[torch.as_tensor(i, device=x.device)
                                    for i in idx])
    lin = torch.zeros(idx[0].shape, dtype=torch.int64, device=x.device)
    ok = torch.ones(idx[0].shape, dtype=torch.bool, device=x.device)
    for d, i in enumerate(idx):
        n = x.shape[d]
        i = i.long()
        i = torch.where(i < 0, i + n, i)         # JAX wraps negatives once
        ok &= (i >= 0) & (i < n)
        lin = lin * n + i.clamp(0, n - 1)
    lead = 1
    for d in range(len(idx)):
        lead *= x.shape[d]
    return lin.reshape(-1), ok.reshape(-1), len(idx), lead, idx[0].shape


def _vals(x, v, ishape, nd):
    """v broadcast to idx.shape + x.shape[nd:], flattened to (n, *tail)."""
    tail = tuple(x.shape[nd:])
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return torch.broadcast_to(v, tuple(ishape) + tail).reshape(-1, *tail)


def set_at_(x: torch.Tensor, idx, v) -> torch.Tensor:
    """In-place `x.at[idx].set(v, mode="drop")` with last-write-wins."""
    lin, ok, nd, lead, ishape = _flat(x, idx)
    n = lin.numel()
    if n == 0:
        return x
    vals = _vals(x, v, ishape, nd)
    flat = x.view(lead, *x.shape[nd:])
    pos = torch.arange(n, device=x.device)
    tgt = torch.where(ok, lin, torch.full_like(lin, lead))
    last = torch.full((lead + 1,), -1, dtype=torch.int64, device=x.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    # dropped writes are sent to row 0 carrying whatever row 0 ends up as
    src = torch.where(ok, last[lin], last[0].expand(n))
    keep_old = (src < 0).reshape(-1, *([1] * (flat.dim() - 1)))
    new = torch.where(keep_old, flat[0:1].clone().expand_as(vals),
                      vals[src.clamp(min=0)])
    dst = torch.where(ok, lin, torch.zeros_like(lin))
    flat.index_put_((dst,), new)
    return x


def add_at_(x: torch.Tensor, idx, v) -> torch.Tensor:
    """In-place `x.at[idx].add(v, mode="drop")`."""
    lin, ok, nd, lead, ishape = _flat(x, idx)
    n = lin.numel()
    if n == 0:
        return x
    vals = _vals(x, v, ishape, nd)
    okb = ok.reshape(-1, *([1] * (vals.dim() - 1)))
    vals = torch.where(okb, vals, torch.zeros_like(vals))
    flat = x.view(lead, *x.shape[nd:])
    flat.index_add_(0, torch.where(ok, lin, torch.zeros_like(lin)), vals)
    return x


def _reduce_at_(x, idx, v, how):
    lin, ok, nd, lead, ishape = _flat(x, idx)
    n = lin.numel()
    if n == 0:
        return x
    vals = _vals(x, v, ishape, nd)
    flat = x.view(lead, -1)
    vals = vals.reshape(n, -1)
    okb = ok[:, None]
    vals = torch.where(okb, vals, flat[0:1].expand_as(vals))
    dst = torch.where(ok, lin, torch.zeros_like(lin))
    flat.scatter_reduce_(0, dst[:, None].expand_as(vals), vals, reduce=how)
    return x


def max_at_(x: torch.Tensor, idx, v) -> torch.Tensor:
    """In-place `x.at[idx].max(v, mode="drop")` (numeric dtypes)."""
    return _reduce_at_(x, idx, v, "amax")


def min_at_(x: torch.Tensor, idx, v) -> torch.Tensor:
    """In-place `x.at[idx].min(v, mode="drop")` (numeric dtypes)."""
    return _reduce_at_(x, idx, v, "amin")


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit pattern -> int32 with the same bits
    (descriptor words are int32 tensors carrying the reference's uint32)."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
