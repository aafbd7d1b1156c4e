"""Indexed writes with the JAX package's `.at[...].set(..., mode="drop")` meaning.

Two differences from torch indexing matter here:

- JAX drops an update whose index is out of range; torch raises.  Callers
  pass an explicit `keep` mask instead of an out-of-range sentinel.
- With repeated indices, XLA on the CPU applies updates in order, so the
  last one wins; torch leaves the winner unspecified (on CUDA it varies from
  run to run).  `set_last_wins` drops every update that a later kept update
  overwrites, so the result is the same on every device and every run.
"""

from __future__ import annotations

import torch


def set_last_wins(
    dst: torch.Tensor,  # [B, S, ...] or [S, ...]: written along its slot axis
    index: torch.Tensor,  # [B, U] or [U] slot of each update
    values: torch.Tensor,  # [B, U, ...] or [U, ...]
    keep: torch.Tensor,  # [B, U] or [U] bool: False = drop the update
) -> torch.Tensor:
    """Return a copy of `dst` with `dst[b, index[b, u]] = values[b, u]` for
    every kept update, the last of repeated indices winning."""
    batched = index.dim() == 2
    if not batched:
        dst, index, values, keep = dst[None], index[None], values[None], keep[None]
    B, S = dst.shape[0], dst.shape[1]
    U = index.shape[1]
    idx = torch.where(keep, index, torch.full_like(index, -1))
    later = torch.triu(torch.ones(U, U, dtype=torch.bool, device=dst.device), diagonal=1)
    overwritten = torch.any(
        (idx[:, :, None] == idx[:, None, :]) & keep[:, None, :] & later[None], dim=-1
    )
    final = keep & ~overwritten
    # dropped updates land in one spare slot at index S, which is cut off
    slot = torch.where(final, index, torch.full_like(index, S)).long()
    flat = torch.cat([dst, dst[:, :1]], dim=1).clone()
    b = torch.arange(B, device=dst.device)[:, None].expand(B, U)
    flat[b, slot] = values.to(dst.dtype)
    out = flat[:, :S]
    return out if batched else out[0]
