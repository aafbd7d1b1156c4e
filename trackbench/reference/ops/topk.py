"""Top-k with the tie order of `jax.lax.top_k`.

`lax.top_k` puts the lower index first among equal values; `torch.topk`
promises no order.  Several stages rank values that tie by construction
(merge_matches scores every match 1.0), so the port ranks with a stable
descending sort and keeps the first k.
"""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    lower index first among ties."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
