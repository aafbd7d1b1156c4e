"""The Gauss-Newton pair blocks summed into H and g, plain PyTorch only: a
frozen copy of the port's kernels/normal_blocks.py plain version, on any
device, with no CUDA kernel.  Each entry adds its terms from +0.0 in the
order of the flat rows (`flat_rows`: kind, then pair), which is the order
the port's CPU `index_add_` and its kernel add in; on the card
`index_add_` adds with atomics in no fixed order, so here the terms of
each entry are laid out in that order and added one after another."""

from __future__ import annotations

import math

import torch


def flat_rows(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """The plain version's index_add_ operands: (the flat H row
    (b*K + row)*K + col of each block, the blocks [4BP, 36], the flat g row
    of each vector, the vectors [2BP, 6]), each in the order of the kinds."""
    B = math.prod(Hii.shape[:-3])
    blk = torch.cat([pair_i * (K + 1), pair_j * (K + 1), pair_i * K + pair_j, pair_j * K + pair_i])
    row = torch.cat([pair_i, pair_j])
    if B > 1:
        first = torch.arange(B, device=Hii.device)[:, None]
        blk = (first * (K * K) + blk).reshape(-1)
        row = (first * K + row).reshape(-1)
    vals = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)], dim=-3).reshape(-1, 36)
    return blk, vals, row, torch.cat([gi, gj], dim=-2).reshape(-1, 6)


def ordered_sum(index, vals, n: int):
    """out[r] = +0.0 + vals[i0] + vals[i1] + ... over the rows i0 < i1 < ...
    with index[i] == r, added one after another (index_add_'s result on the
    CPU), as [n, vals.shape[1]]."""
    order = torch.argsort(index, stable=True)
    target = index[order]
    counts = torch.bincount(index, minlength=n)
    rank = torch.arange(index.shape[0], device=index.device) - (torch.cumsum(counts, 0) - counts)[target]
    table = torch.zeros((n, max(int(counts.max()), 1), vals.shape[1]), dtype=vals.dtype, device=vals.device)
    table[target, rank] = vals[order]
    out = torch.zeros((n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for j in range(table.shape[1]):
        out = out + table[:, j]
    return out


def scatter_blocks_reference(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """Plain version of `scatter_blocks`: each output entry the sum of its
    flat rows' terms (`flat_rows`) in their order (`ordered_sum`)."""
    batch = Hii.shape[:-3]
    B = math.prod(batch)
    blk, vals, row, gvals = flat_rows(K, pair_i, pair_j, Hii, Hjj, Hij, gi, gj)
    H = ordered_sum(blk, vals, B * K * K)
    g = ordered_sum(row, gvals, B * K)
    return H.reshape(*batch, K, K, 6, 6), g.reshape(*batch, K, 6)


scatter_blocks = scatter_blocks_reference
