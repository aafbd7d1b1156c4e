"""The BA all-pairs matcher, plain PyTorch only: a frozen copy of the
port's kernels/matching.py plain version (no CUDA kernel), on any device.
Per pair and A-keypoint: the gated descriptor argmin `best_b`, its
distance (1e30 when no column passes) and whether the match is mutual."""

from __future__ import annotations

import functools
import math

import torch

from trackbench.reference import precision

BIG = 1e30


@functools.lru_cache(maxsize=None)
def _thresholds(max_dist: float, max_normal_deg: float):
    """Gate thresholds as f32 values, rounded from double as the JAX kernel's
    compile-time constants are."""
    max_dist_sq = float(torch.tensor(float(max_dist) ** 2, dtype=torch.float32))
    cos_thresh = float(
        torch.tensor(math.cos(math.radians(float(max_normal_deg))), dtype=torch.float32)
    )
    return max_dist_sq, cos_thresh


def gated_distances(
    desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist: float, max_normal_deg: float
):
    """The [P, N, N] gated descriptor distances the matcher minimizes (BIG
    where the geometric gate fails), as the plain version computes them."""
    max_dist_sq, cos_thresh = _thresholds(max_dist, max_normal_deg)
    # invalid keypoints leave gate range: A side to +1e4, B side to -1e4,
    # so invalid-vs-invalid pairs are 2e4 apart too
    wa = torch.where(valid_a[..., None], wa.float(), torch.full_like(wa, 1e4, dtype=torch.float32))
    wb = torch.where(valid_b[..., None], wb.float(), torch.full_like(wb, -1e4, dtype=torch.float32))
    desc_a, desc_b, na, nb = desc_a.float(), desc_b.float(), na.float(), nb.float()
    a = precision.bf16_operand(desc_a)
    b = precision.bf16_operand(desc_b)
    sim = a @ b.transpose(-1, -2)
    na2 = torch.sum(desc_a * desc_a, dim=-1)
    nb2 = torch.sum(desc_b * desc_b, dim=-1)
    dist = na2[:, :, None] + nb2[:, None, :] - 2.0 * sim
    # exact f32 (a-b)^2, summed in the kernel's order
    d2 = (wa[:, :, None, 0] - wb[:, None, :, 0]) ** 2
    d2 = d2 + (wa[:, :, None, 1] - wb[:, None, :, 1]) ** 2
    d2 = d2 + (wa[:, :, None, 2] - wb[:, None, :, 2]) ** 2
    cos = na[:, :, None, 0] * nb[:, None, :, 0]
    cos = cos + na[:, :, None, 1] * nb[:, None, :, 1]
    cos = cos + na[:, :, None, 2] * nb[:, None, :, 2]
    gate = (d2 < max_dist_sq) & (cos > cos_thresh)
    return torch.where(gate, dist, torch.full_like(dist, BIG))


def fused_mutual_match_reference(
    desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist: float, max_normal_deg: float
):
    """Plain PyTorch version of `fused_mutual_match`, on any device.

    Same arguments and results as the adapter.  Materializes the [P,N,N]
    matrices the kernel never stores.
    """
    gated = gated_distances(desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist, max_normal_deg)
    row_min = torch.amin(gated, dim=-1)
    best_b = torch.argmin(gated, dim=-1)  # first index among equal values
    col_min = torch.amin(gated, dim=-2)
    has = row_min < BIG
    mutual = has & (row_min <= torch.gather(col_min, -1, best_b))
    return best_b.to(torch.int32), row_min, mutual


def fused_mutual_match_pairs_reference(
    desc, world, wnrm, valid, pair_i, pair_j, max_dist: float, max_normal_deg: float
):
    """Plain PyTorch version of `fused_mutual_match_pairs`, on any device:
    the gather of both sides, then `fused_mutual_match_reference`."""
    pi, pj = pair_i.long(), pair_j.long()
    return fused_mutual_match_reference(
        desc[pi], desc[pj], world[pi], world[pj], wnrm[pi], wnrm[pj], valid[pi], valid[pj],
        max_dist, max_normal_deg,
    )


def fused_mutual_match_pairs(desc, world, wnrm, valid, pair_i, pair_j, max_dist: float,
                             max_normal_deg: float):
    """(best_b [P,N] int32, dist [P,N] f32, mutual [P,N] bool) of frame
    pair_i[p] against frame pair_j[p] of the [K, N, D] table, by the plain
    version on whatever device the table is."""
    return fused_mutual_match_pairs_reference(desc, world, wnrm, valid, pair_i, pair_j, max_dist,
                                              max_normal_deg)
