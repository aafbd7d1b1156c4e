"""Batched pairwise feature matching with geometric gating.

Counterpart of bundletrack_tpu/matching/pairwise.py (reference:
src/FeatureManager.cpp:173-444 findCorres / findCorresbyNN / pruneMatches /
collectMutualMatches).  The full distance matrix is gated (model-frame
distance + normal angle under the current poses) before mutual nearest
neighbours are taken; matches land in fixed [M] slots with a validity mask.

`match_pairs_batched`, the BA all-pairs matcher, always goes through the
fused matcher in kernels/matching.py, which reads the frame table in place
through the pair indices: the CUDA kernel for tensors on the card, its
plain PyTorch version for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.geometry.se3 import transform_normals, transform_points
from bundletrack_tpu_torch.kernels.matching import fused_mutual_match_pairs
from bundletrack_tpu_torch.ops.numerics import cos_deg_f32, square_f32
from bundletrack_tpu_torch.ops.scatter import set_last_wins
from bundletrack_tpu_torch.ops.topk import topk_stable


class MatchResult(NamedTuple):
    """Padded matches for one (or a batch of) frame pair(s).

    idx_a/idx_b: [..., M] int64 keypoint indices into each frame's arrays.
    valid:       [..., M] bool.
    """

    idx_a: torch.Tensor
    idx_b: torch.Tensor
    valid: torch.Tensor


def descriptor_distances(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., Na, Nb]: f32 norms minus 2x a dot product
    of bf16-rounded descriptors accumulated in f32 (every bf16 x bf16
    product is exact in f32)."""
    a = desc_a.to(torch.bfloat16).to(torch.float32)
    b = desc_b.to(torch.bfloat16).to(torch.float32)
    sim = a @ b.transpose(-1, -2)
    na = torch.sum(desc_a.float() ** 2, dim=-1)
    nb = torch.sum(desc_b.float() ** 2, dim=-1)
    return na[..., :, None] + nb[..., None, :] - 2.0 * sim


def geometric_gate(
    pts_a, normals_a, pose_a, pts_b, normals_b, pose_b, max_dist: float, max_normal_deg: float
) -> torch.Tensor:
    """[..., Na, Nb] bool gate: model-frame distance + normal angle
    (reference pruneMatches, FeatureManager.cpp:290-336).  Distances use the
    |a|^2 + |b|^2 - 2 a.b identity in f32, as the JAX package's XLA path does."""
    wa = transform_points(pose_a, pts_a)
    wb = transform_points(pose_b, pts_b)
    na = transform_normals(pose_a, normals_a)
    nb = transform_normals(pose_b, normals_b)
    dot = wa @ wb.transpose(-1, -2)
    d2 = (
        torch.sum(wa * wa, dim=-1)[..., :, None]
        + torch.sum(wb * wb, dim=-1)[..., None, :]
        - 2.0 * dot
    )
    cos = na @ nb.transpose(-1, -2)
    return (d2 < square_f32(max_dist)) & (cos > cos_deg_f32(max_normal_deg))


def mutual_nearest(dist: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """[..., Na, Nb] bool: mutual nearest neighbours of the gated distances."""
    gated = torch.where(gate, dist, torch.full_like(dist, float("inf")))
    best_b = torch.argmin(gated, dim=-1)
    best_a = torch.argmin(gated, dim=-2)
    Na, Nb = dist.shape[-2], dist.shape[-1]
    cols = torch.arange(Nb, device=dist.device)
    rows = torch.arange(Na, device=dist.device)
    is_best_b = best_b[..., :, None] == cols
    is_best_a = best_a[..., None, :] == rows[:, None]
    return gate & is_best_b & is_best_a


def _select_top_matches(mutual, dist, valid_a, valid_b, max_matches: int) -> MatchResult:
    """Compress the [Na, Nb] mutual-match matrix into M top slots."""
    score_ok = mutual & valid_a[..., :, None] & valid_b[..., None, :]
    neg_dist = torch.where(score_ok, -dist, torch.full_like(dist, float("-inf")))
    row_score = torch.amax(neg_dist, dim=-1)
    row_b = torch.argmax(neg_dist, dim=-1)
    topv, topi = topk_stable(row_score, max_matches)
    valid = torch.isfinite(topv)
    zero = torch.zeros_like(topi)
    idx_a = torch.where(valid, topi, zero)
    idx_b = torch.where(valid, torch.gather(row_b, -1, topi), zero)
    return MatchResult(idx_a=idx_a, idx_b=idx_b, valid=valid)


def match_pair(
    desc_a, pts_a, normals_a, valid_a, pose_a,
    desc_b, pts_b, normals_b, valid_b, pose_b,
    max_dist, max_normal_deg, max_matches: int,
) -> MatchResult:
    """Full matching pipeline for one frame pair (leading batch axes broadcast)."""
    dist = descriptor_distances(desc_a, desc_b)
    gate = geometric_gate(
        pts_a, normals_a, pose_a, pts_b, normals_b, pose_b, max_dist, max_normal_deg
    )
    # padding slots leave the gate before mutual-NN, so an invalid keypoint
    # cannot take a valid keypoint's winner slot
    gate = gate & valid_a[..., :, None] & valid_b[..., None, :]
    mut = mutual_nearest(dist, gate)
    return _select_top_matches(mut, dist, valid_a, valid_b, max_matches)


def merge_matches(
    fresh: MatchResult, extra: MatchResult, num_kpts: int, max_matches: int
) -> MatchResult:
    """Union of two match sets with per-keypoint dedup (fresh wins).

    Each keypoint of frame A keeps at most one partner.  Every kept row
    scores 1.0, so the order of the output is decided by ties alone: the
    stable top-k keeps rows in index order, as `lax.top_k` does.  Match
    sets [..., M] may carry any leading axes (streams, pairs).
    """
    lead = fresh.idx_a.shape[:-1]
    fresh = MatchResult(*(t.reshape(-1, t.shape[-1]) for t in fresh))
    extra = MatchResult(*(t.reshape(-1, t.shape[-1]) for t in extra))
    B = fresh.idx_a.shape[0]
    row = torch.full((B, num_kpts), -1, dtype=torch.int64, device=fresh.idx_a.device)
    # extras first, fresh overwrites (priority): one write, fresh last
    idx = torch.cat([extra.idx_a, fresh.idx_a], dim=1)
    val = torch.cat([extra.idx_b, fresh.idx_b], dim=1)
    keep = torch.cat([extra.valid, fresh.valid], dim=1)
    row = set_last_wins(row, idx, val, keep)
    has = row >= 0
    score = torch.where(has, 1.0, float("-inf"))
    topv, topi = topk_stable(score, max_matches)
    valid = torch.isfinite(topv)
    zero = torch.zeros_like(topi)
    out = MatchResult(
        idx_a=torch.where(valid, topi, zero),
        idx_b=torch.where(valid, torch.gather(row, 1, topi), zero),
        valid=valid,
    )
    return MatchResult(*(t.reshape(*lead, max_matches) for t in out))


def _select_top_rows(best_b, dist, mutual, max_matches: int) -> MatchResult:
    """Convert per-row winners (fused matcher output) into M padded slots."""
    score = torch.where(mutual, -dist, torch.full_like(dist, float("-inf")))
    topv, topi = topk_stable(score, max_matches)
    valid = torch.isfinite(topv)
    zero = torch.zeros_like(topi)
    idx_a = torch.where(valid, topi, zero)
    idx_b = torch.where(valid, torch.gather(best_b.long(), -1, topi), zero)
    return MatchResult(idx_a=idx_a, idx_b=idx_b, valid=valid)


def match_pairs_batched(
    desc,  # [..., K, N, D] descriptor table (BA subset; leading axes: streams)
    pts,  # [..., K, N, 3]
    normals,  # [..., K, N, 3]
    kp_valid,  # [..., K, N]
    poses,  # [..., K, 4, 4]
    pair_i,  # [P] int32 (any integer type): frames of the table flattened over its leading axes
    pair_j,  # [P]
    pair_valid,  # [P] bool
    max_dist: float,
    max_normal_deg: float,
    max_matches: int,
) -> MatchResult:
    """All-pairs matching over a frame table — the BA edge builder
    (reference Bundler::optimizeGPU per-pair loop, src/Bundler.cpp:298-324).
    The fused matcher reads the table in place through the pair indices and
    matches every (i, j) pair in one launch; no [P, N, D] copy of either
    side is made.  A fleet's tables [S, K, N, D] are one [S*K, N, D] table
    to the kernel, and stream s's pairs index it at s*K + i, so all S*P
    pairs take one launch.  Returns [P, M] matches."""
    N, D = desc.shape[-2:]
    world = transform_points(poses, pts).reshape(-1, N, 3)  # [S*K, N, 3]
    wnrm = transform_normals(poses, normals).reshape(-1, N, 3)
    best_b, dist, mutual = fused_mutual_match_pairs(
        desc.reshape(-1, N, D), world, wnrm, kp_valid.reshape(-1, N), pair_i, pair_j,
        max_dist=max_dist,
        max_normal_deg=max_normal_deg,
    )
    res = _select_top_rows(best_b, dist, mutual, max_matches)
    return MatchResult(res.idx_a, res.idx_b, res.valid & pair_valid[:, None])

