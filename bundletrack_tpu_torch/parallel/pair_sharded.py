"""Within-stream parallelism: the BA inner loop sharded by frame PAIR.

Counterpart of bundletrack_tpu/parallel/pair_sharded.py (reference analog:
one CUDA stream per pair, src/cuda/cuda_ransac.cu:1267-1284).  Each rank of
the mesh axis takes a contiguous block of the P pairs, in rank order, and
matches (the CUDA matcher on its block: `fused_mutual_match_pairs` reads
the replicated [K,N,D] table in place through the block's pair indices),
RANSACs and linearizes them; the [K,K,6,6] H and [K,6] g are summed over
the axis's process group once per GN iteration
(solver/gauss_newton.build_normal_equations `group`), and every rank runs
the same small solve, so all ranks return the same poses.

The frame table and dense tables are replicated; the pair enumeration is
sharded.  P must divide by the axis size (the K=16 graph has P=120).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bundletrack_tpu_torch.geometry.se3 import se3_compose, se3_inverse
from bundletrack_tpu_torch.matching.pairwise import MatchResult, match_pairs_batched
from bundletrack_tpu_torch.ops.collectives import group_rank, group_size
from bundletrack_tpu_torch.parallel.distributed import axis_group
from bundletrack_tpu_torch.ransac.ransac import draw_phases, ransac_multi_pair
from bundletrack_tpu_torch.solver.dense_p2p import CompactDense
from bundletrack_tpu_torch.solver.gauss_newton import GraphInputs, optimize_pose_graph
from bundletrack_tpu_torch.solver.residuals import SparseCorres


class BAFrameTable(NamedTuple):
    """Replicated per-frame state of the BA subset (K frames)."""

    desc: torch.Tensor  # [K, N, D]
    pts: torch.Tensor  # [K, N, 3]
    normals: torch.Tensor  # [K, N, 3]
    kp_valid: torch.Tensor  # [K, N]
    poses: torch.Tensor  # [K, 4, 4]
    frame_valid: torch.Tensor  # [K]
    free_mask: torch.Tensor  # [K]


def _gather_match_points(pts, normals, pair_i, pair_j, m: MatchResult):
    def take(table, frames, idx):
        return torch.gather(table[frames], 1, idx[..., None].expand(*idx.shape, 3))

    return (take(pts, pair_i, m.idx_a), take(pts, pair_j, m.idx_b),
            take(normals, pair_i, m.idx_a), take(normals, pair_j, m.idx_b))


def _ba_local(
    table: BAFrameTable,
    dense_compact: Optional[CompactDense],
    K_lowres,
    pair_i,
    pair_j,
    pair_valid,
    phases,  # [P_local, 3, n_rep]: this block's rows of the phases drawn for all P
    cfg,
    group=None,
):
    """Match -> RANSAC -> linearize the local pair block, solve globally.
    Returns (poses [K,4,4], final cost, high-residual fraction)."""
    fc, rc = cfg.feature_corres, cfg.ransac
    bm = match_pairs_batched(
        table.desc, table.pts, table.normals, table.kp_valid, table.poses,
        pair_i, pair_j, pair_valid,
        max_dist=fc.max_dist_no_neighbor,
        max_normal_deg=fc.max_normal_no_neighbor,
        max_matches=cfg.shapes.max_matches,
    )
    pi, pj = pair_i.long(), pair_j.long()
    mpa, mpb, mna, mnb = _gather_match_points(table.pts, table.normals, pi, pj, bm)
    prior = se3_compose(se3_inverse(table.poses[pj]), table.poses[pi])
    mr = ransac_multi_pair(
        mpa, mpb, mna, mnb, bm.valid, prior,
        phases=phases,
        num_trials=rc.max_iter,
        inlier_dist=rc.inlier_dist,
        inlier_normal_deg=rc.inlier_normal_angle,
        max_trans=rc.max_trans_no_neighbor,
        max_rot_deg=rc.max_rot_no_neighbor,
        min_matches=rc.min_match_after_ransac,
    )
    inputs = GraphInputs(
        poses=table.poses,
        frame_valid=table.frame_valid,
        free_mask=table.free_mask,
        corres=SparseCorres(pair_i=pi, pair_j=pj, pts_i=mpa, pts_j=mpb, valid=bm.valid & mr.inliers),
        dense_compact=dense_compact,
        K_lowres=K_lowres,
    )
    poses, info = optimize_pose_graph(inputs, cfg.bundle, p2p=cfg.p2p, group=group)
    return poses, info["final_cost"], info["high_residual_frac"]


def make_pair_sharded_ba(cfg, mesh, axis: str = "pairs"):
    """The pair-sharded BA step over `mesh[axis]`:

    step(table, dense_compact, K_lowres, pair_i, pair_j, pair_valid,
    generator=None, phases=None) -> (poses [K,4,4], cost, high_frac), the
    same on every rank.  Every rank passes the full pair arrays [P] and
    works on its block.  The RANSAC phases of all P pairs are drawn from
    `generator` (the same seed on every rank) before the block is cut, or
    given as [P, 3, n_rep], so the result equals the unsharded
    `ransac_multi_pair` solve."""
    group = axis_group(mesh, axis)
    n = group_size(group)

    def step(table, dense_compact, K_lowres, pair_i, pair_j, pair_valid, generator=None, phases=None):
        P = pair_i.shape[0]
        if P % n:
            raise ValueError(f"P={P} pairs must divide mesh axis {axis}={n}")
        if phases is None:
            phases = draw_phases((P,), cfg.ransac.max_iter, cfg.shapes.max_matches, generator)
        lo = group_rank(group) * (P // n)  # this rank's contiguous block, P(axis)'s layout
        hi = lo + P // n
        return _ba_local(table, dense_compact, K_lowres, pair_i[lo:hi], pair_j[lo:hi], pair_valid[lo:hi],
                         phases[lo:hi], cfg, group)

    return step
