"""Batched 3-point RANSAC for rigid pose hypotheses.

Counterpart of bundletrack_tpu/ransac/ransac.py (reference:
src/cuda/cuda_ransac.cu and runRansacMultiPairGPU,
src/FeatureManager.cpp:659-741).  Inputs may carry leading batch axes: the
tracker runs every BA pair in one call, the neighbour pair as a batch of one.

Trials come from the same combinatorial design as the JAX package: three
fixed shuffles of the match slots (numpy RandomState(1000+k), rebuilt here
exactly) rolled by per-repeat random phases `b` [..., 3, n_rep].  The phases
are the only random input.  The JAX package draws them with jax.random; here
the caller passes them in: the tracker draws them from its torch.Generator
(`draw_phases`), the parity tests pass JAX's own draw.

Scoring is one f32 matmul per batch, G [M, 26] x F [26, T]; it needs full
f32 (see the package __init__ on TF32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from trackbench.reference import precision
from trackbench.reference.geometry.procrustes import kabsch
from trackbench.reference.geometry.se3 import transform_normals, transform_points
from trackbench.reference.ops.numerics import cos_deg_f32


class RansacResult(NamedTuple):
    best_pose: torch.Tensor  # [..., 4, 4] A->B camera-frame transform
    inliers: torch.Tensor  # [..., M] bool
    num_inliers: torch.Tensor  # [...] int
    valid: torch.Tensor  # [...] bool


def num_repeats(num_trials: int, num_matches: int) -> int:
    """Repeats of the design: T_eff = n_rep * M >= num_trials."""
    return -(-num_trials // num_matches)


def draw_phases(batch_shape, num_trials: int, num_matches: int, generator: torch.Generator):
    """Per-repeat phases [*batch_shape, 3, n_rep] in [0, M) from `generator`."""
    n_rep = num_repeats(num_trials, num_matches)
    return torch.randint(
        0, num_matches, (*batch_shape, 3, n_rep),
        generator=generator, device=generator.device,
    )


def _score_model(T_ab, pts_a, pts_b, normals_a, normals_b, match_valid, inlier_dist, cos_normal):
    """[..., M] inlier mask of one model per batch entry (direct evaluation)."""
    pa = transform_points(T_ab, pts_a)
    na = transform_normals(T_ab, normals_a)
    d2 = torch.sum((pa - pts_b) ** 2, dim=-1)
    cos = torch.sum(na * normals_b, dim=-1)
    return (d2 < inlier_dist * inlier_dist) & (cos > cos_normal) & match_valid


def _match_features(pts_a, pts_b, normals_a, normals_b):
    """Per-match feature table G [..., M, 26] for bilinear trial scoring:
    with R orthonormal, |R pa + t - pb|^2 and (R na).nb are dot products of
    a trial feature and this match feature."""
    shp = pts_a.shape[:-1]
    outer_pb_pa = (pts_b[..., :, None] * pts_a[..., None, :]).reshape(*shp, 9)
    outer_nb_na = (normals_b[..., :, None] * normals_a[..., None, :]).reshape(*shp, 9)
    sq = torch.sum(pts_a * pts_a, -1) + torch.sum(pts_b * pts_b, -1)
    ones = torch.ones_like(sq)
    return torch.cat(
        [pts_a, pts_b, outer_pb_pa, sq[..., None], ones[..., None], outer_nb_na], dim=-1
    )


# ---- structure-of-arrays trial pipeline: every quantity is [..., T] ----------


def _soa_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _soa_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _soa_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _soa_normalize(a, eps=1e-12):
    inv = torch.rsqrt(torch.clamp(_soa_dot(a, a), min=eps))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _soa_frame(p0, p1, p2):
    """Orthonormal frame rows (n1, n2, n3) + squared triangle area x4."""
    e1 = _soa_sub(p1, p0)
    e2 = _soa_sub(p2, p0)
    n1 = _soa_normalize(e1)
    proj = _soa_dot(e2, n1)
    e2p = (e2[0] - proj * n1[0], e2[1] - proj * n1[1], e2[2] - proj * n1[2])
    n2 = _soa_normalize(e2p)
    n3 = _soa_cross(n1, n2)
    c = _soa_cross(e1, e2)
    return (n1, n2, n3), _soa_dot(c, c)


def _soa_fit_trials(tri_a, tri_b):
    """Closed-form rigid fit over 3-point samples; tri_*: [..., T, 3, 3].
    Returns (R: 9 [..., T] arrays row-major, t: 3 arrays, ok [..., T])."""
    pa = [tuple(tri_a[..., k, c] for c in range(3)) for k in range(3)]
    pb = [tuple(tri_b[..., k, c] for c in range(3)) for k in range(3)]
    Fa, area_a = _soa_frame(*pa)
    Fb, area_b = _soa_frame(*pb)
    R = tuple(
        Fb[0][i] * Fa[0][j] + Fb[1][i] * Fa[1][j] + Fb[2][i] * Fa[2][j]
        for i in range(3)
        for j in range(3)
    )
    third = 1.0 / 3.0
    ca = tuple((pa[0][c] + pa[1][c] + pa[2][c]) * third for c in range(3))
    cb = tuple((pb[0][c] + pb[1][c] + pb[2][c]) * third for c in range(3))
    t = tuple(
        cb[i] - (R[3 * i + 0] * ca[0] + R[3 * i + 1] * ca[1] + R[3 * i + 2] * ca[2])
        for i in range(3)
    )
    ok = (area_a > 1e-20) & (area_b > 1e-20)
    return R, t, ok


def _soa_pose_gate(R, t, prior_ab, max_trans, max_rot_deg):
    """Translation/rotation gate against the prior ([..., 4, 4])."""
    Rp = prior_ab[..., :3, :3]
    tp = prior_ab[..., :3, 3]
    dt = tuple(t[c] - tp[..., c, None] for c in range(3))
    trans_ok = _soa_dot(dt, dt) < max_trans * max_trans
    trace = Rp[..., 0, 0, None] * R[0]
    for k in range(1, 9):
        trace = trace + Rp[..., k // 3, k % 3, None] * R[k]
    cos_lim = cos_deg_f32(min(max_rot_deg, 179.9))
    return trans_ok & ((trace - 1.0) * 0.5 > cos_lim)


def _soa_trial_features(R, t):
    """F [..., 26, T] in _match_features' column order."""
    rt = tuple(R[0 + j] * t[0] + R[3 + j] * t[1] + R[6 + j] * t[2] for j in range(3))
    tt = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    cols = (
        [2.0 * rt[j] for j in range(3)]
        + [-2.0 * t[i] for i in range(3)]
        + [-2.0 * R[k] for k in range(9)]
        + [torch.ones_like(tt), tt]
        + [R[k] for k in range(9)]
    )
    return torch.stack(cols, dim=-2)


def _soa_count_inliers(F, G, match_valid, inlier_dist, cos_normal):
    """[..., T] inlier counts: G [..., M, 26] x F [..., 26, T] in full f32."""
    d2 = G[..., :17] @ F[..., :17, :]
    cos = G[..., 17:] @ F[..., 17:, :]
    inl = (d2 < inlier_dist * inlier_dist) & (cos > cos_normal) & match_valid[..., None]
    return torch.sum(inl, dim=-2)


@functools.lru_cache(maxsize=16)
def _shuffles(M: int, device: torch.device) -> torch.Tensor:
    """The design's three fixed shuffles [3, M], exactly as the JAX package
    builds them; cached, so the upload (a host-to-device copy, which
    synchronises) happens once per size and device."""
    pis = [np.random.RandomState(1000 + k).permutation(M) for k in range(3)]
    return torch.as_tensor(np.stack(pis), dtype=torch.int64, device=device)


def ransac_pair(
    pts_a: torch.Tensor,  # [..., M, 3] camera-frame points of matched keypoints in A
    pts_b: torch.Tensor,  # [..., M, 3] matched points in B
    normals_a: torch.Tensor,
    normals_b: torch.Tensor,
    match_valid: torch.Tensor,  # [..., M] bool
    prior_ab: torch.Tensor,  # [..., 4, 4] expected A->B transform (pose gate)
    *,
    phases: torch.Tensor,  # [..., 3, n_rep] ints in [0, M)
    num_trials: int = 2048,
    inlier_dist: float = 0.01,
    inlier_normal_deg: float = 45.0,
    max_trans: float = 1e9,
    max_rot_deg: float = 1e9,
    min_matches: int = 5,
) -> RansacResult:
    """RANSAC over match sets with any leading batch axes."""
    pts_a, pts_b, normals_a, normals_b = (precision.low(t) for t in (pts_a, pts_b, normals_a, normals_b))
    M = pts_a.shape[-2]
    batch = pts_a.shape[:-2]
    dev = pts_a.device
    n_rep = num_repeats(num_trials, M)
    if tuple(phases.shape) != (*batch, 3, n_rep):
        raise ValueError(f"phases must have shape {(*batch, 3, n_rep)}, got {tuple(phases.shape)}")
    phases = phases.to(device=dev, dtype=torch.int64)
    num_valid = torch.sum(match_valid, dim=-1)
    cos_normal = cos_deg_f32(inlier_normal_deg)

    # valid-first order of match slots, cycled over all M slots
    iota = torch.arange(M, device=dev)
    cnt = torch.cumsum(match_valid.to(torch.int64), dim=-1)
    pos = torch.where(match_valid, cnt - 1, num_valid[..., None] + (iota - cnt))
    order = torch.zeros_like(pos).scatter(-1, pos, iota.expand_as(pos))
    fill = torch.gather(order, -1, iota % torch.clamp(num_valid, min=1)[..., None])

    packed = torch.cat(
        [pts_a, pts_b, iota.to(pts_a.dtype).expand(*batch, M)[..., None]], dim=-1
    )  # [..., M, 7]: xyz_a, xyz_b, match id (for distinctness)
    pis = _shuffles(M, dev)
    # trial (r, j) of vertex k is tbl_k[(j + b[k, r]) mod M]: rolling the
    # table by -b[k, r], as the JAX package does, without a host-side shift
    roll = (iota + phases[..., :, :, None]) % M  # [..., 3, n_rep, M]
    verts = []
    for k in range(3):
        tbl_idx = torch.gather(fill, -1, pis[k].expand(*batch, M))  # [..., M]
        idx = torch.gather(tbl_idx, -1, roll[..., k, :, :].reshape(*batch, n_rep * M))
        verts.append(
            torch.gather(packed, -2, idx[..., None].expand(*batch, n_rep * M, 7))
        )
    g = torch.stack(verts, dim=-2)  # [..., T, 3, 7]
    ids = g[..., 6]
    distinct = (ids[..., 0] != ids[..., 1]) & (ids[..., 0] != ids[..., 2]) & (ids[..., 1] != ids[..., 2])

    R, t, tri_ok = _soa_fit_trials(g[..., 0:3], g[..., 3:6])
    gate_ok = _soa_pose_gate(R, t, prior_ab, max_trans, max_rot_deg)
    model_ok = tri_ok & distinct & gate_ok

    G = _match_features(pts_a, pts_b, normals_a, normals_b)
    F = _soa_trial_features(R, t)
    counts = _soa_count_inliers(F, G, match_valid, inlier_dist, cos_normal) * model_ok

    best = torch.argmax(counts, dim=-1, keepdim=True)  # first of equal counts
    Rb = torch.stack([torch.gather(r, -1, best)[..., 0] for r in R], dim=-1).reshape(*batch, 3, 3)
    tb = torch.stack([torch.gather(c, -1, best)[..., 0] for c in t], dim=-1)
    best_pose = torch.zeros((*batch, 4, 4), dtype=pts_a.dtype, device=dev)
    best_pose[..., :3, :3] = Rb
    best_pose[..., :3, 3] = tb
    best_pose[..., 3, 3].fill_(1.0)
    best_inl = _score_model(
        best_pose, pts_a, pts_b, normals_a, normals_b, match_valid, inlier_dist, cos_normal
    )
    n_inl = torch.sum(best_inl, dim=-1)
    valid = (torch.gather(counts, -1, best)[..., 0] >= min_matches) & (num_valid >= min_matches)
    return RansacResult(
        best_pose=best_pose,
        inliers=best_inl & valid[..., None],
        num_inliers=torch.where(valid, n_inl, torch.zeros_like(n_inl)),
        valid=valid,
    )


def ransac_multi_pair(
    pts_a: torch.Tensor,  # [P, M, 3]
    pts_b: torch.Tensor,
    normals_a: torch.Tensor,
    normals_b: torch.Tensor,
    match_valid: torch.Tensor,  # [P, M]
    prior_ab: torch.Tensor,  # [P, 4, 4]
    *,
    generator: Optional[torch.Generator] = None,
    phases: Optional[torch.Tensor] = None,  # [P, 3, n_rep]
    num_trials: int = 2048,
    **kw,
) -> RansacResult:
    """RANSAC across P frame pairs in one batched call (reference
    runRansacMultiPairGPU; JAX `ransac_multi_pair`).  The phases of all P
    pairs are drawn at once from `generator` unless given: the JAX function
    splits its key into P keys first, so that a pair's draws do not depend
    on how the pairs are later sharded, and so does this."""
    if phases is None:
        phases = draw_phases((pts_a.shape[0],), num_trials, pts_a.shape[-2], generator)
    return ransac_pair(pts_a, pts_b, normals_a, normals_b, match_valid, prior_ab, phases=phases,
                       num_trials=num_trials, **kw)


def refine_pose_on_inliers(pts_a, pts_b, inliers) -> torch.Tensor:
    """Weighted Kabsch refit on the inlier set (reference
    procrustesByCorrespondence, src/FeatureManager.cpp:523-557)."""
    return kabsch(pts_a, pts_b, inliers.to(pts_a.dtype))

