"""Sparse feature-correspondence residuals and normal-equation blocks.

Counterpart of bundletrack_tpu/solver/residuals.py (reference:
src/cuda/Solver/SolverBundlingEquationsLie.h evalFDevice / evalMinusJTFDevice).
Residual r = T_i p_i - T_j p_j with left-multiplicative updates
T <- exp(delta) T, delta = [t, w], d(T p)/d delta = [ I | -hat(T p) ].
Per-pair 6x6 blocks are scatter-added into [K, K, 6, 6]; repeated pair
indices accumulate with index_put_(accumulate=True), whose summation order
on CUDA varies from run to run (a few f32 ulps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.geometry.robust import huber
from bundletrack_tpu_torch.geometry.se3 import hat, transform_points


class SparseCorres(NamedTuple):
    """Padded correspondence set over a K-frame graph.

    pair_i/pair_j: [P] frame indices; pts_i/pts_j: [P, M, 3] camera-frame
    points of matched keypoints; valid: [P, M] bool.
    """

    pair_i: torch.Tensor
    pair_j: torch.Tensor
    pts_i: torch.Tensor
    pts_j: torch.Tensor
    valid: torch.Tensor


def sparse_residuals(poses: torch.Tensor, corres: SparseCorres):
    """Returns (r [P, M, 3], qi [P, M, 3], qj [P, M, 3])."""
    qi = transform_points(poses[corres.pair_i], corres.pts_i)
    qj = transform_points(poses[corres.pair_j], corres.pts_j)
    return qi - qj, qi, qj


def _pair_blocks(r, qi, qj, w):
    """Per-pair (Hii, Hjj, Hij [P,6,6], gi, gj [P,6]) with
    J_i = [I | -hat(qi)] and J_j = -[I | -hat(qj)]."""
    P, M = r.shape[0], r.shape[1]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(P, M, 3, 3)
    Ji = torch.cat([eye, -hat(qi)], dim=-1)  # [P, M, 3, 6]
    Jj = -torch.cat([eye, -hat(qj)], dim=-1)
    Hii = torch.einsum("pmai,pm,pmaj->pij", Ji, w, Ji)
    Hjj = torch.einsum("pmai,pm,pmaj->pij", Jj, w, Jj)
    Hij = torch.einsum("pmai,pm,pmaj->pij", Ji, w, Jj)
    gi = torch.einsum("pmai,pm,pma->pi", Ji, w, r)
    gj = torch.einsum("pmai,pm,pma->pi", Jj, w, r)
    return Hii, Hjj, Hij, gi, gj


def scatter_blocks(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """Accumulate per-pair blocks into H [K, K, 6, 6] and g [K, 6]."""
    H = torch.zeros((K, K, 6, 6), dtype=Hii.dtype, device=Hii.device)
    g = torch.zeros((K, 6), dtype=gi.dtype, device=gi.device)
    H.index_put_((pair_i, pair_i), Hii, accumulate=True)
    H.index_put_((pair_j, pair_j), Hjj, accumulate=True)
    H.index_put_((pair_i, pair_j), Hij, accumulate=True)
    H.index_put_((pair_j, pair_i), Hij.transpose(-1, -2), accumulate=True)
    g.index_put_((pair_i,), gi, accumulate=True)
    g.index_put_((pair_j,), gj, accumulate=True)
    return H, g


def sparse_normal_equations(poses, corres: SparseCorres, robust_delta: float, weight: float = 1.0):
    """Huber-weighted J^T J / J^T r of the sparse term.

    Returns (H [K,K,6,6], g [K,6], cost scalar, per-residual weights [P,M]).
    """
    K = poses.shape[0]
    r, qi, qj = sparse_residuals(poses, corres)
    e_sq = torch.sum(r * r, dim=-1)
    rho0, rho1 = huber(e_sq, robust_delta)
    valid = corres.valid.to(r.dtype)
    w = rho1 * valid * weight
    Hii, Hjj, Hij, gi, gj = _pair_blocks(r, qi, qj, w)
    H, g = scatter_blocks(K, corres.pair_i, corres.pair_j, Hii, Hjj, Hij, gi, gj)
    return H, g, torch.sum(rho0 * valid * weight), w
