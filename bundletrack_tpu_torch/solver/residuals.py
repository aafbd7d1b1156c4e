"""Sparse feature-correspondence residuals and normal-equation blocks.

Counterpart of bundletrack_tpu/solver/residuals.py (reference:
src/cuda/Solver/SolverBundlingEquationsLie.h evalFDevice / evalMinusJTFDevice).
Residual r = T_i p_i - T_j p_j with left-multiplicative updates
T <- exp(delta) T, delta = [t, w], d(T p)/d delta = [ I | -hat(T p) ].
Per-pair 6x6 blocks are summed into [K, K, 6, 6] by `scatter_blocks`
(kernels/normal_blocks.py): each entry's terms in one fixed order, the CPU's
and jax.jit's, on the card too, where index_add_'s atomics added in an order
that changed from run to run.  The blocks themselves are einsum products,
which the card sums in cuBLAS's order, not the CPU's.

Every function takes leading batch axes (the fleet's stream axis) on the
poses and the per-pair arrays; the pair indices [P] are shared by the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.geometry.robust import huber
from bundletrack_tpu_torch.geometry.se3 import hat, transform_points
from bundletrack_tpu_torch.kernels.normal_blocks import scatter_blocks


class SparseCorres(NamedTuple):
    """Padded correspondence set over a K-frame graph.

    pair_i/pair_j: [P] frame indices; pts_i/pts_j: [..., P, M, 3]
    camera-frame points of matched keypoints; valid: [..., P, M] bool.
    """

    pair_i: torch.Tensor
    pair_j: torch.Tensor
    pts_i: torch.Tensor
    pts_j: torch.Tensor
    valid: torch.Tensor


def sparse_residuals(poses: torch.Tensor, corres: SparseCorres):
    """Returns (r [..., P, M, 3], qi, qj) for poses [..., K, 4, 4]."""
    qi = transform_points(poses[..., corres.pair_i, :, :], corres.pts_i)
    qj = transform_points(poses[..., corres.pair_j, :, :], corres.pts_j)
    return qi - qj, qi, qj


def _pair_blocks(r, qi, qj, w):
    """Per-pair (Hii, Hjj, Hij [..., P, 6, 6], gi, gj [..., P, 6]) with
    J_i = [I | -hat(qi)] and J_j = -[I | -hat(qj)]."""
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(*r.shape[:-1], 3, 3)
    Ji = torch.cat([eye, -hat(qi)], dim=-1)  # [..., P, M, 3, 6]
    Jj = -torch.cat([eye, -hat(qj)], dim=-1)
    Hii = torch.einsum("...mai,...m,...maj->...ij", Ji, w, Ji)
    Hjj = torch.einsum("...mai,...m,...maj->...ij", Jj, w, Jj)
    Hij = torch.einsum("...mai,...m,...maj->...ij", Ji, w, Jj)
    gi = torch.einsum("...mai,...m,...ma->...i", Ji, w, r)
    gj = torch.einsum("...mai,...m,...ma->...i", Jj, w, r)
    return Hii, Hjj, Hij, gi, gj


def sparse_normal_equations(poses, corres: SparseCorres, robust_delta: float, weight: float = 1.0):
    """Huber-weighted J^T J / J^T r of the sparse term.

    Returns (H [...,K,K,6,6], g [...,K,6], cost [...], per-residual weights
    [...,P,M]).
    """
    K = poses.shape[-3]
    r, qi, qj = sparse_residuals(poses, corres)
    e_sq = torch.sum(r * r, dim=-1)
    rho0, rho1 = huber(e_sq, robust_delta)
    valid = corres.valid.to(r.dtype)
    w = rho1 * valid * weight
    Hii, Hjj, Hij, gi, gj = _pair_blocks(r, qi, qj, w)
    H, g = scatter_blocks(K, corres.pair_i, corres.pair_j, Hii, Hjj, Hij, gi, gj)
    return H, g, torch.sum(rho0 * valid * weight, dim=(-2, -1)), w
