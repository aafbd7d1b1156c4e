"""Rigid alignment: weighted Kabsch and the closed-form 3-point fit.

Counterpart of bundletrack_tpu/geometry/procrustes.py (reference: host
Kabsch src/Utils.cpp:180-218; per-trial RANSAC fit
src/cuda/cuda_ransac.cu procrustesKernel).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _weighted_centroid(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wsum = torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(pts * w[..., None], dim=-2) / torch.clamp(wsum, min=_EPS)


def _to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a 0-dim setitem would copy from the host
    return T


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None):
    """Weighted rigid alignment: T with dst ~= R @ src + t.

    src, dst: [..., N, 3]; weights: [..., N] (None = uniform).  Returns a
    [..., 4, 4] transform with a proper rotation (det=+1 reflection fix).
    The SVD's sign conventions differ between libraries; R does not.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    c_src = _weighted_centroid(src, weights)
    c_dst = _weighted_centroid(dst, weights)
    src_c = src - c_src[..., None, :]
    dst_c = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", src_c, weights, dst_c)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    det = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)
    t = c_dst - (R @ c_src[..., None])[..., 0]
    return _to_mat(R, t)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _triangle_frame(p: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame [..., 3, 3] (rows = basis) from 3 points [..., 3, 3]."""
    e1 = p[..., 1, :] - p[..., 0, :]
    e2 = p[..., 2, :] - p[..., 0, :]
    n1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=_EPS)
    e2p = e2 - torch.sum(e2 * n1, dim=-1, keepdim=True) * n1
    n2 = e2p / torch.clamp(torch.linalg.norm(e2p, dim=-1, keepdim=True), min=_EPS)
    n3 = _cross(n1, n2)
    return torch.stack([n1, n2, n3], dim=-2)


def rigid_from_three_points(src: torch.Tensor, dst: torch.Tensor):
    """Closed-form rigid transform from 3-point samples (dst ~= R src + t).

    Exact for congruent triangles; degenerate (collinear) samples give some
    rotation and are flagged invalid.  Returns ([..., 4, 4], [...] bool).
    """
    Fs = _triangle_frame(src)
    Fd = _triangle_frame(dst)
    R = Fd.transpose(-1, -2) @ Fs
    c_src = torch.mean(src, dim=-2)
    c_dst = torch.mean(dst, dim=-2)
    t = c_dst - (R @ c_src[..., None])[..., 0]

    def area(p):
        return torch.linalg.norm(
            _cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :]), dim=-1
        )

    valid = (area(src) > 1e-10) & (area(dst) > 1e-10)
    return _to_mat(R, t), valid
