"""SO(3)/SE(3) Lie-group operations, branch-free and batched.

Counterpart of bundletrack_tpu/geometry/se3.py (reference:
src/cuda/Solver/LieDerivUtil.h).  Every function broadcasts over leading
batch dimensions; small-angle branches are Taylor expansions chosen with
`torch.where`, never with host control flow.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (1 - A)/t^2), Taylor below t^2 ~ 1e-8."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / theta_sq)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle, stable for all angles."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    safe_sin = torch.where(torch.abs(sin_t) < 1e-6, torch.ones_like(sin_t), sin_t)
    scale = torch.where(theta < 1e-4, 1.0 + theta * theta / 6.0, theta / safe_sin)
    w_generic = w_skew * scale[..., None]
    # near pi: the rotation axis is the largest column of R + I
    B = R + _eye_like(R)
    col_norms = torch.sum(B * B, dim=-2)
    k = torch.argmax(col_norms, dim=-1)
    idx = k[..., None, None].expand(*B.shape[:-1], 1)
    axis = torch.gather(B, -1, idx)[..., 0]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    sign = torch.sign(torch.sum(axis * w_skew, dim=-1))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    w_pi = axis * (sign * theta)[..., None]
    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that the se3_exp translation is V @ rho."""
    theta_sq = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta_sq < 1e-8
    half_theta = 0.5 * theta
    cot = half_theta / torch.tan(torch.where(small, torch.ones_like(half_theta), half_theta))
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - cot) / torch.clamp(theta_sq, min=_EPS),
    )
    return _eye_like(W) - 0.5 * W + coef[..., None, None] * W2


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a 0-dim setitem would copy from the host
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist (rho, w) -> [..., 4, 4]; xi = [tx, ty, tz, wx, wy, wz]."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = (V @ rho[..., None])[..., 0]
    return _rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] twist (rho, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Vinv = _so3_left_jacobian_inv(w)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def rotate_points(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 3] rotations to [..., N, 3] points, as nine
    broadcast multiply-adds in the same order as the JAX package."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    def e(i, j):
        return R[..., i, j][..., None]

    return torch.stack(
        [
            e(0, 0) * x + e(0, 1) * y + e(0, 2) * z,
            e(1, 0) * x + e(1, 1) * y + e(1, 2) * z,
            e(2, 0) * x + e(2, 1) * y + e(2, 2) * z,
        ],
        dim=-1,
    )


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3] (or broadcastable) points."""
    return rotate_points(T[..., :3, :3], pts) + T[..., :3, 3][..., None, :]


def transform_normals(T: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return rotate_points(T[..., :3, :3], n)


def rotation_geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations (reference Utils.cpp:41-47)."""
    cos = (torch.sum(R1 * R2, dim=(-2, -1)) - 1.0) * 0.5
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def se3_update_left(delta: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative GN update T <- exp(delta) @ T."""
    return se3_exp(delta) @ T


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] near-rotations onto SO(3) by symmetric
    orthogonalization, U diag(1, 1, det(U V^T)) V^T (invariant to the
    SVD's sign conventions)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * d[..., None, :]) @ vt
