"""Block-Jacobi preconditioned conjugate gradient on the blocked normal equations.

Counterpart of bundletrack_tpu/solver/pcg.py (reference:
src/cuda/Solver/SolverBundling.cu Initialization and PCGIteration, the
inner solver of every GN iteration).  H is assembled in [K, K, 6, 6]
blocks, so the matvec is one einsum in f32 (TF32 is off in the port, the
JAX package's precision="highest").  Leading axes batch independent
graphs, as the Cholesky solve does: every dot product is a per-graph sum
over the last two axes, and the guards against a zero denominator are
`torch.where`, so the loop makes no device-to-host read.
"""

from __future__ import annotations

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-graph dot product of [..., K, 6] vectors -> [...]."""
    return torch.sum(a * b, dim=(-2, -1))


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, and 0 where |den| < 1e-20."""
    small = torch.abs(den) < 1e-20
    return torch.where(small, torch.zeros_like(num), num / torch.where(small, torch.ones_like(den), den))


def solve_normal_equations_pcg(H, g, num_iters: int = 5, lm_lambda: float = 1e-6):
    """Approximately solve (H + lambda I) delta = -g, H [..., K, K, 6, 6] and
    g [..., K, 6], with `num_iters` PCG steps from delta = 0.

    Block-Jacobi preconditioner: the inverse of each 6x6 diagonal block
    (plus 1e-8 I).  `inv_ex` leaves a singular block's inverse to the
    arithmetic, as the JAX package's `inv` does, where `torch.linalg.inv`
    would raise after a device-to-host check.
    """
    K = H.shape[-3]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    diag_blocks = torch.eye(K, dtype=H.dtype, device=H.device)[:, :, None, None] * eye6  # [K, K, 6, 6]
    H = H + lm_lambda * diag_blocks
    diag = torch.diagonal(H, dim1=-4, dim2=-3).movedim(-1, -3)  # [..., K, 6, 6]
    Minv, _ = torch.linalg.inv_ex(diag + 1e-8 * eye6)

    def precondition(r):
        return torch.einsum("...kab,...kb->...ka", Minv, r)

    r = -g  # x0 = 0
    x = torch.zeros_like(r)
    z = precondition(r)
    p = z
    rz = _dot(r, z)
    for _ in range(num_iters):
        Ap = torch.einsum("...klab,...lb->...ka", H, p)
        alpha = _safe_ratio(rz, _dot(p, Ap))[..., None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = precondition(r)
        rz_new = _dot(r, z)
        beta = _safe_ratio(rz_new, rz)[..., None, None]
        p = z + beta * p
        rz = rz_new
    return x
