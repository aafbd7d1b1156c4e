"""Robust loss (reference: src/cuda/Solver/SolverBundlingUtil.h:24-40 huberLoss)."""

from __future__ import annotations

import torch


def huber(e_sq: torch.Tensor, delta: float):
    """Huber loss on the squared residual norm.

    Returns (rho0, rho1): the loss and d rho / d e_sq, the IRLS weight the
    solver applies to J^T J and J^T r.
    """
    e = torch.sqrt(torch.clamp(e_sq, min=1e-24))
    quadratic = e <= delta
    rho0 = torch.where(quadratic, e_sq, 2.0 * delta * e - delta * delta)
    rho1 = torch.where(quadratic, torch.ones_like(e), delta / e)
    return rho0, rho1
