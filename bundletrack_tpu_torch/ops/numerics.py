"""Scalar constants evaluated in f32 on the host, and XLA's flush of denormals.

The JAX package folds configuration values into weakly typed f32 constants
(`jnp.cos(jnp.deg2rad(45.0))` is computed in f32).  The port evaluates the
same expressions in f32 on the host and passes the result as a Python float:
the value is exactly representable in f32, so comparing an f32 tensor with
it is the same comparison, and no host-to-device copy (which synchronises
the device) is needed.
"""

from __future__ import annotations

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _t(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def f32(x: float) -> float:
    """x rounded to f32."""
    return float(_t(x))


def square_f32(x: float) -> float:
    """f32(x) ** 2 evaluated in f32."""
    t = _t(x)
    return float(t * t)


def exp_f32(x: float) -> float:
    """exp(f32(x)) evaluated in f32."""
    return float(torch.exp(_t(x)))


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """x with its denormal f32 values set to 0, as XLA on the CPU treats
    them (flush to zero); torch keeps them."""
    return torch.where(torch.abs(x) < _F32_TINY, torch.zeros_like(x), x)


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """x clipped to [lo, hi] with jnp.clip's gradient: torch.maximum and
    torch.minimum against 0-dim bounds split the gradient of a tie 0.5 /
    0.5, as jax's maximum and minimum do, where torch.clamp passes all of
    it (a sample on an integer pixel has a bilinear fraction of exactly 0).
    The values are torch.clamp's.  The bounds are f32 CPU scalars, which
    every device takes without an upload."""
    if lo is not None:
        x = torch.maximum(x, _t(lo))
    if hi is not None:
        x = torch.minimum(x, _t(hi))
    return x


def cos_deg_f32(deg: float) -> float:
    """cos(deg2rad(f32(deg))) evaluated in f32."""
    return float(torch.cos(torch.deg2rad(_t(deg))))



def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)
