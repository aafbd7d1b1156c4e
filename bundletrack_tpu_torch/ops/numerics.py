"""Scalar constants evaluated in f32 on the host.

The JAX package folds configuration values into weakly typed f32 constants
(`jnp.cos(jnp.deg2rad(45.0))` is computed in f32).  The port evaluates the
same expressions in f32 on the host and passes the result as a Python float:
the value is exactly representable in f32, so comparing an f32 tensor with
it is the same comparison, and no host-to-device copy (which synchronises
the device) is needed.
"""

from __future__ import annotations

import torch


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


def cos_deg_f32(deg: float) -> float:
    """cos(deg2rad(f32(deg))) evaluated in f32."""
    return float(torch.cos(torch.deg2rad(_t(deg))))
