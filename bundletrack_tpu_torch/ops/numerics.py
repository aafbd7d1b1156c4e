"""Scalar constants evaluated in f32 on the host, and XLA's flush of denormals.

The JAX package folds configuration values into weakly typed f32 constants
(`jnp.cos(jnp.deg2rad(45.0))` is computed in f32).  The port evaluates the
same expressions in f32 on the host and passes the result as a Python float:
the value is exactly representable in f32, so comparing an f32 tensor with
it is the same comparison, and no host-to-device copy (which synchronises
the device) is needed.
"""

from __future__ import annotations

import functools

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _t(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def f32(x: float) -> float:
    """x rounded to f32."""
    return float(_t(x))


@functools.lru_cache(maxsize=None)
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


# ---- f32 arithmetic in the order jax.jit computes it on the CPU -------------
# XLA's CPU backend contracts a multiply feeding an add into one fused
# multiply-add, and turns a division by a constant into a product with its
# f32 reciprocal; the LF-Net's norms (Flax GroupNorm, instance_norm) compute
# their statistics and their output that way under jax.jit.


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors (broadcast) with one rounding, as a fused
    multiply-add: the product is exact in f64, and the f64 sum rounds to
    the f32 an fma gives except at an f32 halfway point after the f64
    rounding (about one input in 2^29)."""
    # b in f64 promotes the product and the sum to f64 inside one kernel
    return torch.addcmul(c, a, b.double()).float()


@functools.lru_cache(maxsize=None)
def reciprocal_f32(n: int) -> float:
    """f32(1) / f32(n), the factor XLA multiplies a sum of n elements by
    for their mean."""
    return float(_t(1.0) / _t(float(n)))


def xla_mean_var(s: torch.Tensor, s2: torch.Tensor, n: int):
    """(mean, variance) from the sums and sums of squares [B] of n elements
    each, as jax.jit computes Flax's statistics (use_fast_variance): mean =
    sum * (1/n); var = max(0, fma(sum2, 1/n, -(mean * mean))), or for a
    single sample (B = 1, where XLA folds the two factors 1/n of mean *
    mean into one) max(0, fma(sum2, 1/n, -(sum * sum) * (1/n)^2))."""
    inv = reciprocal_f32(n)
    mean = s * inv
    square = (s * s) * square_f32(inv) if s.numel() == 1 else mean * mean
    # fma(sum2, inv, -square): sum2 * inv is exact in f64 (fma_f32's rounding)
    return mean, torch.clamp_min(torch.sub(s2.double() * inv, square).float(), 0.0)


def xla_normalize(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fma(x - mean, mul, bias): Flax's `(x - mean) * mul + bias` as jax.jit
    computes it, mul = rsqrt(var + eps) * scale."""
    return fma_f32(x - mean, mul, bias)
