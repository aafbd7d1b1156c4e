"""Flax layers in PyTorch, channels-first, and the carry-over of their weights.

The JAX package's networks (LF-Net, VOSNet) are Flax modules whose
checkpoints depend on Flax's exact conventions:
- `nn.Conv` pads "SAME" as XLA does: on a stride-2 axis of even size the
  padding is asymmetric, e.g. (0, 1) for a 3x3 conv and (2, 3) for a 7x7
  one, and 0 for a 1x1 conv;
- `nn.GroupNorm` has epsilon 1e-6 and takes the variance as
  E[x^2] - E[x]^2 clipped at 0 (flax's `use_fast_variance`), in f32, where
  `F.group_norm` has epsilon 1e-5 and a two-pass variance;
- parameters are stored under flat names (`ResNetBlock_1/Conv_0/kernel`),
  conv kernels as HWIO and dense kernels as [in, out].

In bf16 the layers compute what jax.jit of the Flax module computes (the
JAX package runs its LF-Net jitted), not the module run op by op: XLA on
the CPU keeps the bias add in f32 after the product's one rounding to
bf16, and sums a norm's statistics in its own order (`XlaGroupNorm`).

A port module names its submodules as Flax did (dots for slashes), so
`flax_param_shapes` and `state_dict_from_flax` map a checkpoint onto it
name for name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from trackbench.reference import precision
from trackbench.reference.kernels.norm_sums import xla_order_mean_var
from trackbench.reference.ops.numerics import clip, round_bf16, xla_normalize


def same_pads(size: int, k: int, stride: int):
    """(before, after) zero padding of XLA's "SAME" on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _bias_add(y: torch.Tensor, bias: torch.Tensor, shape) -> torch.Tensor:
    """y + bias in f32: in f32 as it is; a bf16 product rounded once
    (the result of the bf16 op) plus the bias rounded to bf16, kept in f32
    and not rounded again, as the jitted Flax layer computes it."""
    if y.dtype == torch.float32:
        return y + bias.view(shape)
    return y.to(torch.float32) + round_bf16(bias).view(shape)


class Conv(nn.Module):
    """Flax nn.Conv with "SAME" padding.  In f32: conv + bias.  In bf16:
    the product of bf16 operands, accumulated in f32 and rounded once to
    bf16, plus the bias rounded to bf16, added in f32 (`_bias_add`); the
    result is f32 either way."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x):
        (th, bh), (tw, bw) = (same_pads(n, self.k, self.stride) for n in x.shape[-2:])
        x = x.to(self.dtype)
        if (th, tw) == (bh, bw):
            y = F.conv2d(precision.net_operand(x), precision.net_operand(self.weight.to(self.dtype)), stride=self.stride, padding=(th, tw))
        else:
            y = F.conv2d(precision.net_operand(F.pad(x, (tw, bw, th, bh))), precision.net_operand(self.weight.to(self.dtype)), stride=self.stride)
        return _bias_add(y, self.bias, (1, -1, 1, 1))


class Dense(nn.Module):
    """Flax nn.Dense, the weight [out, in]; in bf16 as `Conv` is."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return _bias_add(F.linear(precision.net_operand(x.to(self.dtype)), precision.net_operand(self.weight.to(self.dtype))), self.bias, (-1,))


def channel_shape(x):
    """[1, C, 1, ...]: the shape that broadcasts a per-channel vector over x."""
    return [1, x.shape[1]] + [1] * (x.ndim - 2)


class GroupNorm(nn.Module):
    """Flax nn.GroupNorm(num_groups, dtype=f32) on [B, C, ...]: statistics
    over each group of C / num_groups consecutive channels and every other
    axis but the batch, epsilon 1e-6, variance E[x^2] - E[x]^2 clipped at 0,
    in f32."""

    def __init__(self, c: int, num_groups: int = 1, eps: float = 1e-6):
        super().__init__()
        if c % num_groups:
            raise ValueError(f"GroupNorm: {c} channels do not split into {num_groups} groups")
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x):
        x = x.to(torch.float32)
        B, C, G = x.shape[0], x.shape[1], self.num_groups
        g = x.reshape(B, G, C // G, -1)  # [B, group, channel in group, the other axes]
        mu = torch.mean(g, dim=(2, 3), keepdim=True)
        mu2 = torch.mean(g * g, dim=(2, 3), keepdim=True)
        var = clip(mu2 - mu * mu, 0.0)  # jnp.maximum(0, .): a tie splits its gradient
        # Flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.scale.view(1, G, C // G, 1)
        return ((g - mu) * mul + self.bias.view(1, G, C // G, 1)).reshape(x.shape)


class XlaGroupNorm(GroupNorm):
    """Flax nn.GroupNorm(1, dtype=f32) as jax.jit computes it on the CPU:
    the sum and the sum of squares in XLA's order, mean and variance by
    `xla_mean_var` (both `kernels/norm_sums.xla_order_mean_var`: one kernel
    launch on the card), the output fma(x - mean, rsqrt(var + eps) * scale,
    bias).  XLA's rsqrt is approximate (about 1.2 ulp); torch's is not, and
    that is left unmatched.  The statistics read
    x rounded to bf16 while x itself is normalised: in the jitted bf16
    LF-Net, the one place this norm runs, its input is a bf16 value whose
    rounding XLA keeps for the reduction only.  Inference only (no
    gradient)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__(c, num_groups=1, eps=eps)

    def forward(self, x):
        x = x.to(torch.float32)
        mean, var = xla_order_mean_var(x, round_bf16=True)
        shape = (-1,) + (1,) * (x.dim() - 1)
        cshape = channel_shape(x)
        mul = torch.rsqrt(var + self.eps).view(shape) * self.scale.view(cshape)
        return xla_normalize(x, mean.view(shape), mul, self.bias.view(cshape))


def _is_kernel(key: str, t: torch.Tensor) -> bool:
    return key.endswith(".weight") and t.ndim in (2, 4)


def flax_param_shapes(model: nn.Module) -> dict:
    """{Flax flat name: Flax shape} of every parameter of `model`: what a
    checkpoint for it must hold."""
    shapes = {}
    for key, t in model.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        name = module.replace(".", "/") + "/" + ("kernel" if _is_kernel(key, t) else leaf)
        s = tuple(t.shape)
        shapes[name] = (s[2], s[3], s[1], s[0]) if t.ndim == 4 else (s[::-1] if t.ndim == 2 else s)
    return shapes


def state_dict_from_flax(flat_params, dense_kernel=None) -> dict:
    """A state dict from flat Flax parameters {"a/b/kernel": array, ...}
    (numpy arrays): conv kernels HWIO -> OIHW, dense kernels [in, out] ->
    [out, in], everything else as it is, all as f32.

    `dense_kernel(name, array)`, when given, may rewrite a dense kernel
    (still [in, out]) before the transpose."""
    sd = {}
    for name, a in flat_params.items():
        a = np.array(a, np.float32)  # a writable copy
        module, leaf = name.rsplit("/", 1)
        key = module.replace("/", ".") + "." + leaf
        if leaf == "kernel":
            key = module.replace("/", ".") + ".weight"
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                if dense_kernel is not None:
                    a = dense_kernel(name, a)
                a = a.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd

