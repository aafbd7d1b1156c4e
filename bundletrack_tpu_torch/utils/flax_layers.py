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

A port module names its submodules as Flax did (dots for slashes), so
`flax_param_shapes` and `state_dict_from_flax` map a checkpoint onto it
name for name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bundletrack_tpu_torch.ops.numerics import clip


def same_pads(size: int, k: int, stride: int):
    """(before, after) zero padding of XLA's "SAME" on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax nn.Conv with "SAME" padding, computed in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x):
        (th, bh), (tw, bw) = (same_pads(n, self.k, self.stride) for n in x.shape[-2:])
        x = x.to(self.dtype)
        if (th, tw) == (bh, bw):
            y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=(th, tw))
        else:
            y = F.conv2d(F.pad(x, (tw, bw, th, bh)), self.weight.to(self.dtype), stride=self.stride)
        return y + self.bias.to(self.dtype)[None, :, None, None]


class Dense(nn.Module):
    """Flax nn.Dense computed in `dtype`; the weight is [out, in]."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


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


def flax_from_state_dict(sd, dense_kernel=None) -> dict:
    """The inverse of `state_dict_from_flax`: flat Flax parameters {"a/b/kernel":
    f32 numpy array} from a state dict; conv kernels OIHW -> HWIO, dense
    kernels [out, in] -> [in, out].  `dense_kernel(name, array)`, when given,
    may rewrite a dense kernel after the transpose (then [in, out])."""
    flat = {}
    for key, t in sd.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        module, leaf = key.rsplit(".", 1)
        name = module.replace(".", "/") + "/" + ("kernel" if _is_kernel(key, t) else leaf)
        if _is_kernel(key, t):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            if a.ndim == 2 and dense_kernel is not None:
                a = dense_kernel(name, a)
        flat[name] = np.ascontiguousarray(a)
    return flat
