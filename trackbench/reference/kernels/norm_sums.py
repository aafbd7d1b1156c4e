"""Norm statistics summed in XLA's order, plain only: a frozen copy of the
port's kernels/norm_sums.py plain versions (no CUDA kernel).  Per group of
an f32 tensor [B, C, H, W] ([B, F] counts as [B, F, 1, 1]), the sum and
the sum of squares: the group's reduced axes viewed as [H, W, Cg]
row-major, each axis cut into windows of min(32, n) with "SAME" zero
padding, each window added sequentially in f32, then the window partials
sequentially (on the tensor's device: each add one f32 add, so the
sums are the port's host version's bit for bit).  `round_bf16` rounds every element to bf16
first, `shift` [G] subtracts its group's value first."""

from __future__ import annotations

import math

import torch

from trackbench.reference.ops.numerics import reciprocal_f32, xla_mean_var

WINDOW = 32  # XLA's window along each reduced axis


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return x[:, :, None, None]
    if x.dim() != 4:
        raise ValueError(f"xla_order_sums: x has shape {tuple(x.shape)}, not [B, C, H, W] or [B, F]")
    return x


def axis_windows(n: int):
    """(window, windows, padding before) of one reduced axis of size n."""
    w = min(WINDOW, n)
    nw = -(-n // w)
    return w, nw, (nw * w - n) // 2


def _windows(groups: torch.Tensor) -> torch.Tensor:
    """[G, H, W, Cg] -> [G, windows, window elements]: zero-padded "SAME",
    windows in row-major order, each window's elements in row-major order."""
    G, dims = groups.shape[0], groups.shape[1:]
    pads, shape, ws, nws = [], [G], [], []
    for n in dims:
        w, nw, lo = axis_windows(n)
        pads.append((lo, nw * w - n - lo))
        shape += [nw, w]
        ws.append(w)
        nws.append(nw)
    padded = torch.nn.functional.pad(groups, [p for pair in reversed(pads) for p in pair])
    k = len(dims)
    perm = [0] + [1 + 2 * i for i in range(k)] + [2 + 2 * i for i in range(k)]
    return padded.reshape(shape).permute(perm).reshape(G, math.prod(nws), math.prod(ws))


def _sequential(a: torch.Tensor) -> torch.Tensor:
    """The f32 sum along the last axis, added one element after another
    (each add a separate f32 add, as numpy's add.accumulate does)."""
    s = a[..., 0].clone()
    for j in range(1, a.shape[-1]):
        s = s + a[..., j]
    return s


def xla_order_sums_reference(x: torch.Tensor, per_channel: bool = False, round_bf16: bool = False,
                             shift: torch.Tensor | None = None):
    """Plain version of `xla_order_sums`, on x's device: (sum, sum of
    squares), each [B] (or [B * C] with `per_channel`), f32."""
    x4 = _as_nchw(x).detach().to(torch.float32)
    if round_bf16:
        x4 = x4.to(torch.bfloat16).to(torch.float32)
    B, C, H, W = x4.shape
    groups = x4.reshape(B * C, H, W, 1) if per_channel else x4.permute(0, 2, 3, 1)
    if shift is not None:
        groups = groups - shift.detach().to(torch.float32).reshape(-1, 1, 1, 1)
    win = _windows(groups.contiguous())
    return _sequential(_sequential(win)), _sequential(_sequential(win * win))


def xla_order_instance_stats_reference(maps):
    """Plain version of `xla_order_instance_stats`: per map, the sums in
    XLA's order on the host, mean = sum * f32(1 / (H * W)), then the sums of
    the squares shifted by it, times the same."""
    means, variances = [], []
    for x in maps:
        B, C, H, W = x.shape
        inv = reciprocal_f32(H * W)
        s, _ = xla_order_sums_reference(x, per_channel=True)
        mu = s * inv
        _, s2 = xla_order_sums_reference(x, per_channel=True, shift=mu)
        means.append(mu.view(B, C))
        variances.append((s2 * inv).view(B, C))
    return means, variances



def xla_order_sums(x: torch.Tensor, per_channel: bool = False, round_bf16: bool = False, shift=None):
    """(sum, sum of squares) of each group of x in XLA's order, by the plain
    version on the host, on x's device."""
    return xla_order_sums_reference(x, per_channel, round_bf16, shift)


def xla_order_mean_var(x: torch.Tensor, round_bf16: bool = False):
    """(mean, variance) [B] of each sample of x from the sums in XLA's order."""
    x4 = _as_nchw(x)
    return xla_mean_var(*xla_order_sums_reference(x4, False, round_bf16), x4[0].numel())


def xla_order_instance_stats(maps):
    """(means, variances), lists of [B, C] tensors, of each channel of each map."""
    return xla_order_instance_stats_reference(list(maps))
