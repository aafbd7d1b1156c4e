"""Norm statistics summed in XLA's order: the sums kernel and its plain version.

The JAX package runs LF-Net jitted, and XLA's CPU backend adds the f32
statistics of its norms in an order of its own.  `xla_order_sums` gives,
per group of an f32 tensor [B, C, H, W] ([B, F] counts as [B, F, 1, 1]),
the sum and the sum of squares in that order.  A group is a whole sample
(Flax GroupNorm(1)) or, with `per_channel`, one channel of a sample
(detector_ops.instance_norm).  The order: the group's reduced axes viewed
as [H, W, Cg] row-major, the channel innermost; each axis cut into windows
of min(32, n) with "SAME" zero padding, pad // 2 before; each window added
sequentially from 0 in row-major order, then the window partials
sequentially in window row-major order; each square rounded to f32 before
it is added.  `round_bf16` rounds every element to bf16 first (the jitted
bf16 forward's statistics read rounded values), `shift` [G] subtracts its
group's value first.  Held bit for bit to jax.jit of Flax's GroupNorm
statistics and of instance_norm on the LF-Net shapes
(tests/test_torch_norm_sums.py); a 2x2 or 4x4 window grid (inputs 64 and
128) is not XLA's order, and is bounded there instead.
`xla_order_mean_var` gives GroupNorm(1)'s mean and variance from the same
sums, and `xla_order_instance_stats` the instance norm's mean (sum * f32(1 /
(H * W))) and variance (the sum of (x - mean)^2 times the same) of every
channel of a ragged list of maps.

For a CUDA tensor each wrapper makes ONE launch of the kernel in
csrc/xla_order_sums.cu (built with nvcc at first use, bound with ctypes) or
raises: producer warps read NCHW and stage each window in chain order
through a shared-memory ring, consumer lanes add one window's chain each;
a block whose windows make whole groups (a group of at most 32 windows)
adds their partials itself, else the last block adds every group's, and
for `xla_order_mean_var` derives the mean and variance;
`xla_order_instance_stats` runs its two passes (the sums, then the
squares shifted by the means) in one cooperative launch, up to MAX_MAPS
maps.  The kernel's blocks count on ticket counters (where a last block
adds) and write a workspace; the wrapper keeps both per device and
stream, so launches on one stream share them in order and launches on
two streams never do.  The wrappers send tensors on the CPU, and only
those, to the plain versions (`xla_order_sums_reference`, which adds
sequentially in f32 on the host with numpy's add.accumulate, torch.cumsum
may accumulate in double; `xla_order_instance_stats_reference`, which
composes it as instance_norm did).  None has a gradient: the kernel path
refuses an input that requires one while autograd records.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bundletrack_tpu_torch.kernels import build
from bundletrack_tpu_torch.ops.numerics import reciprocal_f32, square_f32, xla_mean_var
from bundletrack_tpu_torch.utils.profiling import annotate

SOURCE = "xla_order_sums.cu"
WINDOW = 32  # XLA's window along each reduced axis
MAX_MAPS = 16  # maps per launch of `xla_order_instance_stats`

# kernel launches made through the wrapper (the main path's proof of route)
launches = 0


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


def _windows(groups: np.ndarray) -> np.ndarray:
    """[G, H, W, Cg] -> [G, windows, window elements]: zero-padded "SAME",
    windows in row-major order, each window's elements in row-major order."""
    G, dims = groups.shape[0], groups.shape[1:]
    pads, shape, ws, nws = [(0, 0)], [G], [], []
    for n in dims:
        w, nw, lo = axis_windows(n)
        pads.append((lo, nw * w - n - lo))
        shape += [nw, w]
        ws.append(w)
        nws.append(nw)
    k = len(dims)
    perm = [0] + [1 + 2 * i for i in range(k)] + [2 + 2 * i for i in range(k)]
    return np.pad(groups, pads).reshape(shape).transpose(perm).reshape(G, int(np.prod(nws)), int(np.prod(ws)))


def _sequential(a: np.ndarray) -> np.ndarray:
    """The f32 sum along the last axis, added one element after another."""
    return np.add.accumulate(a, axis=-1, dtype=np.float32)[..., -1]


def xla_order_sums_reference(x: torch.Tensor, per_channel: bool = False, round_bf16: bool = False,
                             shift: torch.Tensor | None = None):
    """Plain version of `xla_order_sums`, on the host: (sum, sum of
    squares), each [B] (or [B * C] with `per_channel`), f32 on x's device."""
    x4 = _as_nchw(x).detach().to(torch.float32)
    if round_bf16:
        x4 = x4.to(torch.bfloat16).to(torch.float32)
    a = x4.cpu().numpy()
    B, C, H, W = a.shape
    groups = a.reshape(B * C, H, W, 1) if per_channel else a.transpose(0, 2, 3, 1)
    if shift is not None:
        groups = groups - shift.detach().to("cpu", torch.float32).numpy().reshape(-1, 1, 1, 1)
    win = _windows(np.ascontiguousarray(groups, dtype=np.float32))
    s = _sequential(_sequential(win))
    s2 = _sequential(_sequential(win * win))
    return (torch.from_numpy(np.ascontiguousarray(s)).to(x.device),
            torch.from_numpy(np.ascontiguousarray(s2)).to(x.device))


@functools.lru_cache(maxsize=None)
def _library():
    """The built library with its C functions' signatures set, once."""
    lib = build.load(SOURCE)
    lib.xla_order_sums_launch.restype = ctypes.c_int
    lib.xla_order_sums_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_void_p] * 3
    )
    lib.xla_order_sums_workspace_floats.restype = ctypes.c_size_t
    lib.xla_order_sums_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.xla_order_instance_stats_launch.restype = ctypes.c_int
    lib.xla_order_instance_stats_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8
    lib.xla_order_instance_workspace_floats.restype = ctypes.c_size_t
    lib.xla_order_instance_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.xla_order_sums_add_probe.restype = ctypes.c_int
    lib.xla_order_sums_add_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


class _StreamScratch:
    """One stream's ticket counters (0 between launches: the last block of
    each launch resets them) and workspace, grown to the largest launch."""

    def __init__(self, device: torch.device):
        self.counter = torch.zeros(4, dtype=torch.int32, device=device)
        self.workspace = torch.empty(0, dtype=torch.float32, device=device)

    def workspace_ptr(self, floats: int) -> int:
        if self.workspace.numel() < floats:
            self.workspace = torch.empty(floats, dtype=torch.float32, device=self.counter.device)
        return self.workspace.data_ptr()


_scratch: dict = {}  # (device index, stream handle) -> _StreamScratch


@functools.lru_cache(maxsize=1024)
def _workspace_floats(B: int, C: int, H: int, W: int, per_channel: bool) -> int:
    n = _library().xla_order_sums_workspace_floats(B, C, H, W, int(per_channel))
    if n == 0:
        raise ValueError(f"xla_order_sums: the kernel does not take shape {(B, C, H, W)}")
    return n


def _stream_scratch(dev: torch.device):
    """(stream handle, its _StreamScratch) of dev's current stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch.get((dev.index, stream))
    if scratch is None:
        scratch = _scratch[(dev.index, stream)] = _StreamScratch(dev)
    return stream, scratch


def _call(dev: torch.device, fn, *args):
    """fn(*args) with dev current; raises on a CUDA error; counts the launch."""
    global launches
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"xla_order_sums kernel launch failed: CUDA error {err}")
    launches += 1


def _launch(x4: torch.Tensor, per_channel: bool, round_bf16: bool, shift, stats: bool = False):
    """The kernel on x4: (sum, sum of squares), or with `stats` the (mean,
    variance) the last block derives from them."""
    B, C, H, W = x4.shape
    dev = x4.device
    G = B * C if per_channel else B
    out = torch.empty((4 if stats else 2, G), dtype=torch.float32, device=dev)
    if G == 0:
        return out[-2], out[-1]
    x4 = x4.contiguous()
    shift_ptr = None
    if shift is not None:
        shift = shift.to(torch.float32).contiguous()
        shift_ptr = shift.data_ptr()
    stream, scratch = _stream_scratch(dev)
    args = (x4.data_ptr(), B, C, H, W, int(per_channel), int(round_bf16), shift_ptr, out[0].data_ptr(),
            out[1].data_ptr(), scratch.workspace_ptr(_workspace_floats(B, C, H, W, per_channel)),
            scratch.counter.data_ptr())
    n = x4[0].numel() // (C if per_channel else 1)
    inv = reciprocal_f32(n)
    args += ((inv, square_f32(inv), out[2].data_ptr(), out[3].data_ptr()) if stats else (0.0, 0.0, None, None))
    args += (stream,)
    _call(dev, _library().xla_order_sums_launch, *args)
    return out[-2], out[-1]


def _check(x: torch.Tensor, round_bf16: bool, shift) -> torch.Tensor:
    x4 = _as_nchw(x)
    if x4.dtype != torch.float32:
        raise ValueError(f"xla_order_sums: x is {x4.dtype}, not float32")
    if round_bf16 and shift is not None:
        raise ValueError("xla_order_sums: round_bf16 and shift do not go together")
    if torch.is_grad_enabled() and (x4.requires_grad or (shift is not None and shift.requires_grad)):
        raise RuntimeError("xla_order_sums has no gradient: call it under torch.no_grad() or "
                           "torch.inference_mode() (the bf16 LF-Net forward is inference only)")
    return x4


def xla_order_sums(x: torch.Tensor, per_channel: bool = False, round_bf16: bool = False,
                   shift: torch.Tensor | None = None):
    """(sum, sum of squares) of each group of x in XLA's order (module
    docstring), each [B] (or [B * C] with `per_channel`), f32.  x is f32
    [B, C, H, W] or [B, F]; `shift` is [G] f32 on x's device; `round_bf16`
    and `shift` do not go together.  CUDA tensors go to the kernel (or
    raise); CPU tensors to the plain version.  No gradient: an input that
    requires one while autograd records raises."""
    with annotate("bundletrack.sums"):
        x4 = _check(x, round_bf16, shift)
        G = x4.shape[0] * (x4.shape[1] if per_channel else 1)
        if shift is not None and (tuple(shift.shape) != (G,) or shift.device != x4.device):
            raise ValueError(f"xla_order_sums: shift must be [{G}] on {x4.device}, not "
                             f"{tuple(shift.shape)} on {shift.device}")
        if x4.device.type == "cpu":
            return xla_order_sums_reference(x4, per_channel, round_bf16, shift)
        return _launch(x4, per_channel, round_bf16, shift)


def xla_order_mean_var(x: torch.Tensor, round_bf16: bool = False):
    """(mean, variance) [B] of each sample of x (f32 [B, C, H, W] or [B, F])
    as jax.jit computes Flax GroupNorm(1)'s (`ops/numerics.xla_mean_var` of
    the sums in XLA's order).  On the card the kernel's last block derives
    them from its sums, with the device's fused multiply-add, in the same
    launch; on the CPU the plain sums go through `xla_mean_var`."""
    with annotate("bundletrack.sums"):
        x4 = _check(x, round_bf16, None)
        if x4.device.type == "cpu":
            return xla_mean_var(*xla_order_sums_reference(x4, False, round_bf16), x4[0].numel())
        return _launch(x4, False, round_bf16, None, stats=True)


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


@functools.lru_cache(maxsize=256)
def _instance_workspace_floats(shapes: tuple) -> int:
    flat = (ctypes.c_int * (4 * len(shapes)))(*[d for s in shapes for d in s])
    return _library().xla_order_instance_workspace_floats(len(shapes), flat)


def _launch_instance(maps):
    """The kernel's instance mode on maps (f32, contiguous, one device)."""
    dev = maps[0].device
    shapes = tuple(tuple(x.shape) for x in maps)
    groups = [B * C for B, C, _, _ in shapes]
    out = torch.empty((2, sum(groups)), dtype=torch.float32, device=dev)
    if sum(groups):
        n = len(maps)
        stream, scratch = _stream_scratch(dev)
        ws = scratch.workspace_ptr(_instance_workspace_floats(shapes))
        xs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in maps])
        flat = (ctypes.c_int * (4 * n))(*[d for s in shapes for d in s])
        invs = (ctypes.c_float * n)(*[reciprocal_f32(H * W) for _, _, H, W in shapes])
        _call(dev, _library().xla_order_instance_stats_launch, n, xs, flat, invs, out[0].data_ptr(),
              out[1].data_ptr(), ws, scratch.counter.data_ptr(), stream)
    means = [m.view(B, C) for m, (B, C, _, _) in zip(out[0].split(groups), shapes)]
    variances = [v.view(B, C) for v, (B, C, _, _) in zip(out[1].split(groups), shapes)]
    return means, variances


def xla_order_instance_stats(maps):
    """The instance norms' statistics of a ragged list of maps, each f32
    [B, C, H, W]: (means, variances), lists of [B, C] f32 tensors, as
    jax.jit computes detector_ops.instance_norm's (module docstring).  On
    the card all maps (at most MAX_MAPS, on one device) go through one
    launch; on the CPU through the plain version.  No gradient."""
    with annotate("bundletrack.sums"):
        maps = list(maps)
        if not maps:
            return [], []
        for x in maps:
            if x.dim() != 4 or x.dtype != torch.float32:
                raise ValueError(f"xla_order_instance_stats: a map is {x.dtype} {tuple(x.shape)}, not float32 "
                                 "[B, C, H, W]")
            _check(x, False, None)
        dev = maps[0].device
        if any(x.device != dev for x in maps):
            raise ValueError("xla_order_instance_stats: the maps lie on more than one device")
        if dev.type == "cpu":
            return xla_order_instance_stats_reference(maps)
        if len(maps) > MAX_MAPS:
            raise ValueError(f"xla_order_instance_stats: {len(maps)} maps, the kernel takes at most {MAX_MAPS}")
        return _launch_instance([x.contiguous() for x in maps])


def add_probe(n: int = 1 << 20, device=None):
    """(SM cycles per dependent f32 add, SM clock in GHz) on the card: one
    warp adds a chain of n f32 adds (the latency the chain bound assumes)."""
    dev = torch.device(device if device is not None else "cuda")
    out = torch.empty(32, dtype=torch.float32, device=dev)
    t = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _library().xla_order_sums_add_probe(n, out.data_ptr(), t.data_ptr(),
                                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"xla_order_sums add probe failed: CUDA error {err}")
    cycles, ns = (int(v) for v in t.cpu())
    return cycles / n, cycles / max(ns, 1)
