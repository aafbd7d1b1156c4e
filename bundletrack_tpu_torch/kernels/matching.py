"""Fused descriptor matching with geometric gating — the BA all-pairs matcher.

Counterpart of bundletrack_tpu/pallas_kernels/matching.py::fused_mutual_match.
For a CUDA tensor the wrapper launches the hand-written kernel in
csrc/fused_mutual_match.cu (built with nvcc at first use, bound with ctypes)
or raises; it sends tensors on the CPU, and only those, to the plain PyTorch
version `fused_mutual_match_reference`.  Both compute, per pair and A-keypoint, the gated
descriptor argmin `best_b`, its distance (1e30 when no column passes) and
whether the match is mutual.
"""

from __future__ import annotations

import ctypes
import math

import torch

from bundletrack_tpu_torch.kernels import build

SOURCE = "fused_mutual_match.cu"
BIG = 1e30

# kernel launches made through the wrapper (the main path's proof of route)
launches = 0


def _thresholds(max_dist: float, max_normal_deg: float):
    """Gate thresholds as f32 values, rounded from double as the JAX kernel's
    compile-time constants are."""
    max_dist_sq = float(torch.tensor(float(max_dist) ** 2, dtype=torch.float32))
    cos_thresh = float(
        torch.tensor(math.cos(math.radians(float(max_normal_deg))), dtype=torch.float32)
    )
    return max_dist_sq, cos_thresh


def _move_invalid(wa, wb, valid_a, valid_b):
    """Move invalid keypoints out of gate range: A-side to +1e4, B-side to
    -1e4, so invalid-vs-invalid pairs are 2e4 apart too."""
    wa = torch.where(valid_a[..., None], wa.float(), torch.full_like(wa, 1e4, dtype=torch.float32))
    wb = torch.where(valid_b[..., None], wb.float(), torch.full_like(wb, -1e4, dtype=torch.float32))
    return wa, wb


def _prepare(desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist, max_normal_deg):
    """The kernel's operands: contiguous f32 tensors with the invalid
    keypoints moved, then the two f32 gate thresholds."""
    wa, wb = _move_invalid(wa, wb, valid_a, valid_b)
    return (
        desc_a.float().contiguous(), desc_b.float().contiguous(),
        wa.contiguous(), wb.contiguous(),
        na.float().contiguous(), nb.float().contiguous(),
        *_thresholds(max_dist, max_normal_deg),
    )


def fused_mutual_match_reference(
    desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist: float, max_normal_deg: float
):
    """Plain PyTorch version of `fused_mutual_match`, on any device.

    Same arguments and results as the wrapper.  Materializes the [P,N,N]
    matrices the kernel never stores.
    """
    desc_a, desc_b, wa, wb, na, nb, max_dist_sq, cos_thresh = _prepare(
        desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist, max_normal_deg
    )
    a = desc_a.to(torch.bfloat16).to(torch.float32)
    b = desc_b.to(torch.bfloat16).to(torch.float32)
    sim = a @ b.transpose(-1, -2)
    na2 = torch.sum(desc_a * desc_a, dim=-1)
    nb2 = torch.sum(desc_b * desc_b, dim=-1)
    dist = na2[:, :, None] + nb2[:, None, :] - 2.0 * sim
    # exact f32 (a-b)^2, summed in the kernel's order
    d2 = (wa[:, :, None, 0] - wb[:, None, :, 0]) ** 2
    d2 = d2 + (wa[:, :, None, 1] - wb[:, None, :, 1]) ** 2
    d2 = d2 + (wa[:, :, None, 2] - wb[:, None, :, 2]) ** 2
    cos = na[:, :, None, 0] * nb[:, None, :, 0]
    cos = cos + na[:, :, None, 1] * nb[:, None, :, 1]
    cos = cos + na[:, :, None, 2] * nb[:, None, :, 2]
    gate = (d2 < max_dist_sq) & (cos > cos_thresh)
    gated = torch.where(gate, dist, torch.full_like(dist, BIG))
    row_min = torch.amin(gated, dim=-1)
    best_b = torch.argmin(gated, dim=-1)  # first index among equal values
    col_min = torch.amin(gated, dim=-2)
    has = row_min < BIG
    mutual = has & (row_min <= torch.gather(col_min, -1, best_b))
    return best_b.to(torch.int32), row_min, mutual


def _launch(desc_a, desc_b, wa, wb, na, nb, max_dist_sq, cos_thresh):
    global launches
    P, N, D = desc_a.shape
    for name, t, shape in (
        ("desc_a", desc_a, (P, N, D)), ("desc_b", desc_b, (P, N, D)),
        ("wa", wa, (P, N, 3)), ("wb", wb, (P, N, 3)),
        ("na", na, (P, N, 3)), ("nb", nb, (P, N, 3)),
    ):
        if t.device != desc_a.device or not t.is_cuda:
            raise ValueError(f"fused_mutual_match: {name} is on {t.device}, not {desc_a.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_mutual_match: {name} is {t.dtype}, not float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mutual_match: {name} has shape {tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mutual_match: {name} is not contiguous")
    lib = build.load(SOURCE)
    fn = lib.fused_mutual_match_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2
        + [ctypes.c_void_p] * 5
    )
    lib.fused_mutual_match_row_tile.restype = ctypes.c_int
    tile = lib.fused_mutual_match_row_tile()
    dev = desc_a.device
    best_b = torch.empty((P, N), dtype=torch.int32, device=dev)
    dist = torch.empty((P, N), dtype=torch.float32, device=dev)
    mutual = torch.empty((P, N), dtype=torch.bool, device=dev)
    scratch = torch.empty((P, -(-N // tile), N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            desc_a.data_ptr(), desc_b.data_ptr(), wa.data_ptr(), wb.data_ptr(),
            na.data_ptr(), nb.data_ptr(), P, N, D, max_dist_sq, cos_thresh,
            best_b.data_ptr(), dist.data_ptr(), mutual.data_ptr(), scratch.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mutual_match kernel launch failed: CUDA error {err}")
    launches += 1
    return best_b, dist, mutual


def fused_mutual_match(
    desc_a, desc_b,  # [P, N, D]
    wa, wb,  # [P, N, 3] model-frame keypoint positions
    na, nb,  # [P, N, 3] model-frame normals
    valid_a, valid_b,  # [P, N] bool
    max_dist: float,
    max_normal_deg: float,
):
    """Batched fused matching: (best_b [P,N] int32, dist [P,N] f32, mutual [P,N] bool).

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain version.
    """
    args = (desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist, max_normal_deg)
    if desc_a.device.type == "cpu":
        return fused_mutual_match_reference(*args)
    return _launch(*_prepare(*args))
