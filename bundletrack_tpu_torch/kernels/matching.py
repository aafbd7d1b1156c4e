"""Fused descriptor matching with geometric gating — the BA all-pairs matcher.

Counterpart of bundletrack_tpu/pallas_kernels/matching.py::fused_mutual_match.
`fused_mutual_match_pairs` reads a frame table [K,N,D] in place through
pair indices; it is what the main path calls.  `fused_mutual_match` keeps
the JAX function's signature (the two sides gathered as [P,N,D]) as a thin
adapter over it.  For a CUDA tensor the wrapper launches the hand-written
kernel in csrc/fused_mutual_match.cu (built with nvcc at first use, bound
with ctypes) or raises; it sends tensors on the CPU, and only those, to the
plain PyTorch version `fused_mutual_match_pairs_reference`.  Both compute,
per pair and A-keypoint, the gated descriptor argmin `best_b`, its
distance (1e30 when no column passes) and whether the match is mutual.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bundletrack_tpu_torch.kernels import build
from bundletrack_tpu_torch.utils.profiling import annotate

SOURCE = "fused_mutual_match.cu"
BIG = 1e30

# kernel launches made through the wrapper (the main path's proof of route)
launches = 0


@functools.lru_cache(maxsize=None)
def _thresholds(max_dist: float, max_normal_deg: float):
    """Gate thresholds as f32 values, rounded from double as the JAX kernel's
    compile-time constants are."""
    max_dist_sq = float(torch.tensor(float(max_dist) ** 2, dtype=torch.float32))
    cos_thresh = float(
        torch.tensor(math.cos(math.radians(float(max_normal_deg))), dtype=torch.float32)
    )
    return max_dist_sq, cos_thresh


def gated_distances(
    desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist: float, max_normal_deg: float
):
    """The [P, N, N] gated descriptor distances the matcher minimizes (BIG
    where the geometric gate fails), as the plain version computes them."""
    max_dist_sq, cos_thresh = _thresholds(max_dist, max_normal_deg)
    # invalid keypoints leave gate range: A side to +1e4, B side to -1e4,
    # so invalid-vs-invalid pairs are 2e4 apart too
    wa = torch.where(valid_a[..., None], wa.float(), torch.full_like(wa, 1e4, dtype=torch.float32))
    wb = torch.where(valid_b[..., None], wb.float(), torch.full_like(wb, -1e4, dtype=torch.float32))
    desc_a, desc_b, na, nb = desc_a.float(), desc_b.float(), na.float(), nb.float()
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
    return torch.where(gate, dist, torch.full_like(dist, BIG))


def fused_mutual_match_reference(
    desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist: float, max_normal_deg: float
):
    """Plain PyTorch version of `fused_mutual_match`, on any device.

    Same arguments and results as the adapter.  Materializes the [P,N,N]
    matrices the kernel never stores.
    """
    gated = gated_distances(desc_a, desc_b, wa, wb, na, nb, valid_a, valid_b, max_dist, max_normal_deg)
    row_min = torch.amin(gated, dim=-1)
    best_b = torch.argmin(gated, dim=-1)  # first index among equal values
    col_min = torch.amin(gated, dim=-2)
    has = row_min < BIG
    mutual = has & (row_min <= torch.gather(col_min, -1, best_b))
    return best_b.to(torch.int32), row_min, mutual


def fused_mutual_match_pairs_reference(
    desc, world, wnrm, valid, pair_i, pair_j, max_dist: float, max_normal_deg: float
):
    """Plain PyTorch version of `fused_mutual_match_pairs`, on any device:
    the gather of both sides, then `fused_mutual_match_reference`."""
    pi, pj = pair_i.long(), pair_j.long()
    return fused_mutual_match_reference(
        desc[pi], desc[pj], world[pi], world[pj], wnrm[pi], wnrm[pj], valid[pi], valid[pj],
        max_dist, max_normal_deg,
    )


def _check_table(desc, world, wnrm, valid, pair_i, pair_j):
    if desc.dim() != 3:
        raise ValueError(f"fused_mutual_match_pairs: desc has shape {tuple(desc.shape)}, not [K,N,D]")
    K, N, _ = desc.shape
    P = pair_i.shape[0] if pair_i.dim() == 1 else -1
    for name, t, shape in (
        ("world", world, (K, N, 3)), ("wnrm", wnrm, (K, N, 3)), ("valid", valid, (K, N)),
        ("pair_i", pair_i, (P,)), ("pair_j", pair_j, (P,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mutual_match_pairs: {name} has shape {tuple(t.shape)}, not {shape}")
        if t.device != desc.device:
            raise ValueError(f"fused_mutual_match_pairs: {name} is on {t.device}, not {desc.device}")
    for name, t in (("pair_i", pair_i), ("pair_j", pair_j)):
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise ValueError(f"fused_mutual_match_pairs: {name} is {t.dtype}, not an integer type")


@functools.lru_cache(maxsize=None)
def _library():
    """The built library with its C functions' signatures set, once."""
    lib = build.load(SOURCE)
    lib.fused_mutual_match_pairs_launch.restype = ctypes.c_int
    lib.fused_mutual_match_pairs_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5
    )
    lib.fused_mutual_match_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_mutual_match_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_mutual_match_max_dim.restype = ctypes.c_int
    return lib


def _launch(desc, world, wnrm, valid, pair_i, pair_j, max_dist_sq, cos_thresh):
    global launches
    K, N, D = desc.shape
    P = pair_i.shape[0]
    dev = desc.device
    lib = _library()
    if D > lib.fused_mutual_match_max_dim():
        raise ValueError(
            f"fused_mutual_match_pairs: the kernel takes D <= {lib.fused_mutual_match_max_dim()}, not {D}"
        )
    # no-ops for the main path's f32 / bool / int32 contiguous tensors
    desc, world, wnrm = (t.float().contiguous() for t in (desc, world, wnrm))
    valid = valid.to(torch.bool).contiguous()
    pair_i, pair_j = (t.to(torch.int32).contiguous() for t in (pair_i, pair_j))
    best_b = torch.empty((P, N), dtype=torch.int32, device=dev)
    dist = torch.empty((P, N), dtype=torch.float32, device=dev)
    mutual = torch.empty((P, N), dtype=torch.bool, device=dev)
    if P == 0 or N == 0:
        return best_b, dist, mutual
    workspace = torch.empty(
        lib.fused_mutual_match_workspace_bytes(K, N, D, P), dtype=torch.uint8, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_mutual_match_pairs_launch(
            desc.data_ptr(), world.data_ptr(), wnrm.data_ptr(), valid.data_ptr(),
            pair_i.data_ptr(), pair_j.data_ptr(), K, N, D, P, max_dist_sq, cos_thresh,
            best_b.data_ptr(), dist.data_ptr(), mutual.data_ptr(), workspace.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mutual_match_pairs kernel launch failed: CUDA error {err}")
    launches += 1
    return best_b, dist, mutual


def fused_mutual_match_pairs(
    desc,  # [K, N, D] descriptor table
    world,  # [K, N, 3] model-frame keypoint positions
    wnrm,  # [K, N, 3] model-frame normals
    valid,  # [K, N] bool
    pair_i,  # [P] int: A-side frame of each pair
    pair_j,  # [P] int: B-side frame of each pair
    max_dist: float,
    max_normal_deg: float,
):
    """Fused matching of frame pi against frame pj for every pair, reading
    the table in place: (best_b [P,N] int32, dist [P,N] f32, mutual [P,N] bool).

    Equal to `fused_mutual_match` on the gathered sides.  CUDA tensors go to
    the kernel (or raise); CPU tensors to the plain version.  A pair index
    outside [0, K) raises IndexError on the CPU and, since the card's copy
    is checked on the card, ends the launch with a CUDA error there.
    """
    with annotate("bundletrack.matcher"):
        _check_table(desc, world, wnrm, valid, pair_i, pair_j)
        if desc.device.type == "cpu":
            return fused_mutual_match_pairs_reference(
                desc, world, wnrm, valid, pair_i, pair_j, max_dist, max_normal_deg
            )
        return _launch(desc, world, wnrm, valid, pair_i, pair_j, *_thresholds(max_dist, max_normal_deg))


def fused_mutual_match(
    desc_a, desc_b,  # [P, N, D]
    wa, wb,  # [P, N, 3] model-frame keypoint positions
    na, nb,  # [P, N, 3] model-frame normals
    valid_a, valid_b,  # [P, N] bool
    max_dist: float,
    max_normal_deg: float,
):
    """Batched fused matching with the JAX function's signature:
    (best_b [P,N] int32, dist [P,N] f32, mutual [P,N] bool).

    An adapter over `fused_mutual_match_pairs`: the table is both sides
    stacked, and pair p matches frame p against frame P + p.
    """
    P = desc_a.shape[0]
    first = torch.arange(P, dtype=torch.int32, device=desc_a.device)
    return fused_mutual_match_pairs(
        torch.cat([desc_a, desc_b]), torch.cat([wa, wb]), torch.cat([na, nb]),
        torch.cat([valid_a, valid_b]), first, first + P, max_dist, max_normal_deg,
    )
