"""The Gauss-Newton normal equations' pair blocks summed in a fixed order.

`scatter_blocks` adds per-pair blocks Hii, Hjj, Hij [..., P, 6, 6] and gi,
gj [..., P, 6] into the block matrix H [..., K, K, 6, 6] and the vector g
[..., K, 6] over a pair graph (pair_i, pair_j [P], shared by the batch;
each batch entry sums its own pairs): Hii at (i, i), Hjj at (j, j), Hij at
(i, j) and its transpose at (j, i); gi at i, gj at j.  The sparse term,
the dense point-to-plane term and the colour term build their normal
equations with it (solver/residuals.py, solver/dense_p2p.py).

Each output entry adds its terms from +0.0 in one order: every pair's Hii
in pair order, then every Hjj, then every Hij, then every Hij transposed;
for g every gi, then every gj.  That is the order of the plain version
`scatter_blocks_reference` (two index_add_ over the blocks concatenated in
that order, which the CPU adds in index order), and it gives what jax.jit
of the JAX package's scatter_blocks gives, bit for bit
(tests/test_torch_normal_blocks.py).  On the card index_add_ adds with
atomics in an order that changes from run to run; for a CUDA tensor the
wrapper instead makes ONE launch of the kernel in csrc/normal_blocks.cu
(built with nvcc at first use, bound with ctypes; one block per 6x6 output
block lists its terms once with warp ballots and adds them from shared
memory), which adds each entry's terms in the same order, or raises: no
fallback.  Tensors on the CPU, and
only those, go to the plain version.  No gradient: an input that requires
one while autograd records raises (the solver needs none).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bundletrack_tpu_torch.kernels import build

SOURCE = "normal_blocks.cu"

# kernel launches made through the wrapper (the main path's proof of route)
launches = 0


def flat_rows(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """The plain version's index_add_ operands: (the flat H row
    (b*K + row)*K + col of each block, the blocks [4BP, 36], the flat g row
    of each vector, the vectors [2BP, 6]), each in the order of the kinds."""
    B = math.prod(Hii.shape[:-3])
    blk = torch.cat([pair_i * (K + 1), pair_j * (K + 1), pair_i * K + pair_j, pair_j * K + pair_i])
    row = torch.cat([pair_i, pair_j])
    if B > 1:
        first = torch.arange(B, device=Hii.device)[:, None]
        blk = (first * (K * K) + blk).reshape(-1)
        row = (first * K + row).reshape(-1)
    vals = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)], dim=-3).reshape(-1, 36)
    return blk, vals, row, torch.cat([gi, gj], dim=-2).reshape(-1, 6)


def scatter_blocks_reference(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """Plain version of `scatter_blocks`: one index_add_ per output over the
    flat rows (`flat_rows`), which the CPU adds in index order."""
    batch = Hii.shape[:-3]
    B = math.prod(batch)
    blk, vals, row, gvals = flat_rows(K, pair_i, pair_j, Hii, Hjj, Hij, gi, gj)
    H = torch.zeros((B * K * K, 36), dtype=Hii.dtype, device=Hii.device).index_add_(0, blk, vals)
    g = torch.zeros((B * K, 6), dtype=gi.dtype, device=gi.device).index_add_(0, row, gvals)
    return H.reshape(*batch, K, K, 6, 6), g.reshape(*batch, K, 6)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library with its C function's signature set, once."""
    lib = build.load(SOURCE)
    lib.normal_blocks_launch.restype = ctypes.c_int
    lib.normal_blocks_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
    return lib


def _launch(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """The kernel on card tensors already checked: (H, g)."""
    global launches
    batch = Hii.shape[:-3]
    B, P = math.prod(batch), Hii.shape[-3]
    dev = Hii.device
    # two allocations: on the card's host one allocation split into two
    # views took longer (blocks_bench's host line)
    H = torch.empty((*batch, K, K, 6, 6), dtype=torch.float32, device=dev)
    g = torch.empty((*batch, K, 6), dtype=torch.float32, device=dev)
    if H.numel() == 0:
        return H, g
    # the raw handle of PyTorch's current stream on the device (what
    # torch.cuda.current_stream(dev).cuda_stream gives, without building a
    # Stream object; Triton's launcher reads it the same way)
    args = (B, K, P, pair_i.data_ptr(), pair_j.data_ptr(), Hii.data_ptr(), Hjj.data_ptr(), Hij.data_ptr(),
            gi.data_ptr(), gj.data_ptr(), H.data_ptr(), g.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = _library().normal_blocks_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = _library().normal_blocks_launch(*args)
    if err != 0:
        raise RuntimeError(f"normal_blocks kernel launch failed: CUDA error {err}")
    launches += 1
    return H, g


def _index(t):
    """`t` as the kernel takes pair indices: int64, contiguous."""
    return t if t.dtype == torch.int64 and t.is_contiguous() else t.to(torch.int64).contiguous()


def scatter_blocks(K: int, pair_i, pair_j, Hii, Hjj, Hij, gi, gj):
    """H [..., K, K, 6, 6] and g [..., K, 6] from the per-pair blocks
    (module docstring).  CUDA tensors go to the kernel (f32, one launch, or
    raise); CPU tensors to the plain version."""
    tensors = (Hii, Hjj, Hij, gi, gj)
    if torch.is_grad_enabled() and (Hii.requires_grad or Hjj.requires_grad or Hij.requires_grad
                                    or gi.requires_grad or gj.requires_grad):
        raise RuntimeError("scatter_blocks has no gradient: call it under torch.no_grad() or "
                           "torch.inference_mode() (the Gauss-Newton solve needs none)")
    hs = Hii.shape
    if (pair_i.dim() != 1 or pair_j.shape != pair_i.shape or hs[-3:] != (pair_i.shape[0], 6, 6)
            or Hjj.shape != hs or Hij.shape != hs or gi.shape != hs[:-1] or gj.shape != hs[:-1]):
        raise ValueError(f"scatter_blocks: pairs {tuple(pair_i.shape)} {tuple(pair_j.shape)} and blocks "
                         f"{[tuple(t.shape) for t in tensors]} are not [P] and [..., P, 6, 6] / [..., P, 6]")
    dev = Hii.device
    if not dev == pair_i.device == pair_j.device == Hjj.device == Hij.device == gi.device == gj.device:
        raise ValueError("scatter_blocks: the pairs and blocks lie on more than one device")
    if dev.type == "cpu":
        return scatter_blocks_reference(K, pair_i, pair_j, Hii, Hjj, Hij, gi, gj)
    f32 = torch.float32
    if Hii.dtype is not f32 or Hjj.dtype is not f32 or Hij.dtype is not f32 or gi.dtype is not f32 \
            or gj.dtype is not f32:
        raise ValueError(f"scatter_blocks: the kernel takes float32 blocks, not {[t.dtype for t in tensors]}")
    return _launch(K, _index(pair_i), _index(pair_j), *(t.contiguous() for t in tensors))
