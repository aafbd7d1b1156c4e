"""Dense point-to-plane term with projective association.

Counterpart of bundletrack_tpu/solver/dense_p2p.py (reference:
src/cuda/Solver/SolverBundling.cu FindDenseCorrespondences_Kernel,
WeightDenseCorrespondences_Kernel, BuildDenseSystem_Kernel; low-res cache
src/cuda/CUDACache.cpp:76-88).

Each frame is compacted once, when it is preprocessed: up to C valid
low-res source pixels (evenly decimated) as [6, C] planes, plus an [H, W, 8]
bf16 gather table (z_hi, z_lo, nx, ny, nz, valid, 0, 0) whose hi/lo pair
recombines to f32 depth.  The layout is the JAX package's, so the dense
term compares entry for entry.  One direction per pair: source = j,
target = i.  The photometric term (w_dense_color > 0) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bundletrack_tpu_torch.geometry.robust import huber
from bundletrack_tpu_torch.geometry.se3 import se3_inverse
from bundletrack_tpu_torch.ops.numerics import cos_deg_f32
from bundletrack_tpu_torch.solver.residuals import scatter_blocks


class FrameDense(NamedTuple):
    """Solve-ready dense-term data for ONE frame, built when it is preprocessed.

    src:   [6, C] f32 planes (sx, sy, sz, snx, sny, snz)
    valid: [C] bool
    lin:   [C] int32 original linear pixel index
    tchan: [H, W, 8] bf16 gather table (z_hi, z_lo, nx, ny, nz, valid, 0, 0)
    """

    src: torch.Tensor
    valid: torch.Tensor
    lin: torch.Tensor
    tchan: torch.Tensor


class CompactDense(NamedTuple):
    """Dense-term inputs of a K-frame solve: src [..., 6, K, C], src_valid
    [..., K, C], src_lin [..., K, C], tchan [..., K, H, W, 8] bf16; the
    leading axes are the fleet's streams."""

    src: torch.Tensor
    src_valid: torch.Tensor
    src_lin: torch.Tensor
    tchan: torch.Tensor


def compact_frame(points, normals, valid, capacity: int) -> FrameDense:
    """Frame compaction + gather-table packing (see FrameDense); leading
    batch axes (streams) compact each frame on its own."""
    Hh, Ww = valid.shape[-2:]
    batch = valid.shape[:-2]
    N = Hh * Ww
    C = min(N, capacity)
    dev = valid.device

    val = valid.reshape(-1, N)
    B = val.shape[0]
    cnt = torch.cumsum(val.to(torch.int64), -1)
    count = cnt[:, -1:]
    # pixel index of each rank among valid pixels (ranks are unique)
    idx_by_rank = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    slot = torch.where(val, cnt - 1, torch.full_like(cnt, N))
    idx_by_rank.scatter_(1, slot, torch.arange(N, device=dev).expand(B, N))
    c = torch.arange(C, device=dev)
    sel_rank = torch.where(count > C, (c * count) // C, c)
    sel_idx = torch.gather(idx_by_rank, 1, torch.clamp(sel_rank, max=N - 1))
    sel_valid = c < torch.clamp(count, max=C)

    take = sel_idx[..., None].expand(B, C, 3)
    pf = torch.gather(points.reshape(B, N, 3), 1, take)
    nf = torch.gather(normals.reshape(B, N, 3), 1, take)
    zero = torch.where(sel_valid, 1.0, 0.0)
    src = torch.cat([pf, nf], dim=-1).transpose(1, 2) * zero[:, None]

    z = torch.where(valid, points[..., 2], torch.zeros_like(points[..., 2]))
    z_hi = z.to(torch.bfloat16)
    z_lo = (z - z_hi.to(torch.float32)).to(torch.bfloat16)
    tchan = torch.stack(
        [
            z_hi, z_lo,
            normals[..., 0].to(torch.bfloat16),
            normals[..., 1].to(torch.bfloat16),
            normals[..., 2].to(torch.bfloat16),
            valid.to(torch.bfloat16),
            torch.zeros_like(z_hi), torch.zeros_like(z_hi),
        ],
        dim=-1,
    )
    return FrameDense(
        src=src.reshape(*batch, 6, C),
        valid=sel_valid.reshape(*batch, C),
        lin=sel_idx.to(torch.int32).reshape(*batch, C),
        tchan=tchan,
    )


def stack_frame_dense(src, valid, lin, tchan) -> CompactDense:
    """Assemble per-frame [..., K, 6, C] stacks into the solver's CompactDense."""
    return CompactDense(src=src.transpose(-3, -2), src_valid=valid, src_lin=lin, tchan=tchan)


def _rot_apply(R, x, y, z, row):
    """Row `row` of [..., P, 3, 3] rotations applied to [..., P, C] component planes."""
    return R[..., row, 0, None] * x + R[..., row, 1, None] * y + R[..., row, 2, None] * z


def dense_p2p_from_compact(
    poses: torch.Tensor,  # [..., K, 4, 4] cam->model
    cd: CompactDense,
    frame_valid: torch.Tensor,  # [..., K] bool
    pair_i: torch.Tensor,  # [P], shared by the batch
    pair_j: torch.Tensor,  # [P]
    K_lowres: torch.Tensor,  # [..., 3, 3]
    *,
    max_dist: float = 0.02,
    max_normal_deg: float = 45.0,
    robust_delta: float = 0.005,
    min_pair_pixels: int = 800,
    weight: float = 1.0,
):
    """Dense point-to-plane H/g over pairs: src = j projected into tgt = i
    via inv(T_i) T_j (reference SolverBundling.cu:73).

    Returns (H [...,K,K,6,6], g [...,K,6], cost [...], per-pair
    correspondence counts [...,P]).
    """
    Kf, Hh, Ww = cd.tchan.shape[-4:-1]
    batch = cd.tchan.shape[:-4]
    N = Hh * Ww
    cos_max = cos_deg_f32(max_normal_deg)

    src, tgt = pair_j, pair_i
    pair_ok = frame_valid[..., src] & frame_valid[..., tgt]
    T_src = poses[..., src, :, :]
    T_tgt = poses[..., tgt, :, :]
    T_rel = se3_inverse(T_tgt) @ T_src  # cam_src -> cam_tgt
    Rr, tr = T_rel[..., :3, :3], T_rel[..., :3, 3]

    sx, sy, sz, snx, sny, snz = cd.src[..., src, :].unbind(-3)  # 6 x [..., P, C]
    ok_src = cd.src_valid[..., src, :] & pair_ok[..., None]

    ax = _rot_apply(Rr, sx, sy, sz, 0) + tr[..., 0, None]
    ay = _rot_apply(Rr, sx, sy, sz, 1) + tr[..., 1, None]
    az = _rot_apply(Rr, sx, sy, sz, 2) + tr[..., 2, None]
    fx, fy = K_lowres[..., 0, 0, None, None], K_lowres[..., 1, 1, None, None]
    cx, cy = K_lowres[..., 0, 2, None, None], K_lowres[..., 1, 2, None, None]
    safe_z = torch.where(az > 1e-6, az, torch.ones_like(az))
    u = ax / safe_z * fx + cx
    v = ay / safe_z * fy + cy
    # saturate before the integer cast: a float beyond int32 range has no
    # defined conversion in torch, and the bounds test only needs the sign
    lim = float(1 << 30)
    ui = torch.round(torch.clamp(u, -lim, lim)).to(torch.int64)
    vi = torch.round(torch.clamp(v, -lim, lim)).to(torch.int64)
    inb = (ui >= 0) & (ui < Ww) & (vi >= 0) & (vi < Hh) & (az > 1e-6)
    uic = torch.clamp(ui, 0, Ww - 1)
    vic = torch.clamp(vi, 0, Hh - 1)
    lin = vic * Ww + uic

    # one narrow bf16 gather per associated pixel; the target point is
    # rebuilt from (u, v, z) instead of gathered
    B = math.prod(batch)
    at = tgt[:, None] * N + lin
    if B > 1:  # each stream's table follows the previous one's
        at = at + (torch.arange(B, device=at.device) * (Kf * N)).reshape(*batch, 1, 1)
    gat = cd.tchan.reshape(B * Kf * N, 8)[at].to(torch.float32)  # [..., P, C, 8]
    tz = gat[..., 0] + gat[..., 1]
    tnx, tny, tnz = gat[..., 2], gat[..., 3], gat[..., 4]
    v_tgt = gat[..., 5] > 0.5
    tx = (uic.to(torch.float32) - cx) / fx * tz
    ty = (vic.to(torch.float32) - cy) / fy * tz

    d2 = (tx - ax) ** 2 + (ty - ay) ** 2 + (tz - az) ** 2
    rnx = _rot_apply(Rr, snx, sny, snz, 0)
    rny = _rot_apply(Rr, snx, sny, snz, 1)
    rnz = _rot_apply(Rr, snx, sny, snz, 2)
    cos_sn = rnx * tnx + rny * tny + rnz * tnz
    ok = inb & v_tgt & ok_src & (d2 < max_dist * max_dist) & (cos_sn > cos_max)

    Rs, ts = T_src[..., :3, :3], T_src[..., :3, 3]
    Rt, tt = T_tgt[..., :3, :3], T_tgt[..., :3, 3]
    qsx = _rot_apply(Rs, sx, sy, sz, 0) + ts[..., 0, None]
    qsy = _rot_apply(Rs, sx, sy, sz, 1) + ts[..., 1, None]
    qsz = _rot_apply(Rs, sx, sy, sz, 2) + ts[..., 2, None]
    qtx = _rot_apply(Rt, tx, ty, tz, 0) + tt[..., 0, None]
    qty = _rot_apply(Rt, tx, ty, tz, 1) + tt[..., 1, None]
    qtz = _rot_apply(Rt, tx, ty, tz, 2) + tt[..., 2, None]
    nmx = _rot_apply(Rt, tnx, tny, tnz, 0)
    nmy = _rot_apply(Rt, tnx, tny, tnz, 1)
    nmz = _rot_apply(Rt, tnx, tny, tnz, 2)
    dqx, dqy, dqz = qtx - qsx, qty - qsy, qtz - qsz
    r = dqx * nmx + dqy * nmy + dqz * nmz  # [..., P, C]

    rho0, rho1 = huber(r * r, robust_delta)
    okf = ok.to(r.dtype)
    n_corr = torch.sum(ok, dim=-1)
    pair_w = torch.where(
        n_corr >= min_pair_pixels,
        1.0 / torch.clamp(torch.log(torch.clamp(n_corr.to(r.dtype), min=2.0)), max=9.0),
        torch.zeros((), dtype=r.dtype, device=r.device),
    )
    w = rho1 * okf * pair_w[..., None]

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])

    nm = (nmx, nmy, nmz)
    c1 = cross((qsx, qsy, qsz), nm)
    c2 = cross((qtx, qty, qtz), nm)
    c3 = cross(nm, (dqx, dqy, dqz))
    # J_src = [-n | -(q_src x n)],  J_tgt = [n | (q_tgt x n) + (n x dq)]
    Jsrc = torch.stack([-nmx, -nmy, -nmz, -c1[0], -c1[1], -c1[2]], dim=-2)  # [..., P, 6, C]
    Jtgt = torch.stack([nmx, nmy, nmz, c2[0] + c3[0], c2[1] + c3[1], c2[2] + c3[2]], dim=-2)

    Hss = torch.einsum("...ac,...c,...bc->...ab", Jsrc, w, Jsrc)
    Htt = torch.einsum("...ac,...c,...bc->...ab", Jtgt, w, Jtgt)
    Hst = torch.einsum("...ac,...c,...bc->...ab", Jsrc, w, Jtgt)
    gs = torch.einsum("...ac,...c,...c->...a", Jsrc, w, r)
    gt = torch.einsum("...ac,...c,...c->...a", Jtgt, w, r)

    H, g = scatter_blocks(Kf, src, tgt, Hss, Htt, Hst, gs, gt)
    cost = torch.sum(rho0 * okf * pair_w[..., None], dim=(-2, -1)) * weight
    return H * weight, g * weight, cost, n_corr

