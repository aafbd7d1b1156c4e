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
target = i.  A standalone solve compacts its DenseFrames once
(`compact_dense_frames`); with intensity and gradients it also packs an
[H, W, 4] f32 colour table for the photometric term (weight_color > 0).
The tracker's keyframe tables carry no intensity, so inside the tracker,
as in the JAX tracker, the photometric term is never computed.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from trackbench.reference.geometry.robust import huber
from trackbench.reference.geometry.se3 import se3_inverse
from trackbench.reference.ops.numerics import cos_deg_f32
from trackbench.reference.solver.residuals import scatter_blocks


class DenseFrames(NamedTuple):
    """Low-res per-frame geometry of a standalone solve (reference
    CUDACachedFrame): points and normals [K, H, W, 3], valid [K, H, W]
    bool, and for the photometric term intensity, grad_x, grad_y [K, H, W]
    (ops/intensity.intensity_gradients)."""

    points: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor
    intensity: Optional[torch.Tensor] = None
    grad_x: Optional[torch.Tensor] = None
    grad_y: Optional[torch.Tensor] = None


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
    leading axes are the fleet's streams.  cchan [..., K, H, W, 4] f32
    (intensity, grad_x, grad_y, 0) feeds the photometric term, None
    without one."""

    src: torch.Tensor
    src_valid: torch.Tensor
    src_lin: torch.Tensor
    tchan: torch.Tensor
    cchan: Optional[torch.Tensor] = None


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


def compact_dense_frames(frames: DenseFrames, capacity: Optional[int] = None,
                         with_color: bool = False) -> CompactDense:
    """Up to `capacity` (default 4096) valid pixels per frame, evenly
    decimated over the valid set as compact_frame takes them, and the
    gather tables; with `with_color` and intensity given, the colour table
    too.  Runs once per standalone solve."""
    fd = compact_frame(frames.points, frames.normals, frames.valid, capacity or 4096)
    cchan = None
    if with_color and frames.intensity is not None:
        cchan = torch.stack(
            [frames.intensity, frames.grad_x, frames.grad_y, torch.zeros_like(frames.intensity)], dim=-1
        ).to(torch.float32)
    return stack_frame_dense(fd.src, fd.valid, fd.lin, fd.tchan)._replace(cchan=cchan)


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
    weight_color: float = 0.0,
    robust_delta_color: float = 0.1,
):
    """Dense point-to-plane H/g over pairs: src = j projected into tgt = i
    via inv(T_i) T_j (reference SolverBundling.cu:73); with weight_color > 0
    and a colour table (cd.cchan), the photometric term on the same
    associations.

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

    def rows(idx):
        """Row of each [..., P, C] pixel index in the flat [B*K*N] tables:
        each stream's table follows the previous one's."""
        if B == 1:
            return idx
        return idx + (torch.arange(B, device=idx.device) * (Kf * N)).reshape(*batch, 1, 1)

    gat = cd.tchan.reshape(B * Kf * N, 8)[rows(tgt[:, None] * N + lin)].to(torch.float32)  # [..., P, C, 8]
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
    H, g = H * weight, g * weight

    # ---- photometric term (reference SolverBundling.cu:199-227) ----------
    # r_c = I_tgt(pi(p')) - I_src(p), the target read bilinearly; the
    # Jacobian chains the image gradient through the projection:
    # J_src = [a | q_src x a] with a = R_tgt (J_pi^T grad), J_tgt = -J_src
    if weight_color > 0.0 and cd.cchan is not None:
        cflat = cd.cchan.reshape(B * Kf * N, 4)
        i_src = cflat[rows(src[:, None] * N + cd.src_lin[..., src, :].long()), 0]
        u0 = torch.clamp(torch.floor(torch.clamp(u, -lim, lim)).to(torch.int64), 0, Ww - 2)
        v0 = torch.clamp(torch.floor(torch.clamp(v, -lim, lim)).to(torch.int64), 0, Hh - 2)
        du = torch.clamp(u - u0.to(u.dtype), 0.0, 1.0)
        dv = torch.clamp(v - v0.to(v.dtype), 0.0, 1.0)
        l00 = rows(tgt[:, None] * N + v0 * Ww + u0)

        def tap(off):
            return cflat[l00 + off]

        w00 = ((1 - du) * (1 - dv))[..., None]
        w01 = (du * (1 - dv))[..., None]
        w10 = ((1 - du) * dv)[..., None]
        w11 = (du * dv)[..., None]
        cbil = tap(0) * w00 + tap(1) * w01 + tap(Ww) * w10 + tap(Ww + 1) * w11
        i_tgt, gx, gy = cbil[..., 0], cbil[..., 1], cbil[..., 2]
        r_c = i_tgt - i_src
        acx = fx / safe_z * gx
        acy = fy / safe_z * gy
        acz = -(fx * ax * gx + fy * ay * gy) / (safe_z * safe_z)
        am = tuple(_rot_apply(Rt, acx, acy, acz, row) for row in range(3))
        cc = cross((qsx, qsy, qsz), am)
        Jc = torch.stack([*am, *cc], dim=-2)  # [..., P, 6, C]
        rho0c, rho1c = huber(r_c * r_c, robust_delta_color)
        wc = rho1c * okf * pair_w[..., None] * weight_color
        Hcc = torch.einsum("...ac,...c,...bc->...ab", Jc, wc, Jc)
        gc = torch.einsum("...ac,...c,...c->...a", Jc, wc, r_c)
        # J_tgt = -J_src: Hss += Hcc, Htt += Hcc, Hst -= Hcc, gs += gc, gt -= gc
        Hc, gcv = scatter_blocks(Kf, src, tgt, Hcc, Hcc, -Hcc, gc, -gc)
        H, g = H + Hc, g + gcv
        cost = cost + torch.sum(rho0c * okf * pair_w[..., None], dim=(-2, -1)) * weight_color
    return H, g, cost, n_corr


def dense_p2p_normal_equations(poses, frames: DenseFrames, frame_valid, pair_i, pair_j, K_lowres, *,
                               max_dist: float = 0.02, max_normal_deg: float = 45.0,
                               robust_delta: float = 0.005, min_pair_pixels: int = 800,
                               weight: float = 1.0, weight_color: float = 0.0,
                               robust_delta_color: float = 0.1, src_capacity: Optional[int] = None):
    """Compact, then evaluate: the one-shot form.  Inside a GN loop,
    compact_dense_frames runs once and dense_p2p_from_compact per
    iteration (solver/gauss_newton.py)."""
    cd = compact_dense_frames(frames, capacity=src_capacity, with_color=weight_color > 0.0)
    return dense_p2p_from_compact(
        poses, cd, frame_valid, pair_i, pair_j, K_lowres,
        max_dist=max_dist, max_normal_deg=max_normal_deg, robust_delta=robust_delta,
        min_pair_pixels=min_pair_pixels, weight=weight, weight_color=weight_color,
        robust_delta_color=robust_delta_color,
    )

