"""Huber-robust Gauss-Newton over the keyframe pose graph.

Counterpart of bundletrack_tpu/solver/gauss_newton.py (reference:
src/cuda/Solver/SolverBundling.cu solveBundlingStub).  At <= 16 frames the
normal equations are a 96x96 system: the dense blocked H is formed and
solved by an equilibrated, Levenberg-damped Cholesky (solver_backend
"cholesky"), or by num_iter_inner block-Jacobi PCG steps ("pcg",
solver/pcg.py, the reference's own inner solver).  Frames with
free_mask=False keep their pose (gauge fixing).  Leading axes batch
independent graphs: the fleet solves every stream's graph at once, with
batched Cholesky factorizations of [S, 6K, 6K].  Without early stopping
the loop runs num_iter_outer iterations and makes no device-to-host read.

`group`: the process group of the mesh axis that shards the correspondence
PAIRS (parallel/pair_sharded.py, the tracker with bundle.ba_mesh_axis).
Each rank linearizes its own pairs, sparse and dense terms alike, and H, g
and the cost are summed over the group once per GN iteration (the JAX
package's psum); every rank then solves the same system, so the loop stays
in lockstep.  The verification statistics are summed (counts) and maxed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bundletrack_tpu_torch.geometry.se3 import se3_update_left
from bundletrack_tpu_torch.ops.collectives import MAX, all_reduce
from bundletrack_tpu_torch.solver.dense_p2p import (
    CompactDense,
    DenseFrames,
    compact_dense_frames,
    dense_p2p_from_compact,
)
from bundletrack_tpu_torch.solver.pcg import solve_normal_equations_pcg
from bundletrack_tpu_torch.solver.residuals import (
    SparseCorres,
    sparse_normal_equations,
    sparse_residuals,
)
from bundletrack_tpu_torch.utils.profiling import annotate, count, read


class GraphInputs(NamedTuple):
    """Everything the optimizer needs for one BA solve."""

    poses: torch.Tensor  # [..., K, 4, 4] cam->model initial estimates
    frame_valid: torch.Tensor  # [..., K] bool
    free_mask: torch.Tensor  # [..., K] bool — False = gauge-fixed
    corres: SparseCorres
    dense_compact: Optional[CompactDense] = None  # the tracker's tables, or `dense` compacted
    K_lowres: Optional[torch.Tensor] = None
    dense: Optional[DenseFrames] = None  # a standalone solve's frames, compacted once per solve


def _apply_gauge(H, g, free):
    """Zero rows/cols of fixed frames and put identity on their diagonal."""
    K = H.shape[-3]
    f = free.to(H.dtype)
    H = H * f[..., :, None, None, None] * f[..., None, :, None, None]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.eye(K, dtype=H.dtype, device=H.device)[:, :, None, None] * eye6
    return H + diag * (1.0 - f)[..., :, None, None, None], g * f[..., None]


def solve_normal_equations_cholesky(H, g, lm_lambda: float):
    """Solve (H + lambda I) delta = -g for blocked H [..., K, K, 6, 6],
    g [..., K, 6]; the leading axes batch independent systems.

    Jacobi-equilibrated, then damped on the scaled system.  Where the
    JAX package's cho_factor returns NaNs on a matrix that is not positive
    definite and turns them into a zero step, torch.linalg.cholesky would
    raise: cholesky_ex reports the failure in `info`, and the step is zero
    when `info != 0` or the solution is not finite.
    """
    K = H.shape[-3]
    batch = H.shape[:-4]
    n = K * 6
    Hd = H.transpose(-3, -2).reshape(*batch, n, n)
    d = torch.sqrt(torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1), min=1e-10))
    Hs = Hd / d[..., :, None] / d[..., None, :]
    lam = max(lm_lambda, 1e-6)
    Hs = Hs + lam * torch.eye(n, dtype=H.dtype, device=H.device)
    rhs = -g.reshape(*batch, n) / d
    L, info = torch.linalg.cholesky_ex(Hs)
    delta = torch.cholesky_solve(rhs[..., None], L)[..., 0] / d
    ok = (info == 0) & torch.all(torch.isfinite(delta), dim=-1)
    return torch.where(ok[..., None], delta, torch.zeros_like(delta)).reshape(*batch, K, 6)


def _dense_weighted(cfg) -> bool:
    return cfg.w_dense_depth > 0.0 or cfg.w_dense_color > 0.0


def build_normal_equations(inputs: GraphInputs, cfg, p2p=None, group=None):
    """Assemble H/g/cost from the sparse and dense terms (one linearization);
    the dense term reads inputs.dense_compact (optimize_pose_graph compacts
    inputs.dense into it once per solve).  With `group`, the rank's pairs'
    blocks are summed over the group: one all-reduce of H, g and cost."""
    H, g, cost, _ = sparse_normal_equations(
        inputs.poses, inputs.corres, robust_delta=cfg.robust_delta, weight=cfg.w_sparse
    )
    if inputs.dense_compact is not None and _dense_weighted(cfg):
        kw = {}
        if p2p is not None:
            kw = dict(
                max_dist=p2p.max_dist,
                max_normal_deg=p2p.max_normal_angle,
                min_pair_pixels=p2p.min_pair_pixels,
            )
        with annotate("bundletrack.gn.dense"):
            Hd, gd, cd, _ = dense_p2p_from_compact(
                inputs.poses,
                inputs.dense_compact,
                inputs.frame_valid,
                inputs.corres.pair_i,
                inputs.corres.pair_j,
                inputs.K_lowres,
                robust_delta=cfg.robust_delta,
                weight=cfg.w_dense_depth,
                weight_color=cfg.w_dense_color,
                **kw,
            )
        H, g, cost = H + Hd, g + gd, cost + cd
    if group is not None:
        parts = (H, g, cost.to(H.dtype))
        flat = all_reduce(torch.cat([t.reshape(*cost.shape, -1) for t in parts], dim=-1), group)
        sizes = [t[(0,) * cost.dim()].numel() for t in parts]
        H, g, c = (p.reshape(t.shape) for p, t in zip(torch.split(flat, sizes, dim=-1), parts))
        cost = c.to(cost.dtype)
    return H, g, cost


def _check_backend(cfg) -> None:
    """The JAX package treats any name but "pcg" as Cholesky; the port
    refuses a name it does not know (ROADMAP Queue 3.3)."""
    if cfg.solver_backend not in ("cholesky", "pcg"):
        raise ValueError(f"bundle.solver_backend={cfg.solver_backend!r}: expected 'cholesky' or 'pcg'")


def optimize_pose_graph(inputs: GraphInputs, cfg, p2p=None, group=None):
    """Run the robust-GN outer loop; returns (poses [..., K, 4, 4], info dict).

    cfg: BundleConfig (solver_backend "cholesky" or "pcg", anything else
    raises ValueError); p2p: P2PConfig dense-association gates (None =
    reference defaults).  Leading axes of the inputs batch independent
    graphs (the fleet's streams).

    With cfg.early_stop_delta > 0 a graph stops updating once its max
    |delta| falls below it (reference EvalGNConvergence; the JAX package's
    while_loop, which under vmap freezes each stream at its own iteration).
    After each iteration one device-to-host read asks whether any graph is
    still active, and the loop ends when none is: on the H100 that beat
    running all num_iter_outer iterations masked, without reads, at 1 and 8
    streams (PERF.md).  info["iterations"] counts each graph's updates.
    `group`: the pair-sharding process group (module docstring); the early
    stop then reads the max of every rank's flag, so all ranks leave the
    loop together.
    """
    _check_backend(cfg)
    if inputs.dense_compact is None and inputs.dense is not None and _dense_weighted(cfg):
        inputs = inputs._replace(dense_compact=compact_dense_frames(
            inputs.dense, capacity=cfg.dense_src_capacity, with_color=cfg.w_dense_color > 0.0))
    free = inputs.free_mask & inputs.frame_valid
    poses = inputs.poses
    batch = poses.shape[:-3]
    cost = torch.zeros(batch, dtype=torch.float32, device=poses.device)
    early_stop = cfg.early_stop_delta > 0.0
    if early_stop:
        iterations = torch.zeros(batch, dtype=torch.int32, device=poses.device)
        active = torch.ones(batch, dtype=torch.bool, device=poses.device)
    else:
        iterations = torch.full(batch, cfg.num_iter_outer, dtype=torch.int32, device=poses.device)
    for it in range(cfg.num_iter_outer):
        count("gn.iterations")
        H, g, step_cost = build_normal_equations(inputs._replace(poses=poses), cfg, p2p, group)
        H, g = _apply_gauge(H, g, free)
        if cfg.solver_backend == "pcg":
            delta = solve_normal_equations_pcg(H, g, num_iters=cfg.num_iter_inner, lm_lambda=cfg.lm_lambda)
        else:
            delta = solve_normal_equations_cholesky(H, g, cfg.lm_lambda)
        delta = delta * free.to(delta.dtype)[..., None]
        # trust-region style clamp: reject absurd steps
        step_norm = torch.linalg.norm(delta, dim=-1, keepdim=True)
        delta = torch.where(step_norm > 1.0, delta * (1.0 / step_norm), delta)
        new_poses = se3_update_left(delta, poses)
        new_poses = torch.where(inputs.frame_valid[..., None, None], new_poses, poses)
        if not early_stop:
            poses, cost = new_poses, step_cost
            continue
        poses = torch.where(active[..., None, None, None], new_poses, poses)
        cost = torch.where(active, step_cost, cost)
        iterations = iterations + active.to(torch.int32)
        active = active & (torch.amax(torch.abs(delta), dim=(-2, -1)) >= cfg.early_stop_delta)
        active = all_reduce(active, group, MAX)
        if it + 1 < cfg.num_iter_outer and not read("reads.early_stop", active.any()):
            break  # device-to-host read, once per iteration
    info = {"final_cost": cost, "iterations": iterations}
    info.update(verify_solution(poses, inputs, cfg, group))
    return poses, info


def optimize_pose_graph_verified(inputs: GraphInputs, cfg, p2p=None, group=None):
    """optimize_pose_graph + the useVerification reject path: when
    cfg.use_verification and the high-residual fraction reaches
    cfg.verify_percent_thresh, the input poses come back and `rejected` is
    True.  Returns (poses, rejected [...] bool tensor, info)."""
    with annotate("bundletrack.gn"):
        poses, info = optimize_pose_graph(inputs, cfg, p2p=p2p, group=group)
        rejected = torch.zeros(poses.shape[:-3], dtype=torch.bool, device=poses.device)
        if cfg.use_verification:
            rejected = info["high_residual_frac"] >= cfg.verify_percent_thresh
            poses = torch.where(rejected[..., None, None, None], inputs.poses, poses)
        return poses, rejected, info


def verify_solution(poses, inputs: GraphInputs, cfg, group=None):
    """Post-solve residual analysis (reference CUDASolverBundling
    computeMaxResidual and useVerification): the fraction of valid
    correspondences whose max-abs residual component exceeds
    verify_dist_thresh, and the largest residual norm.  With `group`, the
    counts are summed and the maximum maxed over the group (psum / pmax)."""
    r, _, _ = sparse_residuals(poses, inputs.corres)
    e = torch.linalg.norm(r, dim=-1)
    e_inf = torch.amax(torch.abs(r), dim=-1) * cfg.w_sparse
    valid = inputs.corres.valid
    n = torch.sum(valid, dim=(-2, -1))
    n_high = torch.sum((e_inf > cfg.verify_dist_thresh) & valid, dim=(-2, -1))
    max_res = torch.amax(torch.where(valid, e, torch.zeros_like(e)), dim=(-2, -1))
    if group is not None:
        n, n_high = all_reduce(torch.stack([n, n_high]), group)
        max_res = all_reduce(max_res, group, MAX)
    high = n_high / torch.clamp(n, min=1)
    return {"max_residual": max_res, "high_residual_frac": high}
