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

CUDA graphs.  On the card, a solve without early stopping and without a
group makes no host read, and its shapes fix its whole chain of ~3500
small kernels: `optimize_pose_graph_verified` then replays it as CUDA
graphs (`SolveGraphs`), one set per shape, with the same kernels in the
same order, so the results are the eager loop's bit for bit.  The first
solve of a shape runs eagerly, the second captures and every later one
replays.  The Cholesky backend's batched triangular solve
(`torch.cholesky_solve`, MAGMA's on the card) allocates device memory,
which no capture allows: the loop is a generator that yields each of
those solves (`_gn_loop`), and a set holds one graph per stretch between
them, the solves running eagerly in between (each frees device memory,
which waits for the card).  The PCG backend's solve is one graph.  The
graphs' intermediates stay reserved in one memory pool per device, shared
by every set (`CapturedSolve`).  Every other call runs the eager loop.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple, Optional

import torch

from bundletrack_tpu_torch.geometry.se3 import se3_update_left
from bundletrack_tpu_torch.kernels import normal_blocks
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
from bundletrack_tpu_torch.utils.profiling import annotate, count, counters, read


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
    return _run_eagerly(_cholesky_steps(H, g, lm_lambda))


def _cholesky_steps(H, g, lm_lambda: float):
    """solve_normal_equations_cholesky as a generator: it yields the
    triangular solve's (rhs [..., n, 1], L) and takes its solution back."""
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
    delta = (yield rhs[..., None], L)[..., 0] / d
    ok = (info == 0) & torch.all(torch.isfinite(delta), dim=-1)
    return torch.where(ok[..., None], delta, torch.zeros_like(delta)).reshape(*batch, K, 6)


def _run_eagerly(steps):
    """Drive a generator of this module to its return value, answering
    each (rhs, L) it yields with torch.cholesky_solve."""
    try:
        ask = next(steps)
        while True:
            ask = steps.send(torch.cholesky_solve(*ask))
    except StopIteration as done:
        return done.value


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
    return _run_eagerly(_gn_loop(inputs, cfg, p2p, group))


def _gn_loop(inputs: GraphInputs, cfg, p2p, group):
    """optimize_pose_graph's loop as a generator (module docstring):
    yields each Cholesky triangular solve's (rhs, L), returns (poses, info)."""
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
            delta = yield from _cholesky_steps(H, g, cfg.lm_lambda)
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
    True.  Returns (poses, rejected [...] bool tensor, info).  A solve the
    card can replay goes through `solve_graphs` (module docstring)."""
    with annotate("bundletrack.gn"):
        if replayable(inputs, cfg, group):
            return solve_graphs.solve(inputs, cfg, p2p)
        return _run_eagerly(_verified(inputs, cfg, p2p, group))


def _verified(inputs: GraphInputs, cfg, p2p, group):
    """optimize_pose_graph_verified's body, a generator like _gn_loop."""
    poses, info = yield from _gn_loop(inputs, cfg, p2p, group)
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


# ---- the solve as CUDA graphs (module docstring) ---------------------------

# graph sets kept, one per shape solved twice: room for a fleet, a
# single-stream tracker and two more shapes (a fleet's join frames solve
# the running streams at another S, captured once such a frame comes
# twice).  The benchmark's cells solve one shape; join traffic is not
# measured.
GRAPH_CAP = 4


def replayable(inputs: GraphInputs, cfg, group=None) -> bool:
    """Whether optimize_pose_graph_verified replays this solve: no group and
    no early stop (the loop then makes no host read), every input a CUDA
    tensor that needs no gradient and holds each element once (a broadcast
    view takes no copy), and no capture under way on the current stream."""
    if group is not None or cfg.early_stop_delta > 0.0:
        return False
    leaves = _leaves(inputs)
    return (all(x.is_cuda and not x.requires_grad for x in leaves)
            and not any(s == 0 and n > 1 for x in leaves for n, s in zip(x.shape, x.stride()))
            and not torch.cuda.is_current_stream_capturing())


def graph_key(inputs: GraphInputs, cfg, p2p) -> tuple:
    """What a graph set is captured for: each input's shape, strides,
    storage offset, dtype and device (None for an absent field), and the
    configurations, whose values the graphs hold as constants."""
    return _rebuild(inputs, lambda x: (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype, x.device)), cfg, p2p


def _leaves(x) -> list:
    """The tensors of a nest of named tuples, in field order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _leaves(f)]


def _rebuild(x, make):
    """x's nest of named tuples with each tensor t replaced by make(t)."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else make(x)
    return type(x)(*(_rebuild(f, make) for f in x))


def _buffer(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor laid out as x (shape, strides, storage offset,
    dtype, device), so that every kernel of the solve sees the caller's
    layout and alignment."""
    span = 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride())) if x.numel() else 0
    base = torch.empty(x.storage_offset() + span, dtype=x.dtype, device=x.device)
    return base.as_strided(x.shape, x.stride(), x.storage_offset())


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """One side stream per device for every capture."""
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=None)
def _graph_pool(device: torch.device):
    """One memory pool per device for every graph set (CapturedSolve)."""
    return torch.cuda.graph_pool_handle()


class CapturedSolve:
    """One shape's verified solve captured on the device's capture stream:
    the static inputs it reads, one CUDA graph per stretch between two
    eager triangular solves, and the outputs the last one writes.

    Memory.  The static inputs (the caller's input layout, ~60 MB at the
    fleet cells' S=8) are allocated outside the graphs.  Everything the
    solve allocates inside them lives in the device's graph pool for as
    long as a set does: the solve's working set, as large as the eager
    solve's (whose memory the rest of a step reuses), and the cuBLAS
    workspace of the capture stream, freed into the pool after each
    capture.  Every set captures into that one pool, so the sets share the
    working set: a replay reads only what it writes itself, its outputs are
    cloned out, and no two replays run at the same time.  The pool is
    device memory that `torch.cuda.max_memory_allocated` does not show once
    the capture is done; `torch.cuda.memory_reserved` does."""

    def __init__(self, inputs: GraphInputs, cfg, p2p):
        device = inputs.poses.device
        stream, pool = _capture_stream(device), _graph_pool(device)
        # the shape's first solve, eager on this thread, initialised what
        # the solve uses; cuBLAS keeps a workspace per stream for good:
        # cleared around the capture, as torch's cudagraph trees do, the
        # capture stream's is made inside it, in the pool
        torch._C._cuda_clearCublasWorkspaces()
        self.inputs = _rebuild(inputs, _buffer)
        self._fill(inputs)
        stream.wait_stream(torch.cuda.current_stream(device))
        self.solution = None  # the eager triangular solve's answer, read by the next graph
        self.stages = []  # (graph, the (rhs, L) it leaves for the eager solve; None after the last)
        passes, launches = counters()["gn.iterations"], normal_blocks.launches
        steps = _verified(self.inputs, cfg, p2p, None)
        while True:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                try:
                    ask = steps.send(self.solution)
                except StopIteration as done:
                    ask, self.outputs = None, done.value
            self.stages.append((graph, ask))
            if ask is None:
                break
            if self.solution is None:
                self.solution = torch.empty_like(ask[0])
        torch._C._cuda_clearCublasWorkspaces()
        # what the capture counted ran nowhere: a replay counts it
        self.passes = counters()["gn.iterations"] - passes
        self.launches = normal_blocks.launches - launches
        count("gn.iterations", -self.passes)
        normal_blocks.launches = launches

    def _fill(self, inputs: GraphInputs) -> None:
        for buf, x in zip(_leaves(self.inputs), _leaves(inputs)):
            buf.copy_(x)

    def replay(self, inputs: GraphInputs):
        """(poses, rejected, info) for `inputs`, copied out of the graphs'
        memory: the next replay overwrites it."""
        self._fill(inputs)
        for graph, ask in self.stages:
            graph.replay()
            if ask is not None:
                self.solution.copy_(torch.cholesky_solve(*ask))
        count("gn.iterations", self.passes)
        normal_blocks.launches += self.launches
        poses, rejected, info = self.outputs
        return poses.clone(), rejected.clone(), {k: v.clone() for k, v in info.items()}


class SolveGraphs:
    """The replayed solves: at most GRAPH_CAP graph sets, the least recently
    used out first.  A shape's first solve runs eagerly (a shape seen once,
    such as a fleet's join frame, pins no memory), its second captures and
    replays, and every later one replays.  Counters: `gn.captures` (graph
    sets captured), `gn.replays` (streams solved by replaying); a replay
    counts the GN passes (`gn.iterations`) and the normal-blocks launches
    (`kernels.normal_blocks.launches`) its graphs make, as the eager loop
    does, and the capture counts neither."""

    def __init__(self):
        self.sets = collections.OrderedDict()  # graph_key -> CapturedSolve
        self._seen = collections.OrderedDict()  # graph_key of a shape solved once -> None

    def solve(self, inputs: GraphInputs, cfg, p2p=None):
        key = graph_key(inputs, cfg, p2p)
        graphs = self.sets.get(key)
        if graphs is None:
            if key not in self._seen:
                _put(self._seen, key, None)
                return _run_eagerly(_verified(inputs, cfg, p2p, None))
            del self._seen[key]
            _check_backend(cfg)
            graphs = CapturedSolve(inputs, cfg, p2p)
            count("gn.captures")
            _put(self.sets, key, graphs)
        else:
            self.sets.move_to_end(key)
        out = graphs.replay(inputs)
        count("gn.replays", math.prod(inputs.poses.shape[:-3]))
        return out

    def clear(self) -> None:
        self.sets.clear()
        self._seen.clear()


def _put(lru: collections.OrderedDict, key, value) -> None:
    lru[key] = value
    while len(lru) > GRAPH_CAP:
        lru.popitem(last=False)


solve_graphs = SolveGraphs()  # the process's graph sets, one per shape solved twice
