"""The Gauss-Newton solve replayed as CUDA graphs (solver/gauss_newton.py).

On the CPU: the eager loop is what runs for CPU inputs, with early
stopping and with a process group, and it gives the frozen reference's
result (trackbench/reference, the eager loop as it was before the graphs)
bit for bit; the shape key; the cache's order (first solve eager, second
captures, later ones replay, least recently used out first) with a
stand-in for the capture.  On the card (marked `cuda`, skipped without
one): replays against the eager loop bit for bit at the fleet's shape and
at one stream, with both backends; results kept across later replays; the
counters, and the normal-blocks launches counted where they run (at
replay, not at capture); re-capture on a new shape and the cache's cap.  The file imports
neither JAX nor the JAX package, so it also runs where only the port is:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gn_graph.py -q
"""

import collections
import dataclasses

import pytest
import torch
import torch.distributed as dist

from bundletrack_tpu_torch.config import BundleConfig, P2PConfig
from bundletrack_tpu_torch.geometry.se3 import se3_exp
from bundletrack_tpu_torch.kernels import normal_blocks
from bundletrack_tpu_torch.solver import gauss_newton as gn
from bundletrack_tpu_torch.solver.dense_p2p import CompactDense
from bundletrack_tpu_torch.solver.residuals import SparseCorres
from bundletrack_tpu_torch.utils import profiling
from trackbench.reference.solver import gauss_newton as frozen

# the fleet cells' solve: 8 streams, K = 16 frames, P = 120 pairs, M = 256
# matches, C = 4096 dense pixels, a 120x160 low-res table
FLEET = dict(S=8, K=16, M=256, C=4096, Hh=120, Ww=160)
TINY = dict(S=2, K=4, M=16, C=64, Hh=12, Ww=16)
P2P = P2PConfig(min_pair_pixels=8)


def _inputs(seed, device="cpu", S=2, K=4, M=16, C=64, Hh=12, Ww=16, dtype=torch.float32):
    """A solve's inputs laid out as the tracker passes them (the dense
    sources a transposed view, the pairs every i < j), from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def r(*shape):
        return torch.rand(*shape, device=device, generator=g)

    pi, pj = torch.triu_indices(K, K, 1, device=device)
    P = pi.numel()
    poses = se3_exp(torch.cat([(r(S, K, 3) - 0.5) * 0.02, (r(S, K, 3) - 0.5) * 0.05], -1))
    poses[..., 2, 3] += 0.5
    pts = (r(S, P, M, 3) - 0.5) * 0.2
    pts[..., 2] += 0.5
    z = 0.45 + 0.1 * r(S, K, Hh, Ww)
    z_hi = z.to(torch.bfloat16)
    z_lo = (z - z_hi.float()).to(torch.bfloat16)
    zero = torch.zeros_like(z_hi)
    tchan = torch.stack([z_hi, z_lo, zero, zero, -torch.ones_like(z_hi), (r(S, K, Hh, Ww) > 0.2).to(torch.bfloat16),
                         zero, zero], -1)
    lin = (r(S, K, C) * Hh * Ww).long().clamp(max=Hh * Ww - 1)
    u, v = (lin % Ww).float(), (lin // Ww).float()
    fx, cx, cy = 0.8 * Ww, Ww / 2, Hh / 2
    zs = torch.gather(z.reshape(S, K, -1), 2, lin) + 0.003 * (r(S, K, C) - 0.5)
    src = torch.stack([(u - cx) / fx * zs, (v - cy) / fx * zs, zs, torch.zeros_like(zs), torch.zeros_like(zs),
                       -torch.ones_like(zs)], 2)  # [S, K, 6, C], as the tracker stacks its frames
    K_low = torch.tensor([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], device=device).expand(S, 3, 3).contiguous()
    return gn.GraphInputs(
        poses.to(dtype), torch.ones(S, K, dtype=torch.bool, device=device), torch.arange(K, device=device) > 0,
        SparseCorres(pi, pj, pts.to(dtype), (pts + 0.002 * (r(S, P, M, 3) - 0.5)).to(dtype), r(S, P, M) > 0.3),
        dense_compact=CompactDense(src.transpose(-3, -2).to(dtype), r(S, K, C) > 0.1, lin.int(), tchan),
        K_lowres=K_low.to(dtype),
    )


def _config(**kw):
    return BundleConfig(**{"max_ba_frames": 16, **kw})


def _flat(out):
    """(poses, rejected, info) as a list of tensors, info in key order."""
    poses, rejected, info = out
    return [poses, rejected, *(info[k] for k in sorted(info))]


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


class _NoGraphs:
    """Stands in for the process's graph sets: a solve that reaches it fails."""

    def solve(self, *args, **kwargs):
        raise AssertionError("the solve went to the CUDA graphs")


@pytest.fixture
def one_rank_group():
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---- on the CPU ----------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu_inputs", "early_stop", "group"])
def test_the_eager_loop_runs_and_gives_the_frozen_result(case, request, monkeypatch):
    """Every solve that is not replayable runs the eager loop, as before."""
    monkeypatch.setattr(gn, "solve_graphs", _NoGraphs())
    inputs = _inputs(3, **TINY)
    # the verification keeps stream 0's solve and rejects stream 1's
    cfg = _config(use_verification=True, verify_dist_thresh=0.0017,
                  early_stop_delta=5e-3 if case == "early_stop" else 0.0)
    group = request.getfixturevalue("one_rank_group") if case == "group" else None
    assert not gn.replayable(inputs, cfg, group)
    before = profiling.counters()
    got = gn.optimize_pose_graph_verified(inputs, cfg, p2p=P2P, group=group)
    counted = profiling.counters() - before
    want = frozen.optimize_pose_graph_verified(inputs, cfg, p2p=P2P)
    _assert_bit_equal(got, want)
    assert got[1].tolist() == [False, True] and float((got[0][0] - inputs.poses[0]).abs().max()) > 1e-3
    assert counted["gn.replays"] == counted["gn.captures"] == 0
    passes = int(got[2]["iterations"].max())
    assert counted["gn.iterations"] == passes and (passes < cfg.num_iter_outer) == (case == "early_stop")


def _variant(name):
    """(inputs, cfg, p2p) that differ from the base in one thing."""
    cfg = _config()
    if name == "base":
        return _inputs(0, **TINY), cfg, P2P
    if name == "same_shapes_other_values":
        return _inputs(1, **TINY), cfg, P2P
    if name in ("S", "K", "M", "C"):
        return _inputs(0, **{**TINY, name: TINY[name] + 1}), cfg, P2P
    if name == "table":
        return _inputs(0, **{**TINY, "Hh": TINY["Hh"] + 2}), cfg, P2P
    if name == "dtype":
        return _inputs(0, **TINY, dtype=torch.float64), cfg, P2P
    if name == "layout":  # the dense sources contiguous, not the tracker's transposed view
        inputs = _inputs(0, **TINY)
        cd = inputs.dense_compact
        return inputs._replace(dense_compact=cd._replace(src=cd.src.contiguous())), cfg, P2P
    if name in ("lm_lambda", "num_iter_outer", "robust_delta", "w_dense_depth", "solver_backend",
                "use_verification"):
        value = {"lm_lambda": 1e-4, "num_iter_outer": 3, "robust_delta": 0.01, "w_dense_depth": 0.5,
                 "solver_backend": "pcg", "use_verification": True}[name]
        return _inputs(0, **TINY), dataclasses.replace(cfg, **{name: value}), P2P
    if name == "p2p_max_dist":
        return _inputs(0, **TINY), cfg, dataclasses.replace(P2P, max_dist=0.05)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["same_shapes_other_values", "S", "K", "M", "C", "table", "dtype", "layout",
                                  "lm_lambda", "num_iter_outer", "robust_delta", "w_dense_depth",
                                  "solver_backend", "use_verification", "p2p_max_dist"])
def test_the_graph_key_tells_shapes_and_settings_apart(name):
    base = gn.graph_key(*_variant("base"))
    assert gn.graph_key(*_variant("base")) == base
    assert (gn.graph_key(*_variant(name)) == base) == (name == "same_shapes_other_values")


class _StandIn:
    """A CapturedSolve that records what it was asked, counts a replay's GN
    passes as the real one does, and returns the input poses."""

    made = []

    def __init__(self, inputs, cfg, p2p):
        self.key = gn.graph_key(inputs, cfg, p2p)
        self.passes = cfg.num_iter_outer
        self.replays = 0
        _StandIn.made.append(self)

    def replay(self, inputs):
        self.replays += 1
        profiling.count("gn.iterations", self.passes)
        return inputs.poses.clone(), torch.zeros(inputs.poses.shape[:-3], dtype=torch.bool), {}


def test_a_shape_solves_eagerly_then_captures_then_replays(monkeypatch):
    monkeypatch.setattr(gn, "CapturedSolve", _StandIn)
    _StandIn.made = []
    graphs, cfg = gn.SolveGraphs(), _config()
    before = profiling.counters()
    first = graphs.solve(_inputs(0, **TINY), cfg, P2P)
    assert not _StandIn.made  # the first solve of a shape is the eager loop's
    _assert_bit_equal(first, frozen.optimize_pose_graph_verified(_inputs(0, **TINY), cfg, p2p=P2P))
    for seed in (1, 2, 3):
        graphs.solve(_inputs(seed, **TINY), cfg, P2P)
    assert len(_StandIn.made) == 1 and _StandIn.made[0].replays == 3
    assert profiling.counters() - before == collections.Counter(
        {"gn.iterations": 4 * cfg.num_iter_outer, "gn.captures": 1, "gn.replays": 3 * TINY["S"]})


def test_the_cache_keeps_at_most_its_cap(monkeypatch):
    monkeypatch.setattr(gn, "CapturedSolve", _StandIn)
    _StandIn.made = []
    monkeypatch.setattr(gn, "GRAPH_CAP", 2)
    graphs, cfg = gn.SolveGraphs(), _config()
    shapes = {s: _inputs(0, **{**TINY, "S": s}) for s in (1, 2, 3)}
    for s in (1, 1, 2, 2, 3, 3):
        graphs.solve(shapes[s], cfg, P2P)
    assert [m.key for m in _StandIn.made] == [gn.graph_key(shapes[s], cfg, P2P) for s in (1, 2, 3)]
    assert list(graphs.sets) == [gn.graph_key(shapes[s], cfg, P2P) for s in (2, 3)]
    graphs.solve(shapes[1], cfg, P2P)  # evicted: eager again, then a new capture
    assert len(_StandIn.made) == 3
    graphs.solve(shapes[1], cfg, P2P)
    assert len(_StandIn.made) == 4 and len(graphs.sets) == 2
    assert gn.graph_key(shapes[2], cfg, P2P) not in graphs.sets


# ---- on the card ---------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")


def _eager(inputs, cfg, p2p=P2P):
    return gn._run_eagerly(gn._verified(inputs, cfg, p2p, None))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cholesky", "pcg"])
@pytest.mark.parametrize("streams", [8, 1])
def test_replays_equal_the_eager_loop_bit_for_bit(backend, streams):
    _need_card()
    cfg = _config(solver_backend=backend, use_verification=True, verify_dist_thresh=0.0015)
    graphs = gn.SolveGraphs()
    for seed in range(8):  # eager, capture, then six replays
        inputs = _inputs(seed, "cuda", **{**FLEET, "S": streams})
        assert gn.replayable(inputs, cfg)
        _assert_bit_equal(graphs.solve(inputs, cfg, P2P), _eager(inputs, cfg))
    assert len(graphs.sets) == 1


@pytest.mark.cuda
def test_a_kept_result_survives_later_replays():
    _need_card()
    cfg, graphs, kept = _config(), gn.SolveGraphs(), []
    for seed in range(5):
        out = graphs.solve(_inputs(seed, "cuda", **FLEET), cfg, P2P)
        kept.append((out, [t.clone() for t in _flat(out)]))
        for held, copy in kept:
            assert all(torch.equal(a, b) for a, b in zip(_flat(held), copy))
    assert len(graphs.sets) == 1


@pytest.mark.cuda
def test_counters_and_the_normal_blocks_kernel_in_a_replay():
    _need_card()
    cfg, graphs = _config(), gn.SolveGraphs()
    blocks_per_solve = 2 * cfg.num_iter_outer  # the sparse and the dense term's blocks in every iteration
    before, launches = profiling.counters(), normal_blocks.launches
    for seed in range(4):  # eager, capture and replay, two replays
        graphs.solve(_inputs(seed, "cuda", **FLEET), cfg, P2P)
    assert profiling.counters() - before == collections.Counter(
        {"gn.iterations": 4 * cfg.num_iter_outer, "gn.captures": 1, "gn.replays": 3 * FLEET["S"]})
    assert normal_blocks.launches - launches == 4 * blocks_per_solve  # the capture launched nothing
    launches = normal_blocks.launches
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graphs.solve(_inputs(9, "cuda", **FLEET), cfg, P2P)
        torch.cuda.synchronize()
    names = [k.name for k in profiling.kernel_records(prof)]
    assert sum("normal_blocks" in n for n in names) == blocks_per_solve  # from inside the graphs
    assert normal_blocks.launches - launches == blocks_per_solve


@pytest.mark.cuda
def test_a_new_shape_captures_again_within_the_cap(monkeypatch):
    _need_card()
    monkeypatch.setattr(gn, "GRAPH_CAP", 2)
    cfg, graphs = _config(), gn.SolveGraphs()
    small = {**FLEET, "M": 64, "C": 512}
    before = profiling.counters()
    for s in (4, 4, 2, 2, 1, 1, 4, 4):
        inputs = _inputs(s, "cuda", **{**small, "S": s})
        _assert_bit_equal(graphs.solve(inputs, cfg, P2P), _eager(inputs, cfg))
    counted = profiling.counters() - before
    assert counted["gn.captures"] == 4 and len(graphs.sets) == 2  # S = 4 evicted by S = 1, then captured again
    assert counted["gn.replays"] == 4 + 2 + 1 + 4


@pytest.mark.cuda
def test_early_stop_stays_eager_on_the_card():
    _need_card()
    inputs = _inputs(0, "cuda", **FLEET)
    cfg = _config(early_stop_delta=1e-3)
    assert not gn.replayable(inputs, cfg) and gn.replayable(inputs, _config())
    before = profiling.counters()
    for _ in range(3):
        _assert_bit_equal(gn.optimize_pose_graph_verified(inputs, cfg, p2p=P2P), _eager(inputs, cfg))
    assert (profiling.counters() - before)["gn.captures"] == 0
