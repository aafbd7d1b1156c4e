"""Rank bodies for the port's multi-process tests (not a test module).

The tests spawn gloo ranks on the CPU with
`bundletrack_tpu_torch.parallel.distributed.spawn_ranks`; spawned ranks
import their function by name from this module, which imports torch and
the port only, never jax, so a rank's interpreter holds no JAX (each body
records the modules it finds).  Every rank writes what the parent checks to
`<out>/<name>.rank<r>.pt`.
"""

from __future__ import annotations

import os
import sys

import traceback

import numpy as np
import torch



def run_jobs(rank, out, jobs):
    """Run each (function name, args) of `jobs` in turn in one process group;
    a job that raises leaves its traceback in <out>/<function>.error<rank>."""
    torch.set_num_threads(1)
    for name, args in jobs:
        try:
            globals()[name](rank, out, *args)
        except Exception:
            with open(os.path.join(out, f"{name}.error{rank}"), "w") as f:
                f.write(traceback.format_exc())


def save(out: str, name: str, rank: int, **results) -> None:
    forbidden = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                       or m == "bundletrack_tpu" or m.startswith("bundletrack_tpu."))
    torch.save(dict(results, forbidden_modules=forbidden), os.path.join(out, f"{name}.rank{rank}.pt"))


def load(out: str, name: str, world: int, job: str = "") -> list:
    """Every rank's results of one job; a rank's traceback fails here."""
    for r in range(world):
        err = os.path.join(out, f"{job or name}.error{r}")
        if os.path.exists(err):
            raise AssertionError(f"rank {r} failed:\n" + open(err).read())
    return [torch.load(os.path.join(out, f"{name}.rank{r}.pt"), weights_only=False) for r in range(world)]


def _raises(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


# ---- runtime helpers and collectives (world 4) --------------------------------


def helpers_rank(rank, out):
    from bundletrack_tpu_torch.ops import collectives as C
    from bundletrack_tpu_torch.parallel import distributed as D

    fleet = D.global_fleet_mesh()
    train = D.global_train_mesh(2)
    mesh = D.make_mesh({"stream": 2, "pairs": 2})
    pairs = D.axis_group(mesh, "pairs")
    # a differentiable gather on a group that does not hold global rank 0 for
    # ranks 2 and 3: d/dx of sum(w * gather(x)) is this rank's slice of the
    # group's summed w
    x = torch.full((2, 3), float(rank), requires_grad=True)
    w = torch.arange(12.0).reshape(4, 3) * (rank + 1)
    g = C.gather_over_group(x, pairs)
    (g * w).sum().backward()
    s = C.sum_over_group(torch.tensor([1.0 + rank], requires_grad=True), pairs)
    save(out, "helpers", rank,
         fleet=(fleet.mesh_dim_names, tuple(fleet.shape)), train=(train.mesh_dim_names, tuple(train.shape)),
         coords=(mesh.get_local_rank("stream"), mesh.get_local_rank("pairs")),
         slices=(D.local_stream_slice(8), D.local_stream_slice(8, mesh)),
         gathered=g.detach(), grad=x.grad, summed=s.detach(),
         first=C.broadcast_from_first(torch.tensor([rank, rank == 3]), pairs),
         maxed=C.all_reduce(torch.tensor([rank]), pairs, C.MAX),
         bad_product=_raises(lambda: D.make_mesh({"stream": 3})),
         uneven=_raises(lambda: D.local_stream_slice(5)),
         bad_axis=_raises(lambda: D.axis_group(mesh, "data")),
         device=str(D.rank_device("cpu")))


# ---- pair-sharded BA (world 2) --------------------------------------------------


def pair_sharded_rank(rank, out, name, cfg, table, pi, pj, phases, dense, K_low):
    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.parallel.pair_sharded import _ba_local, make_pair_sharded_ba

    mesh = D.make_mesh({"pairs": 2})
    i, j, valid = torch.from_numpy(pi), torch.from_numpy(pj), torch.ones(len(pi), dtype=torch.bool)
    ph = torch.from_numpy(phases)
    step = make_pair_sharded_ba(cfg, mesh)
    poses, cost, high = step(table, dense, K_low, i, j, valid, phases=ph)
    one = _ba_local(table, dense, K_low, i, j, valid, ph, cfg) if rank == 0 else None
    save(out, name, rank, poses=poses, cost=cost, high=high, one=one,
         uneven=_raises(lambda: step(table, dense, K_low, i[:119], j[:119], valid[:119], phases=ph[:119])),
         bad_axis=_raises(lambda: make_pair_sharded_ba(cfg, mesh, axis="nonexistent")))


# ---- the tracker and the fleet --------------------------------------------------


def tracker_rank(rank, out, cfg, seq, phases, axis_sizes):
    import dataclasses

    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.tracker.driver import Tracker

    mesh = D.make_mesh(axis_sizes)
    cfg_sh = cfg.replace(bundle=dataclasses.replace(cfg.bundle, ba_mesh_axis="pairs"))
    H, W = seq["gray"].shape[1:]
    trk = Tracker(cfg_sh, H, W, device="cpu", mesh=mesh)
    init = np.linalg.inv(seq["ob_in_cam"][0]).astype(np.float32)
    poses, statuses = [], []
    for f in range(seq["gray"].shape[0]):
        o = trk.process_frame(seq["gray"][f], seq["depth"][f], seq["mask"][f], seq["K"], init, phases=phases[f])
        poses.append(o.ob_in_cam.numpy())
        statuses.append(int(o.status))
    bad = cfg.replace(bundle=dataclasses.replace(cfg.bundle, ba_mesh_axis="nonexistent"))
    save(out, "tracker", rank, poses=np.stack(poses), statuses=statuses,
         bad_axis=_raises(lambda: Tracker(bad, H, W, device="cpu", mesh=mesh)))


def fleet_rank(rank, out, cfg, frames, init_poses, phases, axis_sizes, name, resets=None):
    """frames[f] = (gray, depth, mask, K) of every stream; each rank feeds
    its block of the streams, and its phases.  `resets` = {frame: (global
    streams, init poses [S, 4, 4])}: before that frame those streams are
    set to a fresh state's (they join the running fleet) and the init poses
    change.  Also records the collectives each frame issues."""
    import torch.distributed as dist

    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
    from bundletrack_tpu_torch.tracker.state import set_streams

    calls = []
    for op in ("all_reduce", "all_gather", "broadcast"):
        def counted(*a, _op=getattr(dist, op), **k):
            calls.append(1)
            return _op(*a, **k)
        setattr(dist, op, counted)
    mesh = D.make_mesh(axis_sizes)
    S = init_poses.shape[0]
    H, W = frames[0][0].shape[1:]
    mine = D.local_stream_slice(S, mesh)
    step = make_fleet_step(cfg, H, W, mesh=mesh)
    state = init_fleet_state(cfg, H, W, S, device="cpu", mesh=mesh)
    ip = torch.from_numpy(init_poses[mine])
    poses, statuses, collectives = [], [], []
    for f, arrays in enumerate(frames):
        if resets and f in resets:
            streams, init_poses = resets[f]
            local = [s - mine.start for s in streams if mine.start <= s < mine.stop]
            if local:
                state = set_streams(state, local, init_fleet_state(cfg, H, W, S, device="cpu", mesh=mesh))
            ip = torch.from_numpy(init_poses[mine])
        ph = None if phases[f] is None else tuple(p[mine] for p in phases[f])
        n = len(calls)
        state, o = step(state, fleet_observation(*(a[mine] for a in arrays), "cpu"), ip, ph)
        collectives.append(len(calls) - n)
        poses.append(o.ob_in_cam.numpy())
        statuses.append(o.status.numpy())
    save(out, name, rank, streams=(mine.start, mine.stop), poses=np.stack(poses), statuses=np.stack(statuses),
         collectives=collectives, frame_count=state.frame_count)


def hygiene_rank(rank, out):
    """Two fleet frames of two streams over stream=2 and one data-parallel
    VOS step: what a spawned rank of the port imports."""
    from bundletrack_tpu_torch.config import BundleConfig, FrontendConfig, KeyframeConfig, RansacConfig
    from bundletrack_tpu_torch.config import ShapeConfig, TrackerConfig
    from bundletrack_tpu_torch.data import render_synthetic_sequence
    from bundletrack_tpu_torch.models.vos import init_vos
    from bundletrack_tpu_torch.models import VOSTrainBatch, make_adam
    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
    from bundletrack_tpu_torch.parallel import make_sharded_vos_train_step

    cfg = TrackerConfig(bundle=BundleConfig(max_ba_frames=3), keyframe=KeyframeConfig(pool_size=4),
                        frontend=FrontendConfig(top_k=64), ransac=RansacConfig(max_iter=128),
                        shapes=ShapeConfig(max_matches=64, image_h=60, image_w=80))
    seq = render_synthetic_sequence(num_frames=2, H=60, W=80, seed=rank)
    mesh = D.make_mesh({"stream": 2})
    step, state = make_fleet_step(cfg, 60, 80, mesh=mesh), init_fleet_state(cfg, 60, 80, 2, device="cpu", mesh=mesh)
    ip = torch.from_numpy(np.linalg.inv(seq.ob_in_cam[:1]).astype(np.float32))
    for f in range(2):
        state, o = step(state, fleet_observation(seq.gray[f:f + 1], seq.depth[f:f + 1], seq.mask[f:f + 1],
                                                 seq.K[None], "cpu"), ip)
    model, _ = init_vos(width=8)
    vos_step = make_sharded_vos_train_step(model, make_adam(model.parameters(), 1e-3), D.make_mesh({"data": 2}),
                                           (32, 32))
    clips = torch.rand(2, 3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    metrics = vos_step(VOSTrainBatch(clips, (clips[..., 0] > 0.5).long()))
    save(out, "hygiene", rank, finite=bool(torch.isfinite(o.ob_in_cam).all()) and bool(metrics["loss"].isfinite()))


# ---- training -------------------------------------------------------------------


def _gathered_grads(model):
    """Every parameter's gradient made whole over the model axis."""
    from bundletrack_tpu_torch.frontend.lfnet import gather_lfnet_state_dict

    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    group = getattr(getattr(model, "descriptor", None), "model_group", None)
    return grads if group is None else gather_lfnet_state_dict(grads, group)


def lfnet_train_rank(rank, out, cfg, sd, batch, axis_sizes, name):
    from bundletrack_tpu_torch.frontend.lfnet import LFNet
    from bundletrack_tpu_torch.models import LFNetTrainBatch, make_adam
    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.parallel.fleet import make_sharded_lfnet_train_step

    mesh = D.make_mesh(axis_sizes)
    model = LFNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    opt = make_adam(model.parameters(), 1e-3)
    step = make_sharded_lfnet_train_step(model, opt, mesh)
    metrics = step(LFNetTrainBatch(*(torch.from_numpy(batch[k]) for k in LFNetTrainBatch._fields)))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    save(out, f"lfnet_train_{name}", rank, metrics={k: float(v) for k, v in metrics.items()},
         grads=_gathered_grads(model), shapes=shapes,
         adam_shapes={n: tuple(opt.state[p]["exp_avg"].shape) for n, p in model.named_parameters()})


def lfnet_tp_forward_rank(rank, out, cfg, sd, patches):
    """The descriptor on `patches`, whole, then with its MLP split over a
    "model" axis of 2 ranks (`shard_lfnet_`)."""
    from bundletrack_tpu_torch.frontend.lfnet import LFNet, shard_lfnet_
    from bundletrack_tpu_torch.parallel import distributed as D

    model = LFNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = torch.from_numpy(patches)
    with torch.no_grad():
        whole = model.describe_patches(x)
        shard_lfnet_(model, D.axis_group(D.make_mesh({"model": 2}), "model"))
        sharded = model.describe_patches(x)
    save(out, f"lfnet_tp_forward_{'bf16' if cfg.bf16 else 'f32'}", rank, whole=whole, sharded=sharded)


def vos_train_rank(rank, out, sd, batch, rollout, width, out_dim):
    from bundletrack_tpu_torch.models import VOSTrainBatch, make_adam
    from bundletrack_tpu_torch.models.vos import VOSNet
    from bundletrack_tpu_torch.parallel import distributed as D
    from bundletrack_tpu_torch.parallel.fleet import make_sharded_vos_train_step

    mesh = D.make_mesh({"data": 2})
    model = VOSNet(out_dim=out_dim, width=width)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    opt = make_adam(model.parameters(), 1e-3)
    H, W = batch["clips"].shape[2:4]
    step = make_sharded_vos_train_step(model, opt, mesh, (H, W), rollout=rollout)
    metrics = step(VOSTrainBatch(torch.from_numpy(batch["clips"]), torch.from_numpy(batch["labels"])))
    save(out, f"vos_train_{rollout}", rank, metrics={k: float(v) for k, v in metrics.items()},
         grads=_gathered_grads(model))


def cli_rank(rank, out, tool, argv):
    import importlib

    main = importlib.import_module(f"bundletrack_tpu_torch.apps.{tool}").main
    metrics = main(argv)
    save(out, tool, rank, metrics={k: float(v) for k, v in metrics.items()})


def failing_rank(rank):
    """Rank 1 fails at once; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank failure")
    torch.distributed.all_reduce(torch.ones(1))
