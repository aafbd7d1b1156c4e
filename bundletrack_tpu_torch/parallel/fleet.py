"""Fleet tracking over streams, and the sharded training steps.

Counterpart of bundletrack_tpu/parallel/fleet.py.  The JAX package batches
S streams with jax.vmap over the TrackerState pytree; here the step itself
carries a leading stream axis (tracker/bundler.make_batched_track_frame),
so a fleet frame launches about as many kernels as one stream's frame, makes
the same 2 device-to-host reads (and the same 2 waits inside torch.linalg.svd),
and matches all S*P BA pairs in one launch of the matcher kernel.

Each stream keeps its own frame count, as each stream of the JAX fleet
takes its own side of the first-frame lax.cond: a stream reset to a fresh
state (tracker/state.set_streams, the JAX `.at[idx].set` update) starts on
the next step while the others go on tracking (tracker/bundler.py splits
that frame).  With the LF-Net frontend (`lfnet_apply`), the S masked ROI
crops go through one batched forward per fleet frame, new streams included.

With a mesh (parallel/distributed.make_mesh) the streams are sharded over
its "stream" axis: each rank holds and steps only its block of the
streams (`local_stream_slice`), with no communication between streams, and
its outputs stay local.  The JAX fleet's global [S, ...] arrays are the
concatenation of the ranks' outputs in rank order along that axis.  With
bundle.ba_mesh_axis also in the mesh (a stream x pairs mesh), each rank's
streams shard their BA pairs over that axis's group as well.

Training: `make_sharded_lfnet_train_step` splits the batch over "data"
and the descriptor MLP over "model"; `make_sharded_vos_train_step` splits
the clips over "data".  Each rank computes its share of the global loss
and the gradients are summed over "data" (models/optim.train_step).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.device import resolve_device
from bundletrack_tpu_torch.frontend.lfnet import gather_lfnet_state_dict, shard_lfnet_, tp_shard_dim
from bundletrack_tpu_torch.models.lfnet_train import make_lfnet_train_step
from bundletrack_tpu_torch.models.vos_train import make_vos_train_step
from bundletrack_tpu_torch.ops.collectives import all_gather_cat, group_rank, group_size
from bundletrack_tpu_torch.parallel.distributed import axis_group, local_stream_slice
from bundletrack_tpu_torch.parallel.distributed import make_mesh  # noqa: F401  (the JAX package's fleet.make_mesh)
from bundletrack_tpu_torch.tracker.bundler import make_batched_track_frame
from bundletrack_tpu_torch.tracker.driver import _upload
from bundletrack_tpu_torch.tracker.state import (
    FrameObservation,
    TrackerState,
    _generator,
    init_tracker_state,
)
from bundletrack_tpu_torch.utils.profiling import annotate

def _has_axis(mesh, axis) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def init_fleet_state(cfg: TrackerConfig, H: int, W: int, num_streams: int, device=None,
                     seed: int = 0, mesh=None) -> TrackerState:
    """A TrackerState with a leading stream axis on every tensor, all
    streams at frame 0 (one host count per stream); stream s draws its
    RANSAC phases from a generator seeded with seed + s (so a fleet of one
    equals Tracker(seed)).  Runs on the card unless `device` says otherwise.

    With a mesh that has a "stream" axis, the state holds only this rank's
    block of the `num_streams` streams, each still seeded by its global
    index, so the sharded fleet reproduces the fleet on one rank."""
    device = resolve_device(device)
    streams = range(num_streams)
    if _has_axis(mesh, "stream"):
        streams = range(num_streams)[local_stream_slice(num_streams, mesh)]
    base = init_tracker_state(cfg, H, W, device, seed)

    def tile(x):
        return x[None].expand(len(streams), *x.shape).clone()

    return base._replace(
        **{n: tile(v) for n, v in base._asdict().items() if isinstance(v, torch.Tensor)},
        mappoints=type(base.mappoints)(*(tile(t) for t in base.mappoints)),
        frame_count=(0,) * len(streams),
        rng=tuple(_generator(device, seed + s) for s in streams),
    )


def make_fleet_step(cfg: TrackerConfig, H: int, W: int, mesh=None, lfnet_apply=None):
    """The multi-stream step: (state[S], obs[S], init_pose [S,4,4],
    phases=None) -> (state, TrackOutput[S]); `phases` as
    tracker/bundler.make_batched_track_frame takes them.  `lfnet_apply`
    (frontend/lfnet.make_lfnet_apply) is the LF-Net frontend, needed when
    cfg.frontend.kind is "lfnet"; it takes the S crops as one stack.

    With a mesh, S is this rank's streams (init_fleet_state(mesh=...)):
    each rank feeds its own block of the streams (`local_stream_slice`) and
    gets their outputs.  When cfg.bundle.ba_mesh_axis names another axis of
    the mesh, each stream's BA pairs are sharded over it too; the ranks
    along that axis step the same streams on the same inputs."""
    pair_axis = cfg.bundle.ba_mesh_axis or None
    if not _has_axis(mesh, pair_axis):
        return make_batched_track_frame(cfg, H, W, lfnet_apply)
    return make_batched_track_frame(cfg, H, W, lfnet_apply, mesh=mesh, pair_axis=pair_axis)


def fleet_observation(gray, depth, mask, K, device) -> FrameObservation:
    """One fleet frame from per-stream numpy arrays [S, H, W] (gray uint8 or
    float, depth uint16 millimeters or float meters, mask bool) and
    intrinsics [S, 3, 3], uploaded to `device`."""
    with annotate("bundletrack.upload"):
        return FrameObservation(gray=_upload(gray, device), depth=_upload(depth, device),
                                mask=_upload(np.asarray(mask, bool), device),
                                K=_upload(np.asarray(K, np.float32), device))


# ---- sharded training ----------------------------------------------------------


def _data_group(mesh):
    group = axis_group(mesh, "data")
    return group if group_size(group) > 1 else None


def _block(batch, group):
    """This rank's contiguous block of a global batch (every field's leading
    axis), as P(data) shards it."""
    n, r = group_size(group), group_rank(group)
    B = batch[0].shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not divide over {n} data ranks")
    per = B // n
    return type(batch)(*(t[r * per:(r + 1) * per] for t in batch))


def broadcast_parameters(model) -> None:
    """Every parameter set to global rank 0's value (one broadcast)."""
    params = [p.data for p in model.parameters()]
    flat = torch.cat([p.reshape(-1) for p in params])
    dist.broadcast(flat, src=0)
    for p, part in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.copy_(part.view_as(p))


def _named_state(model, optimizer):
    """(name, Adam state) of each parameter, in the optimiser's order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], optimizer.state[p]) for g in optimizer.param_groups for p in g["params"]]


def make_sharded_lfnet_train_step(model, optimizer, mesh, scheduler=None):
    """The LF-Net step under data x tensor parallelism; step(batch) ->
    global metrics, `batch` the GLOBAL LFNetTrainBatch (every rank passes
    the same; each takes its block of rows over the mesh's "data" axis,
    which must divide it).

    `model` and `optimizer` (built on model.parameters(), e.g. make_adam)
    are made sharded in place: every parameter is first set to global rank
    0's, then fc1 / fc2 (and fc1_norm) are cut to this rank's shard over
    "model" when the mesh has it with more than one rank, and Adam's
    state follows each parameter's shard (exact: Adam is elementwise).
    `unsharded_state_dicts` makes both whole again for a checkpoint."""
    data_g = _data_group(mesh)
    model_g = axis_group(mesh, "model") if _has_axis(mesh, "model") else None
    broadcast_parameters(model)
    if group_size(model_g) > 1:
        n, r = group_size(model_g), group_rank(model_g)
        shard_lfnet_(model, model_g)
        for name, st in _named_state(model, optimizer):
            d = tp_shard_dim(name)
            if d is not None:
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k] = st[k].chunk(n, dim=d)[r].clone()
    step = make_lfnet_train_step(model, optimizer, scheduler, data_group=data_g)
    return lambda batch: step(_block(batch, data_g))


def make_sharded_vos_train_step(model, optimizer, mesh, image_hw, **train_kw):
    """The VOS step under data parallelism (the reference's DDP):
    step(batch) -> global metrics, `batch` the GLOBAL VOSTrainBatch, each
    rank taking its block of clips over the mesh's "data" axis.  Parameters are
    replicated, set to global rank 0's first; `train_kw` as
    models/vos_train.make_vos_train_step takes them."""
    data_g = _data_group(mesh)
    broadcast_parameters(model)
    step = make_vos_train_step(model, optimizer, image_hw, data_group=data_g, **train_kw)
    return lambda batch: step(_block(batch, data_g))


def unsharded_state_dicts(model, optimizer=None):
    """(model state dict, optimiser state dict or None) with every tensor
    whole: a tensor-parallel LF-Net's shards are gathered over its model
    group (a collective: every rank calls it), so a checkpoint has the
    one-device layout whatever the mesh was."""
    group = getattr(getattr(model, "descriptor", None), "model_group", None)
    params = model.state_dict()
    opt = None if optimizer is None else optimizer.state_dict()
    if group is None:
        return params, opt
    params = gather_lfnet_state_dict(params, group)
    if opt is not None:
        for i, (name, _) in enumerate(_named_state(model, optimizer)):
            d = tp_shard_dim(name)
            if d is not None:
                opt["state"][i] = {k: all_gather_cat(v, group, dim=d) if k.startswith("exp_avg") else v
                                   for k, v in opt["state"][i].items()}
    return params, opt
