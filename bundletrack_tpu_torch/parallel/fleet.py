"""Fleet tracking: S independent streams through one tracker step on one GPU.

Counterpart of bundletrack_tpu/parallel/fleet.py::init_fleet_state and
make_fleet_step without a mesh.  The JAX package batches S streams with
jax.vmap over the TrackerState pytree; here the step itself carries a
leading stream axis (tracker/bundler.make_batched_track_frame), so a fleet
frame issues about the launches of one stream's frame, makes at most the
same 2 device-to-host reads, and matches all S*P BA pairs in one launch of
the matcher kernel.

The streams advance in lockstep: all start at frame 0 and every step
advances every stream, as in the JAX fleet, which has no per-stream reset
either.  With the LF-Net frontend (`lfnet_apply`), the S masked ROI crops
go through one batched forward per fleet frame.  Sharding the streams over
several GPUs (`mesh`) is not ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.device import resolve_device
from bundletrack_tpu_torch.tracker.bundler import make_batched_track_frame
from bundletrack_tpu_torch.tracker.driver import _upload
from bundletrack_tpu_torch.tracker.state import (
    FrameObservation,
    TrackerState,
    _generator,
    init_tracker_state,
)

NOT_PORTED = "is not ported yet (ROADMAP Queue 1, item 8: multi-GPU)"


def init_fleet_state(cfg: TrackerConfig, H: int, W: int, num_streams: int, device=None,
                     seed: int = 0) -> TrackerState:
    """A TrackerState with a leading stream axis of `num_streams` on every
    tensor, all streams at frame 0; stream s draws its RANSAC phases from a
    generator seeded with seed + s (so a fleet of one equals Tracker(seed)).
    Runs on the card unless `device` says otherwise."""
    device = resolve_device(device)
    base = init_tracker_state(cfg, H, W, device, seed)

    def tile(x):
        return x[None].expand(num_streams, *x.shape).clone()

    return base._replace(
        **{n: tile(v) for n, v in base._asdict().items() if isinstance(v, torch.Tensor)},
        mappoints=type(base.mappoints)(*(tile(t) for t in base.mappoints)),
        rng=tuple(_generator(device, seed + s) for s in range(num_streams)),
    )


def make_fleet_step(cfg: TrackerConfig, H: int, W: int, mesh=None, lfnet_apply=None):
    """The multi-stream step: (state[S], obs[S], init_pose [S,4,4],
    phases=None) -> (state, TrackOutput[S]); `phases` as
    tracker/bundler.make_batched_track_frame takes them.  `lfnet_apply`
    (frontend/lfnet.make_lfnet_apply) is the LF-Net frontend, needed when
    cfg.frontend.kind is "lfnet"; it takes the S crops as one stack."""
    if mesh is not None:
        raise NotImplementedError(f"make_fleet_step: sharding streams over a device mesh {NOT_PORTED}")
    return make_batched_track_frame(cfg, H, W, lfnet_apply)


def fleet_observation(gray, depth, mask, K, device) -> FrameObservation:
    """One fleet frame from per-stream numpy arrays [S, H, W] (gray uint8 or
    float, depth uint16 millimeters or float meters, mask bool) and
    intrinsics [S, 3, 3], uploaded to `device`."""
    return FrameObservation(gray=_upload(gray, device), depth=_upload(depth, device),
                            mask=_upload(np.asarray(mask, bool), device),
                            K=_upload(np.asarray(K, np.float32), device))
