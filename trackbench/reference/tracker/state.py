"""Tracker state: one NamedTuple of fixed-shape tensors.

Counterpart of bundletrack_tpu/tracker/state.py (reference: src/Frame.h,
src/Bundler.h).  The fields and shapes are the JAX package's, except that
the JAX PRNG key becomes `rng`, an explicit torch.Generator on the state's
device that draws the RANSAC phases, and that `frame_count` is a host int:
the step branches on the first frame without reading the device.

A fleet's state (parallel/fleet.py) is the same NamedTuple with a leading
stream axis S on every tensor, a tuple of S generators and a tuple of S
host frame counts, one per stream as the JAX fleet's [S] `frame_count`:
streams may be at different frames, and a stream whose count is 0 starts
on the next step.  `set_streams` writes streams of one fleet state into
another, as the JAX pytree update `a.at[idx].set(b[idx])` does; it is how
a stream is reset to join a running fleet.

`state_from_numpy` / `state_to_numpy` and their fleet forms carry a state
across as numpy arrays, so both trackers can start from the same state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trackbench.reference.config import TrackerConfig
from trackbench.reference.matching.mappoints import MapPointTable, init_mappoints

# Frame status codes (reference src/Frame.h:48-53)
STATUS_OK = 0
STATUS_FAIL = 1
STATUS_NO_BA = 2


class FrameObservation(NamedTuple):
    """One RGB-D input frame on the device."""

    gray: torch.Tensor  # [H, W] f32 in [0, 1], or uint8
    depth: torch.Tensor  # [H, W] f32 meters (0 invalid), or int32 millimeters
    mask: torch.Tensor  # [H, W] bool segmentation
    K: torch.Tensor  # [3, 3]


class TrackerState(NamedTuple):
    """All persistent tracker state of one stream."""

    # keyframe pool (capacity Kp)
    kf_desc: torch.Tensor  # [Kp, N, D]
    kf_pts: torch.Tensor  # [Kp, N, 3] camera-frame keypoint positions
    kf_normals: torch.Tensor  # [Kp, N, 3]
    kf_kp_valid: torch.Tensor  # [Kp, N] bool
    kf_pose: torch.Tensor  # [Kp, 4, 4] cam -> model
    kf_dsrc: torch.Tensor  # [Kp, 6, C] compacted dense source planes
    kf_dvalid: torch.Tensor  # [Kp, C] bool
    kf_dlin: torch.Tensor  # [Kp, C] int32
    kf_tchan: torch.Tensor  # [Kp, Hd, Wd, 8] bf16 gather table
    kf_frame_id: torch.Tensor  # [Kp] int32, -1 = empty slot
    # previous frame (neighbour-matching target)
    prev_desc: torch.Tensor  # [N, D]
    prev_pts: torch.Tensor  # [N, 3]
    prev_normals: torch.Tensor  # [N, 3]
    prev_kp_valid: torch.Tensor  # [N] bool
    prev_pose: torch.Tensor  # [4, 4]
    prev_valid: torch.Tensor  # [] bool
    # landmark memory
    mappoints: MapPointTable
    # bookkeeping
    frame_count: int  # frames seen; a host int (the JAX state's [] int32); a fleet's: a tuple of S ints
    last_status: torch.Tensor  # [] int32
    need_reinit: torch.Tensor  # [] bool
    fail_streak: torch.Tensor  # [] int32: consecutive FAIL frames
    prev_delta: torch.Tensor  # [4, 4] constant-velocity delta
    pred_pose: torch.Tensor  # [4, 4] prediction for the next frame
    rng: torch.Generator  # draws the RANSAC phases; a fleet has one per stream


class TrackOutput(NamedTuple):
    ob_in_cam: torch.Tensor  # [4, 4] object pose in camera (reference format)
    pose_in_model: torch.Tensor  # [4, 4]
    status: torch.Tensor  # [] int32
    num_matches: torch.Tensor  # [] int32 neighbour inliers
    num_ba_edges: torch.Tensor  # [] int32


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_tracker_state(cfg: TrackerConfig, H: int, W: int, device, seed: int = 0) -> TrackerState:
    device = torch.device(device)
    Kp = cfg.keyframe.pool_size
    N = cfg.frontend.top_k
    D = cfg.frontend.desc_dim
    ds = cfg.bundle.image_downscale
    Hd, Wd = (H + ds - 1) // ds, (W + ds - 1) // ds
    C = min(Hd * Wd, cfg.bundle.dense_src_capacity)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    eye = torch.eye(4, **f32)
    return TrackerState(
        kf_desc=torch.zeros((Kp, N, D), **f32),
        kf_pts=torch.zeros((Kp, N, 3), **f32),
        kf_normals=torch.zeros((Kp, N, 3), **f32),
        kf_kp_valid=torch.zeros((Kp, N), **b),
        kf_pose=eye.expand(Kp, 4, 4).clone(),
        kf_dsrc=torch.zeros((Kp, 6, C), **f32),
        kf_dvalid=torch.zeros((Kp, C), **b),
        kf_dlin=torch.zeros((Kp, C), **i32),
        kf_tchan=torch.zeros((Kp, Hd, Wd, 8), dtype=torch.bfloat16, device=device),
        kf_frame_id=torch.full((Kp,), -1, **i32),
        prev_desc=torch.zeros((N, D), **f32),
        prev_pts=torch.zeros((N, 3), **f32),
        prev_normals=torch.zeros((N, 3), **f32),
        prev_kp_valid=torch.zeros((N,), **b),
        prev_pose=eye.clone(),
        prev_valid=torch.zeros((), **b),
        mappoints=init_mappoints(cfg.shapes.max_landmarks, Kp, N, device=device),
        frame_count=0,
        last_status=torch.full((), STATUS_OK, **i32),
        need_reinit=torch.zeros((), **b),
        fail_streak=torch.zeros((), **i32),
        prev_delta=eye.clone(),
        pred_pose=eye.clone(),
        rng=_generator(device, seed),
    )


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_numpy(arrays: dict, device, seed: int = 0) -> TrackerState:
    """Build a state from a dict of numpy arrays keyed by field name, such as
    the leaves of the JAX package's TrackerState (`state._asdict()` with
    each leaf as a numpy array).  `mappoints` may be a dict or any object
    with `obs` and `rev`.  Keys the port has no field for (the JAX PRNG
    key) are ignored; the generator is seeded with `seed`."""
    return _from_numpy(arrays, device, _generator(torch.device(device), seed))


def fleet_state_from_numpy(arrays: dict, device, seed: int = 0) -> TrackerState:
    """A fleet state from numpy arrays with a leading stream axis, such as
    the leaves of the JAX package's fleet state; each stream keeps its own
    frame count, and stream s's generator is seeded with seed + s."""
    counts = tuple(int(c) for c in np.asarray(arrays["frame_count"]).reshape(-1))
    device = torch.device(device)
    return _from_numpy(dict(arrays, frame_count=counts), device,
                       tuple(_generator(device, seed + s) for s in range(len(counts))))


def _from_numpy(arrays: dict, device, rng) -> TrackerState:
    device = torch.device(device)
    fields = {}
    for name in TrackerState._fields:
        if name == "rng":
            continue
        val = arrays[name]
        if name == "mappoints":
            obs = val["obs"] if isinstance(val, dict) else val.obs
            rev = val["rev"] if isinstance(val, dict) else val.rev
            fields[name] = MapPointTable(
                obs=_tensor_from_numpy(obs, device), rev=_tensor_from_numpy(rev, device)
            )
        elif name == "frame_count":
            fields[name] = val if isinstance(val, tuple) else int(val)
        else:
            fields[name] = _tensor_from_numpy(val, device)
    return TrackerState(**fields, rng=rng)


def state_to_numpy(state: TrackerState) -> dict:
    """The state's tensors as numpy arrays keyed by field name (bf16 as
    ml_dtypes.bfloat16, the dtype JAX uses, and frame_count as an int32
    array shaped as the JAX field: [] for one stream, [S] for a fleet); the
    generator is left out."""
    out = {}
    for name, val in state._asdict().items():
        if name == "rng":
            continue
        if name == "mappoints":
            out[name] = {"obs": _tensor_to_numpy(val.obs), "rev": _tensor_to_numpy(val.rev)}
        elif name == "frame_count":
            out[name] = np.asarray(val, np.int32)
        else:
            out[name] = _tensor_to_numpy(val)
    return out


fleet_state_to_numpy = state_to_numpy


def add_stream_axis(state: TrackerState) -> TrackerState:
    """One stream's state as a fleet of one (views, no copies)."""
    return state._replace(
        **{n: v[None] for n, v in state._asdict().items() if isinstance(v, torch.Tensor)},
        mappoints=MapPointTable(state.mappoints.obs[None], state.mappoints.rev[None]),
        frame_count=(state.frame_count,),
        rng=(state.rng,),
    )


def drop_stream_axis(state: TrackerState) -> TrackerState:
    """A fleet of one's state as one stream's state."""
    return state._replace(
        **{n: v[0] for n, v in state._asdict().items() if isinstance(v, torch.Tensor)},
        mappoints=MapPointTable(state.mappoints.obs[0], state.mappoints.rev[0]),
        frame_count=state.frame_count[0],
        rng=state.rng[0],
    )


def _stream_rows(idx, device) -> torch.Tensor:
    """Stream indices as int64 on the device (a copy from the host that the
    device does not wait for: no synchronisation)."""
    return torch.as_tensor(list(idx), dtype=torch.int64).to(device, non_blocking=True)


def _take_streams(state: TrackerState, idx) -> TrackerState:
    """Streams `idx` (host ints) of a fleet state, in that order, as a fleet
    state of their own; every tensor is gathered (a copy)."""
    rows = _stream_rows(idx, state.kf_pose.device)
    return state._replace(
        **{n: v.index_select(0, rows) for n, v in state._asdict().items() if isinstance(v, torch.Tensor)},
        mappoints=MapPointTable(*(t.index_select(0, rows) for t in state.mappoints)),
        frame_count=tuple(state.frame_count[s] for s in idx),
        rng=tuple(state.rng[s] for s in idx),
    )


def _put_streams(state: TrackerState, idx, part: TrackerState) -> TrackerState:
    """`state` with its stream idx[k] replaced by stream k of `part`, out of
    place: the result's tensors are new, `state` is left as it was."""
    rows = _stream_rows(idx, state.kf_pose.device)
    counts, rng = list(state.frame_count), list(state.rng)
    for k, s in enumerate(idx):
        counts[s], rng[s] = part.frame_count[k], part.rng[k]
    return state._replace(
        **{n: v.index_copy(0, rows, getattr(part, n).to(v.dtype)) for n, v in state._asdict().items()
           if isinstance(v, torch.Tensor)},
        mappoints=MapPointTable(*(a.index_copy(0, rows, b) for a, b in zip(state.mappoints, part.mappoints))),
        frame_count=tuple(counts),
        rng=tuple(rng),
    )


def set_streams(fleet: TrackerState, idx, other: TrackerState) -> TrackerState:
    """`fleet` with streams `idx` (host ints) taken from `other`, a fleet
    state of the same shapes: the port's spelling of the JAX pytree update
    `jax.tree.map(lambda a, b: a.at[idx].set(b[idx]), fleet, other)`.  With
    `other` a fresh init_fleet_state it resets those streams, which then
    start again on the next step with their own init pose.  Out of place;
    the streams' generators are `other`'s own objects."""
    return _put_streams(fleet, idx, _take_streams(other, idx))
