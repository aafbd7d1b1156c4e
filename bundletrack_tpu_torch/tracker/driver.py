"""Host driver: feeds frames to the tracker step.

Counterpart of bundletrack_tpu/tracker/driver.py (reference:
src/app/bundle_track_ycbineoat.cpp — loader.next() -> processNewFrame ->
saveNewframeResult).  Runs on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.device import resolve_device
from bundletrack_tpu_torch.tracker.bundler import make_track_frame
from bundletrack_tpu_torch.tracker.state import (
    FrameObservation,
    TrackerState,
    TrackOutput,
    init_tracker_state,
)
from bundletrack_tpu_torch.utils.profiling import annotate


def ba_pair_axis(cfg: TrackerConfig, mesh) -> Optional[str]:
    """The mesh axis that shards the BA pairs: cfg.bundle.ba_mesh_axis when
    a mesh is given and the axis is set; ValueError when the mesh lacks it."""
    axis = cfg.bundle.ba_mesh_axis or None
    if mesh is None or axis is None:
        return None
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"bundle.ba_mesh_axis={axis!r} not in mesh axes {mesh.mesh_dim_names}")
    return axis


def _upload(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:  # torch has few uint16 operations: widen on the host
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


class Tracker:
    """Single-stream tracker with the reference's per-frame API.

    `lfnet_apply` is the LF-Net frontend (frontend/lfnet.make_lfnet_apply)
    for cfg.frontend.kind "lfnet"; a module's weights move to the tracker's
    device.

    `mesh`: a DeviceMesh (parallel/distributed.make_mesh); with
    cfg.bundle.ba_mesh_axis naming one of its axes, the BA pair work of
    every frame is sharded over that axis (tracker/bundler.py), run by
    every rank of the axis on the same frames, with the same `seed`; each
    rank then holds the same poses.  Under a mesh the default device is the
    rank's card (parallel/distributed.initialize_multihost sets it)."""

    def __init__(self, cfg: TrackerConfig, H: int, W: int, lfnet_apply=None, device=None,
                 seed: int = 0, mesh=None):
        self.cfg = cfg
        self.H, self.W = H, W
        self.device = resolve_device(device)
        if isinstance(lfnet_apply, torch.nn.Module):
            lfnet_apply = lfnet_apply.to(self.device)
        self._step = make_track_frame(cfg, H, W, lfnet_apply, mesh=mesh, pair_axis=ba_pair_axis(cfg, mesh))
        self.state: TrackerState = init_tracker_state(cfg, H, W, self.device, seed)
        self.outputs = []

    def process_frame(
        self,
        gray: np.ndarray,  # [H, W] uint8 or float in [0, 1]
        depth: np.ndarray,  # [H, W] uint16 millimeters or float meters
        mask: np.ndarray,  # [H, W] bool
        K: np.ndarray,  # [3, 3]
        init_pose: Optional[np.ndarray] = None,
        phases=None,
    ) -> TrackOutput:
        """Track one frame.  `phases` optionally fixes the RANSAC phases
        (neighbour [3, n_rep], pairs [P, 3, n_rep]); by default they come
        from the tracker's generator."""
        if init_pose is None:
            init_pose = np.eye(4, dtype=np.float32)
        with annotate("bundletrack.upload"):
            obs = FrameObservation(
                gray=_upload(gray, self.device),
                depth=_upload(depth, self.device),
                mask=_upload(np.asarray(mask, bool), self.device),
                K=_upload(np.asarray(K, np.float32), self.device),
            )
            pose = _upload(np.asarray(init_pose, np.float32), self.device)
            if phases is not None:
                phases = tuple(torch.as_tensor(p if isinstance(p, torch.Tensor) else np.array(p),
                                               device=self.device) for p in phases)
        self.state, out = self._step(self.state, obs, pose, phases)
        self.outputs.append(out)
        return out

    def save_result(self, out_dir: str, frame_idx: int, out: TrackOutput) -> None:
        """Write ob_in_cam in the reference's poses/<id>.txt format
        (reference Bundler::saveNewframeResult, src/Bundler.cpp:362-377)."""
        pose_dir = os.path.join(out_dir, "poses")
        os.makedirs(pose_dir, exist_ok=True)
        np.savetxt(
            os.path.join(pose_dir, f"{frame_idx:05d}.txt"),
            out.ob_in_cam.detach().cpu().numpy(),
            fmt="%.8f",
        )


def track_sequence(cfg: TrackerConfig, seq, init_pose=None, lfnet_apply=None, device=None,
                   seed: int = 0):
    """Track a SyntheticSequence-like object; returns (ob_in_cam [F,4,4],
    statuses [F], tracker)."""
    F, H, W = seq.gray.shape
    tracker = Tracker(cfg, H, W, lfnet_apply=lfnet_apply, device=device, seed=seed)
    if init_pose is None:
        init_pose = np.linalg.inv(seq.ob_in_cam[0])
    poses, statuses = [], []
    for f in range(F):
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose=init_pose)
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
    return np.stack(poses), np.asarray(statuses), tracker
