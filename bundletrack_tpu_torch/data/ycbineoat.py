"""YCBInEOAT dataset loader.

The port's own copy of bundletrack_tpu/data/ycbineoat.py.  Mirrors the
reference loader's directory conventions
(reference: src/DataLoader.cpp:289-384 DataLoaderYcbineoat — `cam_K.txt`,
`rgb/<id>.png`, `depth/<id>.png` in mm, `annotated_poses/<id>.txt`
ground-truth ob_in_cam, masks from a separate mask_dir;
readDepthImage converts mm -> m and zeroes depths < 0.1 m,
src/Utils.cpp:49-68).  Frames are decoded ahead on threads
(data/native_io.SequencePrefetcher), so decoding overlaps the tracker step.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from bundletrack_tpu_torch.data.native_io import SequencePrefetcher


class FrameData(NamedTuple):
    gray: np.ndarray  # [H, W] float32 in [0, 1]
    color: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] float32 meters
    mask: np.ndarray  # [H, W] bool
    frame_id: str
    gray_u8: Optional[np.ndarray] = None  # [H, W] uint8 (raw streaming path)
    depth_u16: Optional[np.ndarray] = None  # [H, W] uint16 mm (raw path)


def _to_gray(color: np.ndarray) -> np.ndarray:
    c = color.astype(np.float32) / 255.0
    if c.ndim == 2:
        return c
    # reference images are BGR via cv::imread; luma weights are symmetric
    # enough for the detector — use Rec.601 on channel order as stored.
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def _to_gray_u8(color: np.ndarray) -> np.ndarray:
    """Integer Rec.601 luma — the uint8 frame the tracker uploads (the
    conversion to float runs on the device: tracker/bundler.py
    _normalize_obs)."""
    if color.ndim == 2:
        return color.astype(np.uint8)
    c = color.astype(np.uint16)
    return ((77 * c[..., 0] + 150 * c[..., 1] + 29 * c[..., 2]) >> 8).astype(
        np.uint8
    )


class YcbineoatLoader:
    """Iterates FrameData; exposes K, GT poses, and the init pose."""

    def __init__(self, data_dir: str, mask_dir: Optional[str] = None, zfar: float = 2.0):
        self.data_dir = data_dir
        self.mask_dir = mask_dir or os.path.join(data_dir, "masks")
        self.zfar = zfar
        self.K = np.loadtxt(os.path.join(data_dir, "cam_K.txt")).reshape(3, 3).astype(np.float32)

        rgb_dir = os.path.join(data_dir, "rgb")
        self.ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(rgb_dir) if f.endswith(".png")
        )
        if not self.ids:
            raise FileNotFoundError(f"no rgb frames in {rgb_dir}")
        self.color_files = [os.path.join(rgb_dir, i + ".png") for i in self.ids]
        self.depth_files = [
            os.path.join(data_dir, "depth", i + ".png") for i in self.ids
        ]
        self.mask_files = [os.path.join(self.mask_dir, i + ".png") for i in self.ids]

        gt_dir = os.path.join(data_dir, "annotated_poses")
        self.gt_files = (
            [os.path.join(gt_dir, f) for f in sorted(os.listdir(gt_dir))]
            if os.path.isdir(gt_dir)
            else []
        )
        self.ob_in_cam0 = (
            np.loadtxt(self.gt_files[0]).reshape(4, 4).astype(np.float32)
            if self.gt_files
            else np.eye(4, dtype=np.float32)
        )

        self._color_pf = SequencePrefetcher(self.color_files)
        self._depth_pf = SequencePrefetcher(self.depth_files)
        self._mask_pf = (
            SequencePrefetcher(self.mask_files)
            if all(os.path.exists(p) for p in self.mask_files)
            else None
        )

    def __len__(self):
        return len(self.ids)

    def close(self) -> None:
        """Stop the decoding threads."""
        for pf in (self._color_pf, self._depth_pf, self._mask_pf):
            if pf is not None:
                pf.close()

    @property
    def init_pose_in_model(self) -> np.ndarray:
        """pose0 = ob_in_cam0^-1 (reference DataLoader.cpp:371-380)."""
        return np.linalg.inv(self.ob_in_cam0)

    def gt_pose(self, idx: int) -> Optional[np.ndarray]:
        if idx < len(self.gt_files):
            return np.loadtxt(self.gt_files[idx]).reshape(4, 4).astype(np.float32)
        return None

    def __getitem__(self, idx: int) -> FrameData:
        color = self._color_pf.get(idx)
        depth_raw = self._depth_pf.get(idx)
        depth = depth_raw.astype(np.float32) / 1000.0
        depth[(depth < 0.1) | (depth > self.zfar)] = 0.0
        if self._mask_pf is not None:
            mask = self._mask_pf.get(idx)
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = mask > 0
        else:
            mask = np.ones(depth.shape, bool)
        return FrameData(
            gray=_to_gray(color),
            color=color,
            depth=depth,
            mask=mask,
            frame_id=self.ids[idx],
            gray_u8=_to_gray_u8(color),
            depth_u16=depth_raw.astype(np.uint16),
        )
