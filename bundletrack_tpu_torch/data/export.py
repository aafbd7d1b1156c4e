"""Export a SyntheticSequence to disk in the reference dataset layouts.

The port's own copy of bundletrack_tpu/data/export.py.
Lets the full CLI chain — config -> loader -> PNG IO ->
tracker -> pose txt -> eval — run end-to-end against on-disk data in exactly
the directory conventions the reference consumes (reference YCBInEOAT layout:
src/DataLoader.cpp:289-384 — `cam_K.txt`, `rgb/<id>.png`, `depth/<id>.png`
in millimeters, `masks/<id>.png`, `annotated_poses/<id>.txt`; NOCS layout:
src/DataLoader.cpp:60-145).  Host-side
numpy + the port's own PNG codec.
"""

from __future__ import annotations

import os

import numpy as np

from bundletrack_tpu_torch.data.native_io import write_png
from bundletrack_tpu_torch.data.synthetic import SyntheticSequence


def cube_model_points(box_size: float = 0.2, n_per_edge: int = 9) -> np.ndarray:
    """Surface point samples of the synthetic cube (eval model analog of the
    reference's YCB `points.xyz` files, scripts/eval_ycbineoat.py:117-130)."""
    half = box_size / 2.0
    lin = np.linspace(-half, half, n_per_edge)
    a, b = np.meshgrid(lin, lin)
    a, b = a.ravel(), b.ravel()
    faces = []
    for axis in range(3):
        for sgn in (-half, half):
            p = np.zeros((len(a), 3), np.float32)
            p[:, axis] = sgn
            p[:, (axis + 1) % 3] = a
            p[:, (axis + 2) % 3] = b
            faces.append(p)
    return np.unique(np.concatenate(faces, 0), axis=0).astype(np.float32)


def export_ycbineoat_sequence(
    seq: SyntheticSequence, out_dir: str, box_size: float = 0.2
) -> str:
    """Write `seq` in YCBInEOAT layout; returns out_dir.

    Creates cam_K.txt, rgb/ (8-bit RGB), depth/ (16-bit mm), masks/,
    annotated_poses/ (ob_in_cam 4x4 txt) and model/points.xyz.
    """
    for sub in ("rgb", "depth", "masks", "annotated_poses", "model"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    np.savetxt(os.path.join(out_dir, "cam_K.txt"), seq.K, fmt="%.8f")
    F = seq.gray.shape[0]
    for f in range(F):
        fid = f"{f:05d}"
        rgb = np.repeat(
            (seq.gray[f] * 255.0 + 0.5).astype(np.uint8)[..., None], 3, axis=-1
        )
        write_png(os.path.join(out_dir, "rgb", fid + ".png"), rgb)
        write_png(
            os.path.join(out_dir, "depth", fid + ".png"),
            (seq.depth[f] * 1000.0 + 0.5).astype(np.uint16),
        )
        write_png(
            os.path.join(out_dir, "masks", fid + ".png"),
            (seq.mask[f] * 255).astype(np.uint8),
        )
        np.savetxt(
            os.path.join(out_dir, "annotated_poses", fid + ".txt"),
            seq.ob_in_cam[f], fmt="%.8f",
        )
    np.savetxt(
        os.path.join(out_dir, "model", "points.xyz"),
        cube_model_points(box_size), fmt="%.6f",
    )
    return out_dir


def export_nocs_sequence(seq: SyntheticSequence, root_dir: str, scene_id: int = 1, box_size: float = 0.2):
    """Write `seq` in NOCS-REAL275 layout; returns (scene_dir, mask_dir,
    gt_dir, model_path).

    Layout (reference src/DataLoader.cpp:60-243): `scene_<id>/` with
    `<fid>_color.png` / `<fid>_depth.png` (16-bit mm); masks and GT
    ob_in_cam poses live in separate dirs (the reference reads masks from
    mask_dir and converts poses externally).  Adds cam_K.txt (a loader
    extension; the real dataset uses the hardcoded REAL275 intrinsics).
    """
    scene = os.path.join(root_dir, f"scene_{scene_id}")
    mask_dir = os.path.join(root_dir, "masks")
    gt_dir = os.path.join(root_dir, "gt_poses")
    for d in (scene, mask_dir, gt_dir):
        os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(scene, "cam_K.txt"), seq.K, fmt="%.8f")
    for f in range(seq.gray.shape[0]):
        fid = f"{f:04d}"
        rgb = np.repeat((seq.gray[f] * 255.0 + 0.5).astype(np.uint8)[..., None], 3, axis=-1)
        write_png(os.path.join(scene, fid + "_color.png"), rgb)
        write_png(os.path.join(scene, fid + "_depth.png"), (seq.depth[f] * 1000.0 + 0.5).astype(np.uint16))
        write_png(os.path.join(mask_dir, fid + ".png"), (seq.mask[f] * 255).astype(np.uint8))
        np.savetxt(os.path.join(gt_dir, fid + ".txt"), seq.ob_in_cam[f], fmt="%.8f")
    model_path = os.path.join(root_dir, "points.xyz")
    np.savetxt(model_path, cube_model_points(box_size), fmt="%.6f")
    return scene, mask_dir, gt_dir, model_path
