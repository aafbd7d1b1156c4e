"""CLI app: segmentation masks for a video by label propagation.

Counterpart of bundletrack_tpu/apps/run_vos.py (reference:
transductive-vos.pytorch/run_video.py:56-73 args --img_dir --init_mask_file
--mask_save_dir, 77-160 run_one_video — per-frame ResNet features +
attention over sampled history, masks written as PNGs that the tracker
consumes through its mask_dir).  Reads the weights the repo ships
(checkpoints/vos_params.npz) unless --checkpoint names another npz or the
`params` directory of a train_vos checkpoint.  Runs on the card unless
--device says otherwise.

Usage:
    python -m bundletrack_tpu_torch.apps.run_vos --img_dir data/rgb \
        --init_mask_file data/masks/00000.png --mask_save_dir out/masks \
        [--checkpoint weights.npz | ckpt/vos/params] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VOS_CKPT = os.path.join(REPO_ROOT, "checkpoints", "vos_params.npz")  # the shipped weights


def _list_images(img_dir: str):
    names = sorted(f for f in os.listdir(img_dir) if f.lower().endswith(".png"))
    if not names:
        raise FileNotFoundError(f"no PNG images in {img_dir}")
    return [os.path.join(img_dir, f) for f in names]


def _to_rgb01(img) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype == np.uint16:
        return (arr[..., :3] / 65535.0).astype(np.float32)
    return (arr[..., :3] / 255.0).astype(np.float32)


def load_trained(ckpt_dir: str):
    """The VOSNet in a `params` directory that the port's train_vos wrote
    (utils/checkpoint.py), of the width and out_dim it holds."""
    from bundletrack_tpu_torch.models.vos import VOSNet
    from bundletrack_tpu_torch.utils.checkpoint import STATE_FILE, restore_tracker_state

    path = os.path.join(ckpt_dir, STATE_FILE)
    if not os.path.exists(path):
        raise ValueError(
            f"--checkpoint {ckpt_dir}: no {STATE_FILE}, so not a directory the port's train_vos wrote; "
            "an orbax checkpoint (the JAX package's) is unreadable here: export it with "
            "bundletrack_tpu.utils.params_io.save_params_npz and pass the npz"
        )
    with np.load(path) as data:
        width, out_dim = int(data["Conv_0.weight"].shape[0]), int(data["Conv_1.weight"].shape[0])
    model = VOSNet(out_dim=out_dim, width=width)
    model.load_state_dict(restore_tracker_state(ckpt_dir, model.state_dict()))
    return model


def load_model(checkpoint: str):
    """The VOSNet for --checkpoint: an npz of the JAX package's parameters
    (architecture read from the file), or the `params` directory of a
    train_vos checkpoint; "" means the shipped weights, or seeded random
    ones when they are absent."""
    from bundletrack_tpu_torch.models.vos import init_vos, load_vos_npz

    ckpt = checkpoint or (VOS_CKPT if os.path.exists(VOS_CKPT) else "")
    if ckpt.endswith(".npz"):
        model, _ = load_vos_npz(ckpt)
        print(f"[run_vos] weights: {ckpt} (width={model.width})", file=sys.stderr)
        return model
    if ckpt:
        model = load_trained(ckpt)
        print(f"[run_vos] weights: train_vos checkpoint {ckpt} (width={model.width})", file=sys.stderr)
        return model
    model, _ = init_vos(seed=0)
    print("[run_vos] WARNING: no --checkpoint given; using untrained weights "
          "(train with apps/train_vos.py)", file=sys.stderr)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--init_mask_file", required=True)
    parser.add_argument("--mask_save_dir", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="VOSNet weights: an npz, or train_vos's <ckpt-dir>/params; the shipped ones when not given")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--history-cap", type=int, default=0,
                        help="feature-ring capacity; 0 = SegmentationConfig default")
    parser.add_argument("--device", default=None, help="torch device; the CUDA card when not given")
    args = parser.parse_args(argv)

    from bundletrack_tpu_torch.config import SegmentationConfig
    from bundletrack_tpu_torch.data.native_io import SequencePrefetcher, read_png, write_png
    from bundletrack_tpu_torch.models.vos import VOSPropagator

    paths = _list_images(args.img_dir)
    if args.max_frames:
        paths = paths[: args.max_frames]
    first = _to_rgb01(read_png(paths[0]))
    H, W = first.shape[:2]
    model = load_model(args.checkpoint)

    init_mask = np.asarray(read_png(args.init_mask_file)) > 0
    if init_mask.ndim == 3:
        init_mask = init_mask[..., 0]

    os.makedirs(args.mask_save_dir, exist_ok=True)
    prop = VOSPropagator(model, SegmentationConfig(), H, W, history_cap=args.history_cap or None,
                         device=args.device)
    prop.first_frame(first, init_mask)
    # frame 0's mask is the given init mask (the reference writes it unchanged)
    write_png(os.path.join(args.mask_save_dir, os.path.basename(paths[0])), (init_mask * 255).astype(np.uint8))

    t0 = time.perf_counter()
    with SequencePrefetcher(paths) as fetch:
        for i in range(1, len(paths)):
            mask = prop.propagate(_to_rgb01(fetch.get(i)))
            write_png(os.path.join(args.mask_save_dir, os.path.basename(paths[i])),
                      (mask * 255).astype(np.uint8))
            if i % 20 == 0:
                rate = i / (time.perf_counter() - t0)
                print(f"[run_vos] frame {i}/{len(paths)} ({rate:.1f} fps)", file=sys.stderr)
    dt = time.perf_counter() - t0
    print(f"[run_vos] done: {len(paths)} masks in {dt:.1f}s -> {args.mask_save_dir}")
    return prop


if __name__ == "__main__":
    main()
