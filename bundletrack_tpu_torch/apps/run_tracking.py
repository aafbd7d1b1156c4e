"""CLI app: track a sequence from a reference-format YAML config.

Counterpart of bundletrack_tpu/apps/run_tracking.py (reference:
src/app/bundle_track_ycbineoat.cpp:42-80,
src/app/bundle_track_nocs.cpp:42-78, scripts/run_ycbineoat.py:49-72,
scripts/run_nocs.py:56-79).  Reads the reference's YAML schema unchanged
(config.load_config maps the keys), reads a YCBInEOAT directory or a NOCS
scene, and writes ob_in_cam poses as `debug_dir/poses/<id>.txt`, the
reference's format, so apps/eval_ycbineoat.py and apps/eval_nocs.py score
them.  Runs on the card unless --device says otherwise.

Usage:
    python -m bundletrack_tpu_torch.apps.run_tracking config.yml
    python -m bundletrack_tpu_torch.apps.run_tracking config.yml --frontend lfnet
    python -m bundletrack_tpu_torch.apps.run_tracking config.yml --dataset nocs
    python -m bundletrack_tpu_torch.apps.run_tracking config.yml --device cpu

The `done:` line ends with the step's counters over the run
(utils/profiling.py): steps, device-to-host reads by stage, streams
solved, GN iterations, GN solves captured and streams solved by replaying
them as CUDA graphs, keyframes admitted.  To see where a frame's time
goes, record a few frames with the step's spans and open
trace_dir/trace.json in Perfetto (ui.perfetto.dev):

    from bundletrack_tpu_torch.apps import run_tracking
    from bundletrack_tpu_torch.utils.profiling import trace
    with trace("trace_dir"):
        run_tracking.main(["config.yml", "--max-frames", "20"])
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LFNET_CKPT = os.path.join(REPO_ROOT, "checkpoints", "lfnet_params.npz")  # the shipped weights


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", help="reference-format YAML config")
    parser.add_argument("--dataset", choices=["ycbineoat", "nocs", "auto"], default="auto")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument(
        "--frontend", choices=["config", "classical", "lfnet"], default="config",
        help="keypoint frontend; 'config' uses the config's setting",
    )
    parser.add_argument(
        "--lfnet-ckpt", default=LFNET_CKPT,
        help="trained LF-Net weights (npz) for --frontend lfnet; a relative path opens "
             "relative to the working directory (default: the shipped checkpoints/lfnet_params.npz)",
    )
    parser.add_argument("--device", default=None,
                        help="torch device; the CUDA card when not given")
    args = parser.parse_args(argv)

    import yaml

    from bundletrack_tpu_torch.config import load_config, nocs_config, ycbineoat_config
    from bundletrack_tpu_torch.tracker.driver import Tracker
    from bundletrack_tpu_torch.utils.profiling import counters

    with open(args.config) as f:
        raw = yaml.safe_load(f)
    dataset = args.dataset
    if dataset == "auto":
        dataset = "nocs" if raw.get("use_6pack_datalist") else "ycbineoat"
    cfg = load_config(raw, nocs_config() if dataset == "nocs" else ycbineoat_config())
    if args.frontend != "config":
        cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, kind=args.frontend))

    lfnet_apply = None
    if cfg.frontend.kind == "lfnet":
        from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply

        _, lf_params = load_params_npz(args.lfnet_ckpt, cfg.frontend)
        lfnet_apply = make_lfnet_apply(cfg.frontend, lf_params)
        print(f"[run_tracking] lfnet frontend: {args.lfnet_ckpt}", file=sys.stderr)

    if dataset == "nocs":
        from bundletrack_tpu_torch.data.nocs import NocsLoader

        # GT ob_in_cam poses for the init pose (the reference converts the
        # NOCS GT to text poses and reads frame 0, src/DataLoader.cpp:80-86),
        # from a gt_poses/ dir next to the scene dir
        gt_dir = os.path.join(os.path.dirname(cfg.data_dir.rstrip("/")), "gt_poses")
        loader = NocsLoader(cfg.data_dir, cfg.model_name, mask_dir=cfg.mask_dir or None,
                            use_6pack_datalist=cfg.use_6pack_datalist,
                            gt_dir=gt_dir if os.path.isdir(gt_dir) else None)
    else:
        from bundletrack_tpu_torch.data.ycbineoat import YcbineoatLoader

        loader = YcbineoatLoader(cfg.data_dir, mask_dir=cfg.mask_dir or None)
    try:
        n = len(loader)
        if args.max_frames:
            n = min(n, args.max_frames)
        H, W = loader[0].gray.shape
        print(f"[run_tracking] {dataset}: {n} frames at {W}x{H}", file=sys.stderr)

        tracker = Tracker(cfg, H, W, lfnet_apply=lfnet_apply, device=args.device)
        pose_dir = os.path.join(cfg.debug_dir, "poses")
        os.makedirs(pose_dir, exist_ok=True)
        init_pose = loader.init_pose_in_model
        before = counters()
        t_start = time.perf_counter()
        for i in range(n):
            fd = loader[i]
            # raw sensor types go up as they are; the conversion runs on the
            # device.  As in the JAX app, the raw depth skips the loader's
            # zfar cut (the tracker's own depth processing applies its zfar)
            out = tracker.process_frame(fd.gray_u8, fd.depth_u16, fd.mask, loader.K, init_pose)
            np.savetxt(os.path.join(pose_dir, f"{fd.frame_id}.txt"),
                       out.ob_in_cam.cpu().numpy(), fmt="%.8f")
            if i % 20 == 0:
                rate = (i + 1) / (time.perf_counter() - t_start)
                print(f"[run_tracking] frame {fd.frame_id} status={int(out.status)} ({rate:.1f} fps)",
                      file=sys.stderr)
        dt = time.perf_counter() - t_start
    finally:
        loader.close()
    counts = " ".join(f"{k}={v}" for k, v in sorted((counters() - before).items()))
    print(f"[run_tracking] done: {n} frames in {dt:.1f}s ({n / dt:.2f} fps); {counts}")
    return tracker


if __name__ == "__main__":
    main()
