#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every CUDA kernel of
   the path from bundletrack_tpu_torch/csrc/ (one nvcc per source, in
   parallel).
2. Kernel phase: at the main-path shapes (P=120 pairs, N=512 keypoints,
   D=256) it calls the fused matcher's wrapper on card tensors and holds it
   against its plain PyTorch version on the same inputs, on three input
   sets — keypoints of rendered 480x640 frames, the same with every column
   gated out, and with half the keypoints invalid — and times both with
   CUDA events (median of 25 runs after warm-up).
3. Tracker phase: tracks a rendered 480x640 sequence with the default
   TrackerConfig (max_ba_frames=16 -> 120 BA pairs, M=256, 2000 RANSAC
   trials) and holds every frame to the pose bars of the test suite; the
   matcher's launch count must equal the number of tracked frames.
4. Prints one JSON line describing every kernel, the card's line, and as
   its last line {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and the last line is not
printed.  Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

P_PAIRS, N_KPTS, D_DESC = 120, 512, 256
NUM_FRAMES = 20
TIMED_RUNS = 25
DIST_ATOL = 1e-4  # the bf16-product dot summed in another order: ~1e-6 on O(1) distances
# The gate is bit-identical and the kernel deterministic, so `mutual` may
# differ only where a column minimum is a near tie (a dist difference of
# ~1e-6 flips it): at most this many of the P*N = 61440 rows, each logged.
MUTUAL_MAX_DIFF_ROWS = 8

# Published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor-core
# FLOP/s, plus the f32 rate outside the tensor cores for the gate arithmetic.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def build_kernels():
    from bundletrack_tpu_torch.kernels import build

    sources = sorted(f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        paths = list(pool.map(build.build, sources))
    log(f"built {len(paths)} kernel source(s) in {time.perf_counter() - t0:.1f} s: {sources}")


def cuda_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frame_features(seq, cfg, device):
    """Keypoints of every rendered frame through the port's own preprocess
    and frontend: desc [F,N,D], pts/normals [F,N,3], valid [F,N]."""
    import torch

    from bundletrack_tpu_torch.frontend.pipeline import extract_frame_features
    from bundletrack_tpu_torch.tracker.bundler import _normalize_obs, _preprocess
    from bundletrack_tpu_torch.tracker.state import FrameObservation

    K = torch.as_tensor(seq.K, device=device)
    feats = []
    for f in range(len(seq.gray)):
        obs = _normalize_obs(FrameObservation(
            gray=torch.as_tensor(seq.gray[f], device=device),
            depth=torch.as_tensor(seq.depth[f], device=device),
            mask=torch.as_tensor(seq.mask[f], device=device),
            K=K,
        ))
        mask, pts_map, nrm_map, val_map, _, _ = _preprocess(obs, cfg)
        feats.append(extract_frame_features(obs.gray, mask, pts_map, nrm_map, val_map, cfg.frontend))
    return [torch.stack([getattr(ff, k) for ff in feats]) for k in ("desc", "pts", "normals", "valid")]


def kernel_phase(seq, cfg, device) -> dict:
    import torch

    from bundletrack_tpu_torch.geometry.se3 import transform_normals, transform_points
    from bundletrack_tpu_torch.kernels import matching as km

    K_BA = cfg.bundle.max_ba_frames
    desc, pts, nrm, valid = frame_features(seq, cfg, device)
    desc, pts, nrm, valid = desc[:K_BA], pts[:K_BA], nrm[:K_BA], valid[:K_BA]
    poses = torch.as_tensor(np.linalg.inv(seq.ob_in_cam[:K_BA]), device=device)  # cam -> model
    world = transform_points(poses, pts)
    wnrm = transform_normals(poses, nrm)
    pi, pj = (torch.as_tensor(a, device=device) for a in np.triu_indices(K_BA, k=1))
    assert len(pi) == P_PAIRS and desc.shape[1:] == (N_KPTS, D_DESC), (len(pi), desc.shape)
    fc = cfg.feature_corres
    gates = dict(max_dist=fc.max_dist_no_neighbor, max_normal_deg=fc.max_normal_no_neighbor)
    base = [desc[pi], desc[pj], world[pi], world[pj], wnrm[pi], wnrm[pj], valid[pi], valid[pj]]
    far = list(base)
    far[3] = base[3] + 10.0  # every column gated out
    half = list(base)
    half[6] = base[6].clone()
    half[6][:, N_KPTS // 2:] = False  # half the A-side keypoints invalid

    max_err = 0.0
    for name, args in (("rendered", base), ("all_gated", far), ("half_invalid", half)):
        bb, dd, mm = km.fused_mutual_match(*args, **gates)
        rb, rd, rm = km.fused_mutual_match_reference(*args, **gates)
        torch.cuda.synchronize()
        has_k, has_r = dd < km.BIG, rd < km.BIG
        if not torch.equal(has_k, has_r):
            raise AssertionError(f"{name}: rows with a gated candidate differ")
        err = float((dd - rd)[has_k].abs().max()) if bool(has_k.any()) else 0.0
        # best_b identical on every row that is mutual on both sides
        both = mm & rm
        same_b = bool(torch.equal(bb[both], rb[both]))
        diff_rows = (mm != rm).nonzero().tolist()
        log(f"kernel[{name}]: rows with candidate {float(has_k.float().mean()):.4f}  "
            f"mutual {int(mm.sum())} vs plain {int(rm.sum())}  rows that differ {len(diff_rows)}  "
            f"best_b equal on mutual rows {same_b}  max |dist diff| {err:.3e}")
        for p, i in diff_rows:
            log(f"  mutual differs at pair {p} row {i}: kernel ({bool(mm[p, i])}, best_b {int(bb[p, i])}, "
                f"dist {float(dd[p, i]):.7g})  plain ({bool(rm[p, i])}, best_b {int(rb[p, i])}, "
                f"dist {float(rd[p, i]):.7g})")
        if not same_b or err > DIST_ATOL or len(diff_rows) > MUTUAL_MAX_DIFF_ROWS:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if name == "all_gated" and (bool(mm.any()) or bool(has_k.any())):
            raise AssertionError("all_gated: the kernel let a gated column through")
        if name == "half_invalid" and bool(mm[:, N_KPTS // 2:].any()):
            raise AssertionError("half_invalid: an invalid keypoint was matched")
        max_err = max(max_err, err)

    ms = cuda_median_ms(lambda: km.fused_mutual_match(*base, **gates))
    plain_ms = cuda_median_ms(lambda: km.fused_mutual_match_reference(*base, **gates))
    P, N, D = P_PAIRS, N_KPTS, D_DESC
    in_bytes = 2 * P * N * D * 4 + 4 * P * N * 3 * 4 + 2 * P * N  # desc, geometry, valid
    out_bytes = P * N * (4 + 4 + 1)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    # bf16 products (2 flops each) on the tensor-core rate + the f32 gate and
    # distance arithmetic (~20 flops per candidate) outside it
    ops_ms = (2 * P * N * N * D / BF16_FLOP_PER_S + 20 * P * N * N / F32_FLOP_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel fused_mutual_match at P={P} N={N} D={D}: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return {
        "name": "fused_mutual_match",
        "route": "cuda",
        "source": "bundletrack_tpu_torch/csrc/fused_mutual_match.cu",
        "replaces": "bundletrack_tpu/pallas_kernels/matching.py:165",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def tracker_phase(seq, cfg, card: str) -> int:
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, H, W, steady_median, timed_frames
    from bundletrack_tpu_torch.eval.metrics import adds_auc, pose_errors
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker

    tracker = Tracker(cfg, H, W)  # the card, by default
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    km.launches = 0  # count only the main path's launches
    poses, statuses, frame_ms = [], [], []
    for _, out, ms in timed_frames(tracker, seq, range(len(seq.gray)), init_pose):
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
        frame_ms.append(ms)
    launches = km.launches
    tracked = len(seq.gray) - 1
    log(f"tracker: statuses {statuses}")
    if launches != tracked:
        raise AssertionError(f"matcher launches {launches} != tracked frames {tracked}")
    worst_rot = worst_trans = 0.0
    for f, pose in enumerate(poses):
        if pose.shape != (4, 4) or not np.all(np.isfinite(pose)):
            raise AssertionError(f"frame {f}: pose is not a finite 4x4")
        rot, trans = pose_errors(pose, seq.ob_in_cam[f])
        worst_rot, worst_trans = max(worst_rot, rot), max(worst_trans, trans)
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    auc = adds_auc(poses, list(seq.ob_in_cam), model_pts)
    med = steady_median(frame_ms)
    log(f"tracker: {len(poses)} frames at {H}x{W}, worst rotation {worst_rot:.4f} deg, "
        f"worst translation {worst_trans * 1e3:.3f} mm, ADD-S AUC {auc:.2f}")
    log(f"tracker: median frame {med:.2f} ms ({1e3 / med:.2f} frames/s) over frames "
        f"{WARMUP_FRAMES}..{len(poses) - 1}, first frame {frame_ms[0]:.1f} ms, "
        f"matcher launches {launches} [{card}]")
    if any(s != 0 for s in statuses):
        raise AssertionError(f"not every frame is OK: {statuses}")
    if worst_rot >= 1.0 or worst_trans >= 0.005 or auc <= 95.0:
        raise AssertionError("pose bars missed (rotation < 1 deg, translation < 5 mm, ADD-S AUC > 95)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from bundletrack_tpu_torch.cardrun import H, W, card_line, render_main_sequence
    from bundletrack_tpu_torch.config import TrackerConfig

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()

    cfg = TrackerConfig()
    t0 = time.perf_counter()
    seq = render_main_sequence(NUM_FRAMES)
    log(f"rendered {NUM_FRAMES} frames at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")

    kernel = kernel_phase(seq, cfg, device)
    kernel["launches"] = tracker_phase(seq, cfg, card)

    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
