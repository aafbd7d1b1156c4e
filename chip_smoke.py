#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every CUDA kernel of
   the paths from bundletrack_tpu_torch/csrc/ (one nvcc per source, in
   parallel).
2. Kernel phase: on the BA table that the tracker builds at full width
   (K=16 frames of N=512 keypoints, D=256, all P=120 pairs) it calls the
   fused matcher's table-form wrapper on card tensors and holds it against
   its plain PyTorch version on the same inputs, on five input sets —
   keypoints of rendered 480x640 frames, the same with every column gated
   out, with half the keypoints invalid, with exact ties, and the table the
   LF-Net frontend makes on the same frames — and times both with CUDA
   events (median of 25 runs after warm-up), beside the dot alone in
   torch.bmm as a yardstick.  The bound is the largest of three terms:
   bytes, bf16 products and the epilogue's f32 instructions.
3. Tracker phase: tracks a rendered 480x640 sequence with the default
   TrackerConfig (classical frontend, max_ba_frames=16 -> 120 BA pairs,
   M=256, 2000 RANSAC trials) and holds every frame to the pose bars of the
   test suite; the matcher's launch count must equal the number of tracked
   frames.
4. LF-Net forward alone at 400x400 in bf16 with the shipped weights
   (checkpoints/lfnet_params.npz), CUDA events, median of 25 after warm-up.
5. CLI phase: writes the same 20 frames as a YCBInEOAT directory, writes a
   reference-format config at the default widths, runs
   `apps.run_tracking --frontend lfnet` on the card, scores the pose files
   with `apps.eval_ycbineoat` and holds them to the bars of
   tests/test_e2e_parity.py (ADD-S AUC > 90, ADD AUC > 80); the matcher's
   launch count must equal the number of tracked frames.
6. VOS phase: propagates frame 0's mask through the 20 frames with the
   shipped width-96 weights (checkpoints/vos_params.npz) and the default
   SegmentationConfig (ref_num 9, history 48, sigma 8/21, T 0.05, a 60x80
   grid); bars: per-frame IoU against the renderer's masks, mean >= 0.95
   and min >= 0.94.  The card's masks and soft labels on the first three
   propagated frames are held to the port on the CPU (masks differ on at
   most 0.5 % of pixels).  Then `vos_bench.vos_report`: ms per propagate,
   device time, launches, top kernels, the stage split, peak memory, bound.
7. VOS -> tracker chain: `apps.run_vos` on the exported rgb/ directory from
   masks/00000.png, then `apps.run_tracking` (classical frontend, default
   widths) with mask_dir the VOS masks, then `apps.eval_ycbineoat`; bars:
   0 missing, ADD-S AUC > 85, matcher launches = tracked frames.
8. NOCS chain: the frames exported with `export_nocs_sequence`, a config at
   `nocs_config`'s default widths (use_6pack_datalist false),
   `apps.run_tracking --dataset nocs`, then `apps.eval_nocs --noise_trans
   0.02 --seed 0`; bars: 0 missing, IoU25 > 90, 5deg5cm > 70, matcher
   launches = tracked frames; the NOCS mask fills timed alone.
9. Prints one JSON line describing every kernel (the matcher's launches
   summed over phases 3, 5, 7 and 8), the card's line, and as its last
   line {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and the last line is not
printed.  Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

K_BA, P_PAIRS, N_KPTS, D_DESC = 16, 120, 512, 256
NUM_FRAMES = 20
LFNET_CKPT = "checkpoints/lfnet_params.npz"  # a relative path: the app resolves it against the repo root
CLI_ADDS_AUC_MIN, CLI_ADD_AUC_MIN = 90.0, 80.0  # tests/test_e2e_parity.py
# VOS on the 20 rendered 480x640 frames: the JAX package reaches mean IoU
# 0.9685 and min 0.9623 there (on a CPU); the card must reach these bars,
# and its masks may differ from the port's on the CPU on at most this share
# of pixels (bf16 products and f32 sums in another order)
VOS_MEAN_IOU_MIN, VOS_MIN_IOU_MIN, VOS_CPU_DIFF_MAX = 0.95, 0.94, 0.005
VOS_CHAIN_ADDS_AUC_MIN = 85.0  # tests/test_vos_quality.py::test_vos_masks_drive_tracker
NOCS_IOU25_MIN, NOCS_5D5CM_MIN = 90.0, 70.0  # tests/test_e2e_parity.py::TestE2ENocs
DIST_ATOL = 1e-4  # the bf16-product dot summed in another order: ~1e-6 on O(1) distances
# The gate is bit-identical and the kernel deterministic, so `mutual` may
# differ only where a column minimum is a near tie (a dist difference of
# ~1e-6 flips it): at most this many of the P*N = 61440 rows, each logged.
MUTUAL_MAX_DIFF_ROWS = 8

# Published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor-core
# FLOP/s; and the f32 instruction rate outside the tensor cores, 132 SMs x
# 128 FP32 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_INSTR_PER_S = 132 * 128 * 1.98e9
# f32 instructions per candidate in the kernel's epilogue (csrc/
# fused_mutual_match.cu, gated_dist and the loop around it): distance 2
# (add, fma), gate 13 (3 sub, 6 mul, 4 add), 2 compares and 1 select,
# row minimum 2 (compare, select), column minimum 2 (select, min)
GATE_INSTR_PER_CANDIDATE = 22


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def timed_calls(cls, name: str):
    """Times every call of the method cls.name with CUDA events; yields the
    list of ms it fills."""
    import torch

    original = getattr(cls, name)
    ms = []

    def timed(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(self, *args, **kwargs)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        return out

    setattr(cls, name, timed)
    try:
        yield ms
    finally:
        setattr(cls, name, original)


def build_kernels():
    from bundletrack_tpu_torch.kernels import build

    sources = sorted(f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        paths = list(pool.map(build.build, sources))
    log(f"built {len(paths)} kernel source(s) in {time.perf_counter() - t0:.1f} s: {sources}")


def kernel_inputs(table, lfnet_table):
    """The five input sets: the classical BA table as rendered; every column
    gated out (frames 10 m apart); the upper half of every frame's keypoints
    invalid (A side and B side); exact ties (descriptors in multiples of
    1/64, so the dot is exact in any sum order, and keypoint 2m+1 a copy of
    keypoint 2m, so each row ties between 2m and 2m+1); and the BA table of
    LF-Net keypoints on the same frames (unit-norm learned descriptors, so
    distances lie in [0, 4])."""
    import torch

    desc, world, wnrm, valid = table
    K, N = valid.shape
    far = world + 10.0 * torch.arange(K, device=world.device, dtype=world.dtype)[:, None, None]
    half = valid.clone()
    half[:, N // 2:] = False
    ties = [torch.round(desc * 64) / 64, world.clone(), wnrm.clone(), valid.clone()]
    for t in ties:
        t[:, 1::2] = t[:, 0::2]
    return {
        "rendered": table,
        "all_gated": (desc, far, wnrm, valid),
        "half_invalid": (desc, world, wnrm, half),
        "exact_ties": tuple(ties),
        "lfnet": lfnet_table,
    }


def check_kernel(name, got, ref) -> float:
    """Holds the kernel's results to the plain version's; returns the largest
    |dist| difference on rows with a candidate."""
    import torch

    from bundletrack_tpu_torch.kernels import matching as km

    (bb, dd, mm), (rb, rd, rm) = got, ref
    has_k, has_r = dd < km.BIG, rd < km.BIG
    if not torch.equal(has_k, has_r):
        raise AssertionError(f"{name}: rows with a gated candidate differ")
    err = float((dd - rd)[has_k].abs().max()) if bool(has_k.any()) else 0.0
    both = mm & rm  # best_b identical on every row that is mutual on both sides
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
    if not bool((bb[~has_k] == 0).all()):
        raise AssertionError(f"{name}: a row without a candidate has best_b != 0")
    N = dd.shape[1]
    if name == "all_gated" and (bool(mm.any()) or bool(has_k.any())):
        raise AssertionError("all_gated: the kernel let a gated column through")
    if name == "half_invalid" and (bool(has_k[:, N // 2:].any()) or bool((bb[has_k] >= N // 2).any())):
        raise AssertionError("half_invalid: an invalid keypoint has a candidate")
    if name == "exact_ties":
        # exact arithmetic on both sides: equal results, the first of each
        # duplicate wins, and no near tie can flip `mutual`
        if not (torch.equal(dd, rd) and torch.equal(bb, rb) and torch.equal(mm, rm)):
            raise AssertionError("exact_ties: the kernel differs from the plain version")
        if not bool((bb[has_k] % 2 == 0).all()):
            raise AssertionError("exact_ties: a tie did not go to the first index")
    if name in ("rendered", "half_invalid", "exact_ties", "lfnet") and int(mm.sum()) < 1000:
        raise AssertionError(f"{name}: too few mutual matches")
    return err


def kernel_phase(seq, cfg, device, lf_cfg, lfnet) -> dict:
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.matcher_bench import ba_table

    table, (pi, pj) = ba_table(seq, cfg, device)
    lfnet_table, _ = ba_table(seq, lf_cfg, device, lfnet)
    desc = table[0]
    K, N, D = desc.shape
    P = len(pi)
    for t in (table, lfnet_table):
        if (t[0].shape[0], P, t[0].shape[1], t[0].shape[2]) != (K_BA, P_PAIRS, N_KPTS, D_DESC):
            raise AssertionError(f"BA table shape {tuple(t[0].shape)}, P={P}")
    log(f"lfnet BA table: {int(lfnet_table[3].sum())} valid keypoints over {K} frames "
        f"(classical {int(table[3].sum())})")
    fc = cfg.feature_corres
    gates = dict(max_dist=fc.max_dist_no_neighbor, max_normal_deg=fc.max_normal_no_neighbor)

    max_err = 0.0
    for name, args in kernel_inputs(table, lfnet_table).items():
        got = km.fused_mutual_match_pairs(*args, pi, pj, **gates)
        ref = km.fused_mutual_match_pairs_reference(*args, pi, pj, **gates)
        torch.cuda.synchronize()
        max_err = max(max_err, check_kernel(name, got, ref))

    ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs(*table, pi, pj, **gates))
    plain_ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs_reference(*table, pi, pj, **gates))
    # yardstick: the descriptor dot alone, on operands gathered beforehand
    # (the port never calls it, and it is not the whole function)
    a = desc[pi.long()].to(torch.bfloat16)
    bt = desc[pj.long()].to(torch.bfloat16).transpose(1, 2)
    dot_ms = cuda_median_ms(lambda: torch.bmm(a, bt))
    log(f"yardstick: torch.bmm on the gathered bf16 operands (dot only) {dot_ms:.4f} ms")

    # the least time for the same work: the largest of three terms
    in_bytes = K * N * D * 4 + 2 * K * N * 3 * 4 + K * N + 2 * P * 4  # table, geometry, valid, pairs
    out_bytes = P * N * (4 + 4 + 1)
    terms = {
        "bytes": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
        "bf16 products": 2 * P * N * N * D / BF16_FLOP_PER_S * 1e3,
        "gate instructions": GATE_INSTR_PER_CANDIDATE * P * N * N / F32_INSTR_PER_S * 1e3,
    }
    term = max(terms, key=terms.get)
    bound_ms = terms[term]
    log("bound terms: " + ", ".join(f"{k} {v:.5f} ms" for k, v in terms.items()))
    log(f"kernel fused_mutual_match_pairs at K={K} P={P} N={N} D={D}: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms:.5f} ms ({term})  {100 * bound_ms / ms:.1f} % of bound")
    return {
        "name": "fused_mutual_match_pairs",
        "route": "cuda",
        "source": "bundletrack_tpu_torch/csrc/fused_mutual_match.cu",
        "replaces": "bundletrack_tpu/pallas_kernels/matching.py:165",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if term == "bytes" else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def tracker_phase(seq, cfg, card: str) -> int:
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, H, W, steady_median, timed_frames
    from bundletrack_tpu_torch.eval.metrics import adds_auc, pose_errors
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker

    tracker = Tracker(cfg, H, W)  # the card, by default
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    km.launches = 0  # count only this path's launches
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


def lfnet_forward_phase(seq, lf_cfg, lfnet, card: str) -> float:
    """The LF-Net forward alone on the masked ROI crop of frame 0 at
    input_size (400x400), CUDA events, median of 25 runs after warm-up."""
    import torch

    from bundletrack_tpu_torch.cardrun import TIMED_RUNS, cuda_median_ms, masked_crop

    S = lf_cfg.frontend.input_size
    crop = masked_crop(seq, 0, S)
    out = lfnet(crop[..., None])
    n_valid = int(out.valid.sum())
    if not (bool(torch.isfinite(out.desc).all()) and n_valid > 0):
        raise AssertionError("lfnet forward: non-finite descriptors or no valid keypoint")
    ms = cuda_median_ms(lambda: lfnet(crop[..., None]))
    dtype = "bf16" if lf_cfg.frontend.bf16 else "f32"
    log(f"lfnet forward at {S}x{S} {dtype}, top_k {lf_cfg.frontend.top_k}: median {ms:.4f} ms "
        f"over {TIMED_RUNS} runs, {n_valid} valid keypoints [{card}]")
    return ms


def write_config(root: str, data_dir: str, out_dir: str, mask_dir: str = "") -> str:
    """A reference-format config at the default widths; the sequence length
    is the one reduction.  Masks from data_dir/masks unless mask_dir says."""
    cfg = {
        "data_dir": data_dir,
        "mask_dir": mask_dir or os.path.join(data_dir, "masks"),
        "debug_dir": out_dir,
        "LOG": 0,
        "bundle": {"num_iter_outter": 7, "max_BA_frames": 16},
        "frontend": {"top_k": 512, "input_size": 400, "net_num_scales": 5, "bf16": True},
        "ransac": {"max_iter": 2000},
        "shapes": {"max_matches": 256},
    }
    import yaml

    path = os.path.join(root, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def cli_phase(seq, card: str) -> int:
    from bundletrack_tpu_torch.apps import eval_ycbineoat, run_tracking
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, steady_median
    from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
    from bundletrack_tpu_torch.eval.metrics import pose_errors
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker import driver

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        data_dir = export_ycbineoat_sequence(seq, os.path.join(root, "cube"))
        out_dir = os.path.join(root, "out")
        cfg_path = write_config(root, data_dir, out_dir)
        log(f"cli: exported {len(seq.gray)} frames to a YCBInEOAT directory in "
            f"{time.perf_counter() - t0:.1f} s")

        # time each tracked frame of the app with CUDA events
        with timed_calls(driver.Tracker, "process_frame") as frame_ms:
            km.launches = 0  # count only this path's launches
            t0 = time.perf_counter()
            tracker = run_tracking.main([cfg_path, "--frontend", "lfnet", "--lfnet-ckpt", LFNET_CKPT])
            chain_s = time.perf_counter() - t0
            launches = km.launches

        pose_dir = os.path.join(out_dir, "poses")
        gt_dir = os.path.join(data_dir, "annotated_poses")
        ids = sorted(os.path.splitext(f)[0] for f in os.listdir(gt_dir))
        if sorted(os.path.splitext(f)[0] for f in os.listdir(pose_dir)) != ids or len(ids) != len(seq.gray):
            raise AssertionError(f"cli: pose files {sorted(os.listdir(pose_dir))} != frames {ids}")
        worst_rot = worst_trans = 0.0
        for f, fid in enumerate(ids):
            pose = np.loadtxt(os.path.join(pose_dir, fid + ".txt"))
            if pose.shape != (4, 4) or not np.all(np.isfinite(pose)):
                raise AssertionError(f"cli: pose {fid} is not a finite 4x4")
            rot, trans = pose_errors(pose, seq.ob_in_cam[f])
            worst_rot, worst_trans = max(worst_rot, rot), max(worst_trans, trans)
        model_pts = eval_ycbineoat.load_model_points(os.path.join(data_dir, "model", "points.xyz"))
        res = eval_ycbineoat.evaluate(pose_dir, gt_dir, model_pts)

    statuses = [int(o.status) for o in tracker.outputs]
    tracked = len(statuses) - 1
    med = steady_median(frame_ms)
    log(f"cli: statuses {statuses}")
    log(f"cli: lfnet chain at default widths, {len(statuses)} frames: {statuses.count(0)} OK, "
        f"worst rotation {worst_rot:.4f} deg, worst translation {worst_trans * 1e3:.3f} mm, "
        f"ADD AUC {res['ADD_AUC']:.2f}, ADD-S AUC {res['ADDS_AUC']:.2f}, missing {res['missing']}")
    log(f"cli: median tracked frame {med:.2f} ms (CUDA events around process_frame, frames "
        f"{WARMUP_FRAMES}..{len(frame_ms) - 1}), first frame {frame_ms[0]:.1f} ms, whole app "
        f"{chain_s:.1f} s ({1e3 * chain_s / len(statuses):.1f} ms per frame with IO and start-up), "
        f"matcher launches {launches} [{card}]")
    if launches != tracked:
        raise AssertionError(f"cli: matcher launches {launches} != tracked frames {tracked}")
    if res["missing"] or res["ADDS_AUC"] <= CLI_ADDS_AUC_MIN or res["ADD_AUC"] <= CLI_ADD_AUC_MIN:
        raise AssertionError(f"cli: pose bars missed (ADD-S AUC > {CLI_ADDS_AUC_MIN}, "
                             f"ADD AUC > {CLI_ADD_AUC_MIN}): {res}")
    return launches


def vos_phase(seq, card: str) -> dict:
    """Propagation on the card at 480x640 against the renderer's masks and
    against the port on the CPU, then the VOS profile (vos_bench)."""
    from bundletrack_tpu_torch.config import SegmentationConfig
    from bundletrack_tpu_torch.eval.vos_eval import evaluate_vos
    from bundletrack_tpu_torch.models.vos import load_vos_npz
    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.vos_bench import vos_report

    n_check = 3
    model, _ = load_vos_npz(VOS_CKPT)
    card_r = evaluate_vos(model, SegmentationConfig(), seq, device="cuda")
    ious = card_r["per_frame"]
    log(f"vos: per-frame IoU at {seq.gray.shape[1]}x{seq.gray.shape[2]}, shipped width-{model.width} weights: "
        + " ".join(f"{x:.4f}" for x in ious))
    log(f"vos: mean IoU {np.mean(ious):.4f}, min {np.min(ious):.4f} over {len(ious)} propagated frames "
        f"(bars >= {VOS_MEAN_IOU_MIN}, >= {VOS_MIN_IOU_MIN}) [{card}]")

    cpu_r = evaluate_vos(model, SegmentationConfig(), seq, num_frames=n_check + 1, device="cpu")
    worst_share = 0.0
    for f in range(n_check):
        share = float((cpu_r["masks"][f] != card_r["masks"][f]).mean())
        worst_share = max(worst_share, share)
        log(f"vos: frame {f + 1} card vs CPU: masks differ on {share * 100:.4f} % of pixels, "
            f"max |soft diff| {float(np.abs(cpu_r['soft'][f] - card_r['soft'][f]).max()):.3e}")
    if worst_share > VOS_CPU_DIFF_MAX:
        raise AssertionError(f"vos: card and CPU masks differ on {worst_share * 100:.3f} % of pixels "
                             f"(at most {VOS_CPU_DIFF_MAX * 100} %)")
    if np.mean(ious) < VOS_MEAN_IOU_MIN or np.min(ious) < VOS_MIN_IOU_MIN:
        raise AssertionError(f"vos: IoU bars missed: mean {np.mean(ious):.4f}, min {np.min(ious):.4f}")
    return vos_report(seq, card)


def vos_chain_phase(seq, card: str) -> int:
    """run_vos on the exported frames from the first mask, then run_tracking
    on its masks, then eval_ycbineoat."""
    from bundletrack_tpu_torch.apps import eval_ycbineoat, run_tracking, run_vos
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, steady_median
    from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
    from bundletrack_tpu_torch.data.native_io import read_png
    from bundletrack_tpu_torch.eval.vos_eval import mask_iou
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.models.vos import VOSPropagator
    from bundletrack_tpu_torch.tracker import driver

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vos_") as root:
        data_dir = export_ycbineoat_sequence(seq, os.path.join(root, "cube"))
        vos_dir = os.path.join(root, "vos_masks")
        with timed_calls(VOSPropagator, "propagate") as vos_ms:
            t0 = time.perf_counter()
            run_vos.main(["--img_dir", os.path.join(data_dir, "rgb"),
                          "--init_mask_file", os.path.join(data_dir, "masks", "00000.png"),
                          "--mask_save_dir", vos_dir])
            vos_s = time.perf_counter() - t0
        names = sorted(os.listdir(vos_dir))
        if len(names) != len(seq.gray):
            raise AssertionError(f"vos chain: {len(names)} mask files for {len(seq.gray)} frames")
        ious = [mask_iou(read_png(os.path.join(vos_dir, n)) > 0, seq.mask[f]) for f, n in enumerate(names)]
        out_dir = os.path.join(root, "out")
        cfg_path = write_config(root, data_dir, out_dir, mask_dir=vos_dir)
        with timed_calls(driver.Tracker, "process_frame") as frame_ms:
            km.launches = 0  # count only this path's launches
            t0 = time.perf_counter()
            tracker = run_tracking.main([cfg_path, "--frontend", "classical"])
            track_s = time.perf_counter() - t0
            launches = km.launches
        res = eval_ycbineoat.evaluate(
            os.path.join(out_dir, "poses"), os.path.join(data_dir, "annotated_poses"),
            eval_ycbineoat.load_model_points(os.path.join(data_dir, "model", "points.xyz")))

    statuses = [int(o.status) for o in tracker.outputs]
    tracked = len(statuses) - 1
    log(f"vos chain: run_vos {len(names)} masks in {vos_s:.1f} s, propagate median "
        f"{steady_median(vos_ms):.2f} ms (CUDA events, frames {WARMUP_FRAMES + 1}..{len(vos_ms)}), "
        f"first {vos_ms[0]:.1f} ms; VOS mask IoU mean {np.mean(ious):.4f}, min {np.min(ious):.4f}")
    log(f"vos chain: run_tracking on the VOS masks (classical, default widths): statuses {statuses}; "
        f"median tracked frame {steady_median(frame_ms):.2f} ms (CUDA events around process_frame), whole app "
        f"{track_s:.1f} s; ADD AUC {res['ADD_AUC']:.2f}, ADD-S AUC {res['ADDS_AUC']:.2f}, "
        f"missing {res['missing']}, matcher launches {launches} [{card}]")
    if launches != tracked:
        raise AssertionError(f"vos chain: matcher launches {launches} != tracked frames {tracked}")
    if res["missing"] or res["ADDS_AUC"] <= VOS_CHAIN_ADDS_AUC_MIN:
        raise AssertionError(f"vos chain: pose bars missed (0 missing, ADD-S AUC > {VOS_CHAIN_ADDS_AUC_MIN}): {res}")
    return launches


def nocs_phase(seq, card: str) -> int:
    """The NOCS layout on disk, run_tracking --dataset nocs at the preset's
    default widths, eval_nocs with the reference's init-pose noise; and the
    NOCS mask fills timed alone."""
    import torch
    import yaml

    from bundletrack_tpu_torch.apps import eval_nocs, run_tracking
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, cuda_median_ms, steady_median
    from bundletrack_tpu_torch.config import nocs_config
    from bundletrack_tpu_torch.data.export import export_nocs_sequence
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.ops import masks
    from bundletrack_tpu_torch.tracker import driver

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nocs_") as root:
        scene, mask_dir, gt_dir, model_path = export_nocs_sequence(seq, os.path.join(root, "nocs"))
        out_dir = os.path.join(root, "out")
        cfg_path = os.path.join(root, "config_nocs.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"data_dir": scene, "mask_dir": mask_dir, "model_name": "camera_synthetic",
                            "debug_dir": out_dir, "LOG": 0, "use_6pack_datalist": False}, f)
        with timed_calls(driver.Tracker, "process_frame") as frame_ms:
            km.launches = 0  # count only this path's launches
            t0 = time.perf_counter()
            tracker = run_tracking.main([cfg_path, "--dataset", "nocs"])
            track_s = time.perf_counter() - t0
            launches = km.launches
        res = eval_nocs.main(["--pred_dir", os.path.join(out_dir, "poses"), "--gt_dir", gt_dir,
                              "--model", model_path, "--class_name", "camera",
                              "--noise_trans", "0.02", "--seed", "0"])

    statuses = [int(o.status) for o in tracker.outputs]
    tracked = len(statuses) - 1
    if tracker.cfg.bundle.max_ba_frames != nocs_config().bundle.max_ba_frames or not tracker.cfg.segmentation.nocs_mask_fill:
        raise AssertionError("nocs: the run did not use the NOCS preset")
    seg = tracker.cfg.segmentation
    mask = torch.as_tensor(seq.mask[len(seq.mask) // 2], device="cuda")
    lcc_ms = cuda_median_ms(lambda: masks.largest_component_fill(mask))
    hull_ms = cuda_median_ms(lambda: masks.convex_hull_fill(mask))
    pre_ms = cuda_median_ms(lambda: masks.preprocess_mask(mask, seg))
    log(f"nocs: statuses {statuses}; median tracked frame {steady_median(frame_ms):.2f} ms (CUDA events around "
        f"process_frame, frames {WARMUP_FRAMES}..{len(frame_ms) - 1}), whole app {track_s:.1f} s; "
        f"IoU25 {res['IoU25']:.2f}, 5deg5cm {res['5deg5cm']:.2f}, rotation {res['rot_err_deg_mean']:.4f} deg, "
        f"translation {res['trans_err_cm_mean']:.4f} cm, missing {res['missing']}, matcher launches {launches}")
    log(f"nocs: mask fills per {mask.shape[0]}x{mask.shape[1]} frame (CUDA events, median): largest component "
        f"{lcc_ms:.4f} ms, convex hull {hull_ms:.4f} ms, the whole preprocess_mask {pre_ms:.4f} ms [{card}]")
    if launches != tracked:
        raise AssertionError(f"nocs: matcher launches {launches} != tracked frames {tracked}")
    if res["missing"] or res["IoU25"] <= NOCS_IOU25_MIN or res["5deg5cm"] <= NOCS_5D5CM_MIN:
        raise AssertionError(f"nocs: bars missed (0 missing, IoU25 > {NOCS_IOU25_MIN}, "
                             f"5deg5cm > {NOCS_5D5CM_MIN}): {res}")
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

    from bundletrack_tpu_torch.cardrun import shipped_lfnet, with_lfnet

    lf_cfg = with_lfnet(cfg)
    lfnet = shipped_lfnet(lf_cfg)

    kernel = kernel_phase(seq, cfg, device, lf_cfg, lfnet)
    phase_s = {}
    t0 = time.perf_counter()
    classical_launches = tracker_phase(seq, cfg, card)
    lfnet_forward_phase(seq, lf_cfg, lfnet, card)
    cli_launches = cli_phase(seq, card)
    phase_s["tracker, lfnet, cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vos_phase(seq, card)
    phase_s["vos"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vos_chain_launches = vos_chain_phase(seq, card)
    phase_s["vos chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nocs_launches = nocs_phase(seq, card)
    phase_s["nocs chain"] = time.perf_counter() - t0
    kernel["launches"] = classical_launches + cli_launches + vos_chain_launches + nocs_launches
    log(f"matcher launches: classical tracker phase {classical_launches}, lfnet CLI phase {cli_launches}, "
        f"VOS chain {vos_chain_launches}, NOCS chain {nocs_launches}")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

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
