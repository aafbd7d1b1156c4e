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
   launch count must equal the number of tracked frames.  Then it rewrites
   the frames with PNG row filters (rgb Paeth, depth and masks Sub), which
   must decode to the same arrays, and runs the same chain on them: the
   statuses must be the same and the poses the same within the card's
   run-to-run tolerance; it logs read_png ms per 480x640 frame of each kind
   and filter, and the app's wall time.
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
9. Fleet phase: 8 streams of differently seeded rendered 480x640
   sequences through the fleet step (parallel/fleet.py) for 12 frames on
   the default TrackerConfig; every stream must meet the tracker phase's
   bars, stream 0 must match a single-stream Tracker given the same RANSAC
   phases (FLEET_VS_SINGLE_*), and the matcher must launch once per fleet
   frame, not once per stream.  The matcher is held to its plain version
   on the fleet's own table, the 8 streams' K=16 BA tables stacked as
   [128, 512, 256] with 960 pairs (a `mutual` row may differ only at a
   column near tie, as in phase 2), and timed there with its bound.  Then aggregate frames/s at S = 1, 4 and 8 on
   bench.py's tracking configuration (`fleet_bench.fleet_row`).
   Then the join run: the same 8 streams and phases for 12 fleet frames,
   streams 4-7 reset to a fresh `init_fleet_state` before fleet frame 4
   (`tracker.set_streams`), each starting again there at its own truth;
   bars: every stream and frame OK, streams 0-3 within FLEET_VS_SINGLE_*
   of the fleet phase's poses, each joined stream within them of a
   single-stream Tracker started at frame 4 with the same phases, 11
   matcher launches (one per fleet frame in which a stream runs), and the
   matcher of the join frame, on the 4 running streams' 480 pairs only,
   held to its plain version.  It logs the join frame's ms beside the
   all-running frames' and the aggregate frames/s over the 12 frames.
10. Hard-world phase: bench.py's hard suite on the card, the five passes of
   `hard_passes` (multi-shape, degraded depth and masks, 2x scale, fast
   rotation) at 480x640 with 16 frames each, rendered in a process pool,
   tracked with bench.py's tracking configuration (classical frontend) by
   `eval.hard_suite.run_hard_suite`; bars: every pose finite, ADD-S AUC >
   90 on cube, cylinder, lshape and fastrot (scale2x is recorded).
11. FAIL-path phase: 48 frames of the tracker phase's sequence with frames
   16-18 occluded (mask and depth empty), the default TrackerConfig; bars
   of tests/test_long_sequence.py: the FAIL frames cover 16-18 and lie in
   16..35, mean rotation error over frames 38-47 < 3 deg, terminal
   translation error < 15 mm.
12. Verify-reject phase: 10 frames with bundle.use_verification and a
   1.25 mm threshold (the test's 5 mm at 120x160, scaled to the 480x640
   pixel), which rejects every BA solve; bars of
   tests/test_verification_e2e.py: every frame after the first NO_BA, none
   FAIL, translation error < 10 mm.  In phases 10-12 the matcher launches
   once per tracked frame, FAIL frames included (the BA pair section runs
   on every frame after the first).
13. LF-Net fleet phase: phase 9's 8 streams through the fleet step with
   the LF-Net frontend (the shipped weights at 400x400 in bf16, one
   batched forward on the 8 masked crops per fleet frame) for 12 frames
   on the default TrackerConfig; every stream must meet the CLI phase's
   pose bars (every pose finite, ADD-S AUC > 90, ADD AUC > 80), the
   matcher must launch once per fleet frame, and stream 0 must match a
   single-stream LF-Net Tracker given the same phases within
   LFNET_FLEET_VS_SINGLE_*.  It logs how many keypoints of the batched
   forward differ from per-stream forwards on the same crops, holds the
   matcher to its plain version on the LF-Net fleet's [128, 512, 256]
   table with 960 pairs (as in phase 9), and gives aggregate frames/s at
   S = 1, 4, 8 (`fleet_bench.fleet_row` on `fleet_bench.lfnet_config`).
14. PCG tracker phase: phase 3's frames with bundle.solver_backend="pcg",
   held to phase 3's bars; frame latency, kernel launches, device ms and
   device-to-host syncs per frame beside the Cholesky solve's.
15. Photometric and fusion phase: tests/test_photometric.py's in-plane
   shift solve on the card (the 4 mm shift below 2 mm);
   dense_p2p_from_compact with the colour term on a 16-frame pool of the
   rendered frames at the tracker's low-res size (120x160, C = 4096, 120
   pairs), card against CPU within DENSE_CARD_RTOL, timed beside the
   depth term alone and the compaction; fuse_depth_frames on 16 480x640
   depth maps, card against CPU within FUSION_ATOL_M, timed.
16. Train LF-Net phase, at the shipped widths (the default FrontendConfig,
   f32): one make_lfnet_train_step from the same weights on the same batch
   on the card and on the CPU (loss within TRAIN_CARD_LOSS_RTOL, every
   gradient's cosine >= TRAIN_CARD_GRAD_COS_MIN, the score convs' biases,
   zero in exact arithmetic, logged only), the step timed at the CLI's
   defaults; `apps.train_lfnet.main` at its defaults (96x96, batch 8,
   top-k 128) for 20 steps with a checkpoint at step 10, every loss finite
   and the mean of the last 5 at most the mean of the first 5 + 1e-3; a
   run resumed from the step-10 checkpoint must end within
   TRAIN_RESUME_RTOL of the uninterrupted run's parameters (both with
   deterministic algorithms); the step timed at the serving shape
   (400x400, top-k 512, batch 8): ms per step by CUDA events, peak memory,
   launches and device time per step from the profiler.
17. Train VOS phase, at the shipped width 96 warm-started from
   checkpoints/vos_params.npz: card against CPU for one plain and one
   rollout step (the same bars); `apps.train_vos.main` at its defaults
   (96x96, batch 4, clip 4) for 20 plain and 20 --rollout steps, every
   loss finite; `apps.run_vos --checkpoint <ckpt>/params` with the plain
   run's weights on phase 6's frames (mean and min IoU bars
   VOS_TRAINED_*); plain and rollout steps timed at 96x96 and 256x256.
   The training phases launch the matcher 0 times.
18. Mesh phase: 2 ranks spawned with torch.multiprocessing (a file://
   rendezvous, a collective timeout; the kernel was built in step 1, so
   the ranks only load it) share the card over gloo, asked for
   explicitly: the default tracker with bundle.ba_mesh_axis="pairs" on
   phase 3's frames (60 of the 120 BA pairs per rank; both ranks' poses
   equal, within MESH_TRACKER_ATOL of phase 3's poses and its bars; each
   rank's matcher launches held to the plain version on its block); phase
   9's 8 streams over "stream" (4 per rank) and 2 streams over stream=1 x
   pairs=2, within the fleet's bars of phase 9's poses, and the join run
   over "stream" (rank 1's streams join late) within them of the one-rank
   join run; LF-Net at
   dp=2,tp=1 and dp=1,tp=2 (phase 16's batch) and VOS at dp=2 (phase 17's
   clip), one step against the one-device step on the card (the training
   bars).  Logs ms per tracked frame, the fleets' aggregate frames/s, ms
   per training step and the GN all-reduce's ms per iteration: with two
   host processes on one card, a measure of the collectives' cost, not of
   scaling.  With two or more cards it runs again over NCCL, one rank per
   card (world 2 or 4).  A rank's failure fails the run.
19. Prints one JSON line describing every kernel (the matcher's launches
   summed over phases 3, 5, 7-14 and 18, every rank), the card's line, and
   as its last line {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and the last line is not
printed.  Without a CUDA device, or without the package beside it, it fails.

    python3 chip_smoke.py --mesh-only

runs step 1, the one-rank tracker, fleet and join runs of phases 3 and 9
and phase 18 alone: the call to make on a machine with several cards.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

K_BA, P_PAIRS, N_KPTS, D_DESC = 16, 120, 512, 256
NUM_FRAMES = 20
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
# ~1e-6 flips it): each differing row must be one, its distance within
# DIST_ATOL of the best other row of its column, and there may be at most
# this many per 61440 rows (P*N at P=120), each logged.
MUTUAL_MAX_DIFF_ROWS = 8

# a rerun of the same chain on the card: atomic scatter-adds sum in another
# order from run to run (the fleet-vs-single tolerance below)
RERUN_ROT_DEG, RERUN_TRANS_M = 0.01, 1e-4
PNG_FILTERS = {"rgb": 4, "depth": 1, "masks": 1}  # Paeth for the colour frames, Sub for the rest

HARD_FRAMES = 16  # bench.py's hard suite: hard_passes(H=480, W=640, num_frames=16)
HARD_ADDS_AUC_MIN, HARD_BARRED = 90.0, ("cube", "cylinder", "lshape", "fastrot")
# tests/test_long_sequence.py's occlusion, moved to the 48-frame sequence:
# FAILs cover the occlusion and end within 18 frames of it, the tail's mean
# rotation error and the terminal translation error stay small
FAIL_FRAMES, OCCLUDED, FAIL_WINDOW = 48, (16, 17, 18), 18
FAIL_TAIL_ROT_DEG, FAIL_TERMINAL_TRANS_M = 3.0, 0.015
# tests/test_verification_e2e.py::test_reject_fires_and_reverts_cleanly: its
# 5 mm threshold lies below the keypoint noise floor at 120x160; the floor
# shrinks with the pixel, so at 480x640 the threshold is 5 mm x 160 / 640
# (at 5 mm the card accepted one solve in ten at 480x640)
VERIFY_FRAMES, VERIFY_DIST, VERIFY_TRANS_M = 10, 0.005 * 160 / 640, 0.010

FLEET_STREAMS, FLEET_FRAMES = 8, 12
# stream 0 of the fleet against a single-stream Tracker with the same
# phases: batched products and the solver's scatter-adds sum in another
# order on the card (the tolerance of the port's trajectory against JAX's)
FLEET_VS_SINGLE_ROT_DEG, FLEET_VS_SINGLE_TRANS_M = 0.01, 1e-4
FLEET_RATE_FRAMES = 5  # timed fleet frames per S in the frames/s rows
# the join phase: streams 4-7 of the fleet phase's 8 are reset to a fresh
# state before this fleet frame and start again there (they join the
# running fleet), held to the same bars as the fleet phase
JOIN_FRAME = 4
# stream 0 of the LF-Net fleet against a single-stream LF-Net Tracker with
# the same phases: the batched bf16 forward may pick other cuDNN algorithms
# than batch 1 does, so a few of the 512 keypoints per frame can differ and
# the two runs track on slightly different matches; the bar is half the
# tracker's pose bars (1 deg, 5 mm)
LFNET_FLEET_VS_SINGLE_ROT_DEG, LFNET_FLEET_VS_SINGLE_TRANS_M = 0.5, 0.0025
KPT_SAME_PX = 0.01  # two forwards' keypoints closer than this are the same keypoint

PCG_AB_FRAMES = 12  # frames per fresh tracker in the PCG / Cholesky turns
# tests/test_photometric.py's in-plane shift, and the bar it must fall below
SHIFT_M, SHIFT_LEFT_M = 0.004, 0.002
POOL_FRAMES = 16  # the default BA pool: the colour term's and fusion's frames
# the colour term on the card against the CPU, relative to the largest
# |entry| of H, g and the cost: the products and the atomic scatter-adds sum
# in another order, and a pixel whose projection lies within an ulp of a
# half pixel or a gate can change its association (one of ~4000 pixels of
# a pair); correspondence counts per pair may differ by as many
DENSE_CARD_RTOL, DENSE_COUNT_DIFF = 1e-3, 4
# fusion on the card against the CPU: the same elementwise f32 arithmetic,
# the sums of <= 16 depths per pixel in another order (atomics)
FUSION_ATOL_M = 1e-5

# Training.  Card against CPU for one step from the same weights on
# the same batch (f32, TF32 off): the loss within this relative bar, and
# every gradient tensor's cosine with the CPU's at least this; the LF-Net
# score convs' biases are left out of the cosine bar (logged): the instance
# norm after each score map removes them, so their gradient is 0 in exact
# arithmetic and rounding noise on both devices
TRAIN_CARD_LOSS_RTOL, TRAIN_CARD_GRAD_COS_MIN = 1e-3, 0.99
TRAIN_NOISE_GRADS = ("detector.score_conv_",)  # with ".bias"
TRAIN_STEPS, TRAIN_CKPT_STEP = 20, 10
# tests/test_train_apps.py's trend bar: the mean of the last losses at most
# the mean of the first plus 1e-3
TRAIN_TREND_N, TRAIN_TREND_SLACK = 5, 1e-3
# a run resumed from the step-10 checkpoint against the uninterrupted run,
# both with deterministic algorithms: every tensor's max |difference| over
# its max |value| (the checkpoint is exact; what is left is any kernel that
# has no deterministic version); the score convs' biases are logged, not
# barred (Adam turns their noise gradients into full-size steps)
TRAIN_RESUME_RTOL = 1e-4
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS, TRAIN_PROFILED_STEPS = 2, 5, 2
LFNET_SERVE_SIZE, LFNET_SERVE_TOPK = 400, 512  # the serving shape (FrontendConfig defaults)
VOS_TRAIN_SIZES = (96, 256)
# run_vos with the weights of 20 plain train_vos steps from the shipped
# ones (CLI defaults: easy world, 96x96, lr 1e-3) on the VOS phase's frames;
# the port on the CPU reached mean 0.9729, min 0.9667 there
VOS_TRAINED_MEAN_IOU_MIN, VOS_TRAINED_MIN_IOU_MIN = 0.95, 0.93

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


@contextlib.contextmanager
def recorded_calls(owner, name: str, args: bool = False):
    """Records the result of every call of owner.name, or with `args` its
    (args, kwargs); yields the list."""
    original = getattr(owner, name)
    results = []

    def record(*a, **kwargs):
        out = original(*a, **kwargs)
        results.append((a, kwargs) if args else out)
        return out

    setattr(owner, name, record)
    try:
        yield results
    finally:
        setattr(owner, name, original)


def build_kernels():
    """Every CUDA kernel with nvcc and every host C source with the host
    compiler, one compiler process per source, all started together."""
    from bundletrack_tpu_torch.kernels import build

    sources = sorted(f for f in os.listdir(build.CSRC_DIR) if f.endswith((".cu", ".c")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        paths = list(pool.map(lambda f: build.build_host(f) if f.endswith(".c") else build.build(f), sources))
    log(f"built {len(paths)} source(s) in {time.perf_counter() - t0:.1f} s: {sources}")


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


def near_tie_gap(table, pi, pj, gates, p: int, i: int, j: int) -> float:
    """How far row i's gated distance to column j lies from the smallest
    other row of column j, in pair p (the plain version's arithmetic)."""
    from bundletrack_tpu_torch.kernels import matching as km

    a, b = int(pi[p]), int(pj[p])
    desc, world, wnrm, valid = table
    gated = km.gated_distances(desc[a:a + 1], desc[b:b + 1], world[a:a + 1], world[b:b + 1],
                               wnrm[a:a + 1], wnrm[b:b + 1], valid[a:a + 1], valid[b:b + 1], **gates)[0]
    col = gated[:, j].clone()
    row_val = float(col[i])
    col[i] = km.BIG
    return abs(float(col.min()) - row_val)


def check_kernel(name, got, ref, table, pi, pj, gates) -> float:
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
    worst_gap = 0.0
    for p, i in diff_rows:
        gap = near_tie_gap(table, pi, pj, gates, p, i, int(rb[p, i]))
        worst_gap = max(worst_gap, gap)
        log(f"  mutual differs at pair {p} row {i}: kernel ({bool(mm[p, i])}, best_b {int(bb[p, i])}, "
            f"dist {float(dd[p, i]):.7g})  plain ({bool(rm[p, i])}, best_b {int(rb[p, i])}, "
            f"dist {float(rd[p, i]):.7g}); column near tie, gap {gap:.3e}")
    max_rows = MUTUAL_MAX_DIFF_ROWS * -(-dd.numel() // 61440)
    if not same_b or err > DIST_ATOL or len(diff_rows) > max_rows or worst_gap > DIST_ATOL:
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
    if name in ("rendered", "half_invalid", "exact_ties", "lfnet", "fleet", "lfnet_fleet") and int(mm.sum()) < 1000:
        raise AssertionError(f"{name}: too few mutual matches")
    return err


def matcher_bound(K: int, N: int, D: int, P: int):
    """The least time for the matcher's work on a [K, N, D] table with P
    pairs: the largest of bytes, bf16 products and the epilogue's f32
    instructions.  Returns (ms, term)."""
    in_bytes = K * N * D * 4 + 2 * K * N * 3 * 4 + K * N + 2 * P * 4  # table, geometry, valid, pairs
    out_bytes = P * N * (4 + 4 + 1)
    terms = {
        "bytes": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
        "bf16 products": 2 * P * N * N * D / BF16_FLOP_PER_S * 1e3,
        "gate instructions": GATE_INSTR_PER_CANDIDATE * P * N * N / F32_INSTR_PER_S * 1e3,
    }
    term = max(terms, key=terms.get)
    log(f"bound terms at K={K} P={P}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in terms.items()))
    return terms[term], term


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
        max_err = max(max_err, check_kernel(name, got, ref, args, pi, pj, gates))

    ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs(*table, pi, pj, **gates))
    plain_ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs_reference(*table, pi, pj, **gates))
    # yardstick: the descriptor dot alone, on operands gathered beforehand
    # (the port never calls it, and it is not the whole function)
    a = desc[pi.long()].to(torch.bfloat16)
    bt = desc[pj.long()].to(torch.bfloat16).transpose(1, 2)
    dot_ms = cuda_median_ms(lambda: torch.bmm(a, bt))
    log(f"yardstick: torch.bmm on the gathered bf16 operands (dot only) {dot_ms:.4f} ms")

    bound_ms, term = matcher_bound(K, N, D, P)
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


def tracker_phase(seq, cfg, card: str, label: str = "tracker") -> tuple:
    """Tracks the sequence from memory and holds every frame to the pose
    bars; returns (matcher launches, median frame ms, poses)."""
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
    log(f"{label}: statuses {statuses}")
    if launches != tracked:
        raise AssertionError(f"{label}: matcher launches {launches} != tracked frames {tracked}")
    worst_rot = worst_trans = 0.0
    for f, pose in enumerate(poses):
        if pose.shape != (4, 4) or not np.all(np.isfinite(pose)):
            raise AssertionError(f"frame {f}: pose is not a finite 4x4")
        rot, trans = pose_errors(pose, seq.ob_in_cam[f])
        worst_rot, worst_trans = max(worst_rot, rot), max(worst_trans, trans)
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    auc = adds_auc(poses, list(seq.ob_in_cam), model_pts)
    med = steady_median(frame_ms)
    log(f"{label}: {len(poses)} frames at {H}x{W}, solver {cfg.bundle.solver_backend}, worst rotation {worst_rot:.4f} deg, "
        f"worst translation {worst_trans * 1e3:.3f} mm, ADD-S AUC {auc:.2f}")
    log(f"{label}: median frame {med:.2f} ms ({1e3 / med:.2f} frames/s) over frames "
        f"{WARMUP_FRAMES}..{len(poses) - 1}, first frame {frame_ms[0]:.1f} ms, "
        f"matcher launches {launches} [{card}]")
    if any(s != 0 for s in statuses):
        raise AssertionError(f"{label}: not every frame is OK: {statuses}")
    if worst_rot >= 1.0 or worst_trans >= 0.005 or auc <= 95.0:
        raise AssertionError(f"{label}: pose bars missed (rotation < 1 deg, translation < 5 mm, ADD-S AUC > 95)")
    return launches, med, poses


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
            tracker = run_tracking.main([cfg_path, "--frontend", "lfnet", "--lfnet-ckpt", run_tracking.LFNET_CKPT])
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

        # the same chain on the frames rewritten with PNG row filters
        read_ms = rewrite_with_filters(data_dir)
        out_f = os.path.join(root, "out_filtered")
        cfg_f = write_config(root, data_dir, out_f)
        km.launches = 0  # count only this path's launches
        t0 = time.perf_counter()
        tracker_f = run_tracking.main([cfg_f, "--frontend", "lfnet", "--lfnet-ckpt", run_tracking.LFNET_CKPT])
        filtered_s = time.perf_counter() - t0
        launches_f = km.launches
        same_bytes, worst_rerun = 0, (0.0, 0.0)
        for fid in ids:
            a, b = (os.path.join(d, "poses", fid + ".txt") for d in (out_dir, out_f))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same_bytes += fa.read() == fb.read()
            rot, trans = pose_errors(np.loadtxt(b), np.loadtxt(a))
            worst_rerun = (max(worst_rerun[0], rot), max(worst_rerun[1], trans))

    statuses = [int(o.status) for o in tracker.outputs]
    statuses_f = [int(o.status) for o in tracker_f.outputs]
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
    log("cli: read_png ms per 480x640 frame (median of 5 reads, decode only): " + ", ".join(
        f"{kind} filter {ft} {ms:.2f}" for (kind, ft), ms in read_ms.items()) + f" [{card}]")
    log(f"cli: the chain on the filtered frames: statuses {statuses_f}; whole app {filtered_s:.1f} s "
        f"(filter 0: {chain_s:.1f} s); pose files byte-identical {same_bytes} of {len(ids)}, max difference "
        f"{worst_rerun[0]:.3e} deg, {worst_rerun[1]:.3e} m; matcher launches {launches_f} [{card}]")
    if launches != tracked or launches_f != tracked:
        raise AssertionError(f"cli: matcher launches {launches} / {launches_f} != tracked frames {tracked}")
    if res["missing"] or res["ADDS_AUC"] <= CLI_ADDS_AUC_MIN or res["ADD_AUC"] <= CLI_ADD_AUC_MIN:
        raise AssertionError(f"cli: pose bars missed (ADD-S AUC > {CLI_ADDS_AUC_MIN}, "
                             f"ADD AUC > {CLI_ADD_AUC_MIN}): {res}")
    if statuses_f != statuses or worst_rerun[0] >= RERUN_ROT_DEG or worst_rerun[1] >= RERUN_TRANS_M:
        raise AssertionError("cli: the chain on filtered PNGs differs from the chain on filter-0 PNGs")
    return launches + launches_f


def rewrite_with_filters(data_dir: str) -> dict:
    """Rewrites every frame of data_dir's rgb/, depth/ and masks/ with the
    row filters of PNG_FILTERS, each decoding to the array it held; returns
    read_png's ms on frame 0 of each kind, before and after, by (kind,
    filter)."""
    import statistics

    from bundletrack_tpu_torch.data.native_io import read_png, write_png

    def read_ms(path):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            read_png(path)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    ms = {}
    for kind, ft in PNG_FILTERS.items():
        paths = sorted(os.path.join(data_dir, kind, n) for n in os.listdir(os.path.join(data_dir, kind)))
        ms[(kind, 0)] = read_ms(paths[0])
        for path in paths:
            img = read_png(path)
            write_png(path, img, filter_type=ft)
            if not np.array_equal(read_png(path), img):
                raise AssertionError(f"cli: {path} decodes differently with filter {ft}")
        ms[(kind, ft)] = read_ms(paths[0])
    return ms


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


def render_fleet_sequences():
    """The fleet phases' 8 differently seeded 480x640 sequences, each long
    enough for a K=16 BA table, rendered in threads."""
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.data import render_synthetic_sequence

    t0 = time.perf_counter()
    n_render = max(K_BA, FLEET_FRAMES)  # the BA table of the kernel check takes K_BA frames
    render = lambda s: render_synthetic_sequence(num_frames=n_render, H=H, W=W, seed=s, orbit_deg_per_frame=3.0)  # noqa: E731
    with ThreadPoolExecutor(max_workers=FLEET_STREAMS) as pool:
        seqs = list(pool.map(render, range(FLEET_STREAMS)))
    log(f"fleet: rendered {FLEET_STREAMS} sequences of {n_render} frames at {H}x{W} in "
        f"{time.perf_counter() - t0:.1f} s")
    return seqs


def fleet_phases(cfg, S: int, F: int):
    """The RANSAC phases of every stream and frame, drawn as each stream's
    generator would draw them (stream s seeded s), so a single-stream run
    can be given the same; None for frame 0."""
    import torch

    from bundletrack_tpu_torch.ransac.ransac import draw_phases

    rc, M, P = cfg.ransac, cfg.shapes.max_matches, P_PAIRS
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in range(S)]
    return [None] + [
        tuple(torch.stack(p) for p in zip(*[(draw_phases((), rc.max_iter, M, g),
                                             draw_phases((P,), rc.max_iter, M, g)) for g in gens]))
        for _ in range(1, F)
    ]


def joined_streams() -> list:
    return list(range(FLEET_STREAMS // 2, FLEET_STREAMS))


def join_init_poses(ob_in_cam, f: int, streams) -> np.ndarray:
    """Every stream's init pose (its truth at frame 0), the streams that
    join at frame f set to their truth at f; ob_in_cam [S, F, 4, 4]."""
    ip = np.linalg.inv(ob_in_cam[:, 0]).astype(np.float32)
    ip[streams] = np.linalg.inv(ob_in_cam[streams, f]).astype(np.float32)
    return ip


def run_fleet(cfg, seqs, F: int, phases, lfnet=None, join: bool = False):
    """F fleet frames of the streams `seqs` on the card; returns (per-frame
    (poses [S,4,4], statuses [S]) as numpy, fleet frame ms, matcher
    launches).  With `join`, streams 4-7 are reset to a fresh
    init_fleet_state before fleet frame JOIN_FRAME (tracker.set_streams)
    and start again there at their truth; stream s is fed its sequence's
    frame f at fleet frame f throughout."""
    import torch

    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
    from bundletrack_tpu_torch.tracker import set_streams

    S = len(seqs)
    truth = np.stack([q.ob_in_cam[:F] for q in seqs])
    step = make_fleet_step(cfg, H, W, lfnet_apply=lfnet)
    state = init_fleet_state(cfg, H, W, S)  # the card, by default
    ip = torch.as_tensor(join_init_poses(truth, 0, []), device="cuda")
    km.launches = 0  # count only this path's launches
    outs, frame_ms = [], []
    for f in range(F):
        if join and f == JOIN_FRAME:
            state = set_streams(state, joined_streams(), init_fleet_state(cfg, H, W, S))
            ip = torch.as_tensor(join_init_poses(truth, f, joined_streams()), device="cuda")
        obs = fleet_observation(*(np.stack([getattr(q, k)[f] for q in seqs]) for k in ("gray", "depth", "mask")),
                                np.stack([q.K for q in seqs]), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, out = step(state, obs, ip, phases[f])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        outs.append((out.ob_in_cam.cpu().numpy(), out.status.cpu().numpy()))
    return outs, frame_ms, km.launches


def stream_vs_single(cfg, seq, F: int, phases, fleet_poses, lfnet=None):
    """Stream 0's poses against a single-stream Tracker on its frames with
    the same phases: (max rotation deg, max translation m)."""
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.eval.metrics import pose_errors
    from bundletrack_tpu_torch.tracker.driver import Tracker

    single = Tracker(cfg, H, W, lfnet_apply=lfnet)
    init_pose = np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32)
    worst = (0.0, 0.0)
    for f in range(F):
        ph = None if phases[f] is None else tuple(p[0] for p in phases[f])
        out = single.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=ph)
        rot, trans = pose_errors(out.ob_in_cam.cpu().numpy(), fleet_poses[f])
        worst = (max(worst[0], rot), max(worst[1], trans))
    return worst


def fleet_table_check(name: str, seqs, cfg, card: str, lfnet=None) -> dict:
    """The matcher on a fleet's own table, the streams' K=16 BA tables as
    one [S*K, N, D] table with stream s's pairs at s*K + i, against its
    plain version; timed with its bound."""
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.matcher_bench import ba_table

    tables = [ba_table(q, cfg, "cuda", lfnet) for q in seqs]
    table = tuple(torch.cat([t[0][k] for t in tables]) for k in range(4))
    pi, pj = (torch.cat([t[1][k] + s * K_BA for s, t in enumerate(tables)]) for k in range(2))
    fc = cfg.feature_corres
    gates = dict(max_dist=fc.max_dist_no_neighbor, max_normal_deg=fc.max_normal_no_neighbor)
    got = km.fused_mutual_match_pairs(*table, pi, pj, **gates)
    ref = km.fused_mutual_match_pairs_reference(*table, pi, pj, **gates)
    torch.cuda.synchronize()
    Kf, N, D = table[0].shape
    diff_rows = int((got[2] != ref[2]).sum())
    err = check_kernel(name, got, ref, table, pi, pj, gates)
    ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs(*table, pi, pj, **gates))
    plain_ms = cuda_median_ms(lambda: km.fused_mutual_match_pairs_reference(*table, pi, pj, **gates), runs=5)
    bound_ms, term = matcher_bound(Kf, N, D, len(pi))
    log(f"kernel fused_mutual_match_pairs on the {name} table K={Kf} P={len(pi)} N={N} D={D}: {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms ({term})  {100 * bound_ms / ms:.1f} % of bound, "
        f"max |dist diff| {err:.3e}, mutual rows that differ {diff_rows}, valid keypoints "
        f"{int(table[3].sum())} of {table[3].numel()} [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "diff_rows": diff_rows, "max_abs_err": err}


def fleet_phase(seqs, cfg, card: str) -> tuple:
    """The fleet step on 8 differently seeded streams, its matcher on the
    fleet's table, and the fleet's frames/s at S = 1, 4, 8.  Returns
    (matcher launches, the phases, per-frame (poses, statuses))."""
    from bundletrack_tpu_torch import fleet_bench
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.eval.metrics import adds_auc, pose_errors

    S, F = FLEET_STREAMS, FLEET_FRAMES
    phases = fleet_phases(cfg, S, F)
    outs, frame_ms, launches = run_fleet(cfg, seqs, F, phases)
    if launches != F - 1:
        raise AssertionError(f"fleet: matcher launches {launches} != fleet frames tracked {F - 1}")
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    for s in range(S):
        poses = [outs[f][0][s] for f in range(F)]
        statuses = [int(outs[f][1][s]) for f in range(F)]
        errs = [pose_errors(p, seqs[s].ob_in_cam[f]) for f, p in enumerate(poses)]
        rot, trans = max(e[0] for e in errs), max(e[1] for e in errs)
        auc = adds_auc(poses, list(seqs[s].ob_in_cam[:F]), model_pts)
        log(f"fleet: stream {s}: statuses {statuses}, worst rotation {rot:.4f} deg, worst translation "
            f"{trans * 1e3:.3f} mm, ADD-S AUC {auc:.2f}")
        if any(statuses) or not all(np.all(np.isfinite(p)) for p in poses):
            raise AssertionError(f"fleet: stream {s}: not every frame is OK with a finite pose")
        if rot >= 1.0 or trans >= 0.005 or auc <= 95.0:
            raise AssertionError(f"fleet: stream {s}: pose bars missed (rotation < 1 deg, translation < 5 mm, "
                                 "ADD-S AUC > 95)")

    worst = stream_vs_single(cfg, seqs[0], F, phases, [o[0][0] for o in outs])
    log(f"fleet: stream 0 against a single-stream Tracker with the same phases: max {worst[0]:.3e} deg, "
        f"{worst[1]:.3e} m (tolerance {FLEET_VS_SINGLE_ROT_DEG} deg, {FLEET_VS_SINGLE_TRANS_M} m)")
    if worst[0] >= FLEET_VS_SINGLE_ROT_DEG or worst[1] >= FLEET_VS_SINGLE_TRANS_M:
        raise AssertionError("fleet: stream 0 differs from the single-stream tracker")
    med = float(np.median(frame_ms[3:]))
    log(f"fleet: {S} streams at {H}x{W}, default TrackerConfig: median fleet frame {med:.2f} ms "
        f"({S * 1e3 / med:.2f} frames/s aggregate) over frames 3..{F - 1}, first {frame_ms[0]:.1f} ms, "
        f"matcher launches {launches} for {F - 1} tracked fleet frames [{card}]")

    fleet_table_check("fleet", seqs, cfg, card)
    seq = fleet_bench.render(H, W, fleet_bench.WARMUP + FLEET_RATE_FRAMES + fleet_bench.PROFILED + 1)
    for n in (1, 4, 8):
        fleet_bench.fleet_row(fleet_bench.bench_config(H, W), seq, n, FLEET_RATE_FRAMES, card)
    return launches, phases, outs


def join_phase(seqs, cfg, card: str, phases, fleet_outs) -> tuple:
    """Streams 4-7 join the running fleet at fleet frame JOIN_FRAME: every
    stream and frame OK; streams 0-3 held to the fleet phase's poses; each
    joined stream held to a single-stream Tracker started at its join frame
    with the same phases; one matcher launch per fleet frame in which a
    stream runs; the matcher on the join frame (the running streams' pairs
    only) held to its plain version.  Returns (matcher launches, per-frame
    (poses, statuses))."""
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.eval.metrics import pose_errors
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.matching import pairwise
    from bundletrack_tpu_torch.tracker.driver import Tracker

    S, F, J, joined = FLEET_STREAMS, FLEET_FRAMES, JOIN_FRAME, joined_streams()
    with recorded_calls(pairwise, "fused_mutual_match_pairs") as results, \
            recorded_calls(pairwise, "fused_mutual_match_pairs", args=True) as calls:
        outs, frame_ms, launches = run_fleet(cfg, seqs, F, phases, join=True)
    if launches != F - 1:
        raise AssertionError(f"join: matcher launches {launches} != fleet frames in which a stream runs {F - 1}")
    worst_old, worst_new = (0.0, 0.0), (0.0, 0.0)
    for s in range(S):
        statuses = [int(outs[f][1][s]) for f in range(F)]
        if any(statuses) or not all(np.all(np.isfinite(outs[f][0][s])) for f in range(F)):
            raise AssertionError(f"join: stream {s}: not every frame is OK with a finite pose: {statuses}")
        errs = [pose_errors(outs[f][0][s], seqs[s].ob_in_cam[f]) for f in range(F)]
        if max(e[0] for e in errs) >= 1.0 or max(e[1] for e in errs) >= 0.005:
            raise AssertionError(f"join: stream {s}: the tracker's pose bars missed (rotation < 1 deg, "
                                 "translation < 5 mm)")
        if s not in joined:  # against the fleet phase, same frames and phases
            for f in range(F):
                e = pose_errors(outs[f][0][s], fleet_outs[f][0][s])
                worst_old = (max(worst_old[0], e[0]), max(worst_old[1], e[1]))
            continue
        single = Tracker(cfg, H, W)
        init_pose = np.linalg.inv(seqs[s].ob_in_cam[J]).astype(np.float32)
        q = seqs[s]
        for f in range(J, F):
            ph = None if f == J else tuple(p[s] for p in phases[f])
            out = single.process_frame(q.gray[f], q.depth[f], q.mask[f], q.K, init_pose, phases=ph)
            e = pose_errors(out.ob_in_cam.cpu().numpy(), outs[f][0][s])
            worst_new = (max(worst_new[0], e[0]), max(worst_new[1], e[1]))
    log(f"join: streams {joined} reset at fleet frame {J}; every stream and frame OK; streams 0-{joined[0] - 1} "
        f"against the fleet phase max {worst_old[0]:.3e} deg, {worst_old[1]:.3e} m; joined streams against "
        f"single-stream Trackers started at frame {J} with the same phases max {worst_new[0]:.3e} deg, "
        f"{worst_new[1]:.3e} m (bars {FLEET_VS_SINGLE_ROT_DEG} deg, {FLEET_VS_SINGLE_TRANS_M} m); matcher launches "
        f"{launches} for {F} fleet frames")
    for name, w in (("streams 0-3 against the fleet phase", worst_old), ("joined streams", worst_new)):
        if w[0] >= FLEET_VS_SINGLE_ROT_DEG or w[1] >= FLEET_VS_SINGLE_TRANS_M:
            raise AssertionError(f"join: {name} miss the fleet's bars")
    # frame 0 makes no matcher call, so the join frame's is call J - 1
    ((table0, table1, table2, table3, pi, pj), gates), got = calls[J - 1], results[J - 1]
    if len(pi) != (S - len(joined)) * P_PAIRS:
        raise AssertionError(f"join: the join frame matched {len(pi)} pairs, not the running streams' "
                             f"{(S - len(joined)) * P_PAIRS}")
    table = (table0, table1, table2, table3)
    ref = km.fused_mutual_match_pairs_reference(*table, pi, pj, **gates)
    err = check_kernel("join", got, ref, table, pi, pj, gates)
    running = [frame_ms[f] for f in range(1, F) if f != J]
    log(f"join: the join frame {frame_ms[J]:.2f} ms ({S - len(joined)} streams tracked, {len(joined)} started; "
        f"matcher on {len(pi)} pairs, max |dist diff| {err:.3e}) beside the all-running frames' median "
        f"{float(np.median(running)):.2f} ms (frames 1-{J - 1}: {', '.join(f'{m:.2f}' for m in frame_ms[1:J])}; "
        f"frame {J + 1} {frame_ms[J + 1]:.2f}); first frame {frame_ms[0]:.1f} ms; {S * F * 1e3 / sum(frame_ms):.2f} "
        f"frames/s aggregate over the {F} fleet frames [{card}]")
    return launches, outs


def differing_keypoints(batched, single) -> int:
    """Valid keypoints of one forward with no valid keypoint of the other
    within KPT_SAME_PX."""
    import torch

    a = batched.kpts_uv[batched.valid]
    b = single.kpts_uv[single.valid]
    if len(a) == 0 or len(b) == 0:
        return max(len(a), len(b))
    return int((torch.cdist(a, b).min(dim=1).values > KPT_SAME_PX).sum()) + abs(len(a) - len(b))


def lfnet_fleet_phase(seqs, lf_cfg, lfnet, card: str) -> tuple:
    """The LF-Net fleet: 8 streams, one batched 400x400 bf16 forward and one
    matcher launch per fleet frame; its matcher on the LF-Net fleet table;
    the batched forward against per-stream forwards on the same crops;
    frames/s at S = 1, 4, 8.  Returns (matcher launches, table stats)."""
    import torch

    from bundletrack_tpu_torch import fleet_bench
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.eval.metrics import add_error, adi_error, vocap_auc
    from bundletrack_tpu_torch.ops.masks import mask_roi
    from bundletrack_tpu_torch.ops.resize import crop_resize_square

    S, F = FLEET_STREAMS, FLEET_FRAMES
    phases = fleet_phases(lf_cfg, S, F)
    outs, frame_ms, launches = run_fleet(lf_cfg, seqs, F, phases, lfnet)
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    missed = []
    for s in range(S):
        poses = [outs[f][0][s] for f in range(F)]
        gts = seqs[s].ob_in_cam[:F]
        statuses = [int(outs[f][1][s]) for f in range(F)]
        add = vocap_auc([add_error(p, g, model_pts) for p, g in zip(poses, gts)])
        adds = vocap_auc([adi_error(p, g, model_pts) for p, g in zip(poses, gts)])
        log(f"lfnet fleet: stream {s}: statuses {statuses}, ADD AUC {add:.2f}, ADD-S AUC {adds:.2f}")
        if not all(np.all(np.isfinite(p)) for p in poses) or adds <= CLI_ADDS_AUC_MIN or add <= CLI_ADD_AUC_MIN:
            missed.append(s)
    worst = stream_vs_single(lf_cfg, seqs[0], F, phases, [o[0][0] for o in outs], lfnet)
    med = float(np.median(frame_ms[3:]))
    log(f"lfnet fleet: stream 0 against a single-stream LF-Net Tracker with the same phases: max "
        f"{worst[0]:.3e} deg, {worst[1]:.3e} m (tolerance {LFNET_FLEET_VS_SINGLE_ROT_DEG} deg, "
        f"{LFNET_FLEET_VS_SINGLE_TRANS_M} m)")
    fc = lf_cfg.frontend
    log(f"lfnet fleet: {S} streams at {H}x{W}, LF-Net {fc.input_size}x{fc.input_size} "
        f"{'bf16' if fc.bf16 else 'f32'}: median fleet frame {med:.2f} ms "
        f"({S * 1e3 / med:.2f} frames/s aggregate) over frames 3..{F - 1}, first {frame_ms[0]:.1f} ms, "
        f"matcher launches {launches} for {F - 1} tracked fleet frames [{card}]")

    # the batched forward against one forward per crop, on frame 1's crops
    gray = torch.as_tensor(np.stack([q.gray[1] for q in seqs]), device="cuda")
    mask = torch.as_tensor(np.stack([q.mask[1] for q in seqs]), device="cuda")
    crops = crop_resize_square(torch.where(mask, gray, torch.zeros_like(gray)), mask_roi(mask)[:4],
                               lf_cfg.frontend.input_size)[0]
    batched = lfnet(crops[..., None])
    diffs = [differing_keypoints(type(batched)(*(t[s] for t in batched)), lfnet(crops[s, ..., None]))
             for s in range(S)]
    log(f"lfnet fleet: keypoints of the batched forward with no per-stream keypoint within {KPT_SAME_PX} px, "
        f"per stream of {lf_cfg.frontend.top_k}: {diffs}")

    stats = fleet_table_check("lfnet_fleet", seqs, lf_cfg, card, lfnet)
    seq = fleet_bench.render(H, W, fleet_bench.WARMUP + FLEET_RATE_FRAMES + fleet_bench.PROFILED + 1)
    for n in (1, 4, 8):
        fleet_bench.fleet_row(fleet_bench.lfnet_config(H, W), seq, n, FLEET_RATE_FRAMES, card, lfnet)
    if launches != F - 1:
        raise AssertionError(f"lfnet fleet: matcher launches {launches} != fleet frames tracked {F - 1}")
    if missed:
        raise AssertionError(f"lfnet fleet: streams {missed} missed the pose bars (finite, ADD-S AUC > "
                             f"{CLI_ADDS_AUC_MIN}, ADD AUC > {CLI_ADD_AUC_MIN})")
    if worst[0] >= LFNET_FLEET_VS_SINGLE_ROT_DEG or worst[1] >= LFNET_FLEET_VS_SINGLE_TRANS_M:
        raise AssertionError("lfnet fleet: stream 0 differs from the single-stream LF-Net tracker")
    return launches, stats


def frame_costs(cfg, seq, frames: int) -> dict:
    """A fresh tracker on `frames` frames: the median frame ms after the
    warm-up frames (host clock, device synchronised around each frame);
    then one more frame's device-to-host syncs (torch's sync debug mode)
    and one more's kernel launches and device ms (torch.profiler)."""
    import warnings

    import torch

    from bundletrack_tpu_torch.cardrun import H, W, steady_median, timed_frames
    from bundletrack_tpu_torch.tracker.driver import Tracker

    tracker = Tracker(cfg, H, W)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    frame_ms = [ms for _, _, ms in timed_frames(tracker, seq, range(frames), init_pose)]

    def track(f):
        return tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            track(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        track(frames + 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"ms": steady_median(frame_ms), "launches": len(kernels),
            "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3, "syncs": syncs}


def solve_times(K: int = K_BA) -> dict:
    """One normal-equation solve alone on a random SPD [K, K, 6, 6] system
    (the default BA size), each backend: (CUDA-event ms, host ms per call
    with the device synchronised at both ends, median of 25); and the
    block-Jacobi inverse alone."""
    import statistics

    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.solver.gauss_newton import solve_normal_equations_cholesky
    from bundletrack_tpu_torch.solver.pcg import solve_normal_equations_pcg

    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(K * 6, K * 6, device="cuda", generator=g)
    H = (A @ A.T + 10.0 * torch.eye(K * 6, device="cuda")).reshape(K, 6, K, 6).transpose(1, 2).contiguous()
    gv = torch.randn(K, 6, device="cuda", generator=g)
    diag = torch.diagonal(H, dim1=0, dim2=1).movedim(-1, 0).contiguous()
    fns = {
        "cholesky": lambda: solve_normal_equations_cholesky(H, gv, 1e-6),
        "pcg": lambda: solve_normal_equations_pcg(H, gv, num_iters=5, lm_lambda=1e-6),
        "inv_ex": lambda: torch.linalg.inv_ex(diag),
    }
    out = {}
    for name, fn in fns.items():
        host = []
        for _ in range(28):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        out[name] = (cuda_median_ms(fn), statistics.median(host[3:]))
    return out


def pcg_tracker_phase(seq, cfg, card: str, cholesky_poses) -> int:
    """The tracker phase's frames with bundle.solver_backend="pcg" (5 inner
    iterations), held to the same bars; the poses against the Cholesky
    run's; frame latency, launches and syncs per frame of both backends,
    measured in turns (Cholesky, PCG, Cholesky, PCG) on fresh trackers;
    the solves alone."""
    import dataclasses

    from bundletrack_tpu_torch.eval.metrics import pose_errors

    pcg = cfg.replace(bundle=dataclasses.replace(cfg.bundle, solver_backend="pcg"))
    launches, _, poses = tracker_phase(seq, pcg, card, label="pcg tracker")
    errs = [pose_errors(p, q) for p, q in zip(poses, cholesky_poses)]
    log(f"pcg tracker: against the Cholesky tracker phase's poses: max {max(e[0] for e in errs):.3e} deg, "
        f"{max(e[1] for e in errs):.3e} m")
    for turn in range(2):
        costs = {name: frame_costs(c, seq, PCG_AB_FRAMES) for name, c in (("cholesky", cfg), ("pcg", pcg))}
        log(f"pcg tracker: turn {turn + 1}, per tracked frame (fresh trackers, median of frames "
            f"3..{PCG_AB_FRAMES - 1}): " + "; ".join(
                f"{name} {c['ms']:.2f} ms, {c['launches']} launches, {c['device_ms']:.3f} device ms, "
                f"{c['syncs']} syncs" for name, c in costs.items()) + f" [{card}]")
    times = solve_times()
    log(f"pcg tracker: one solve alone at K={K_BA} (CUDA events / host clock, ms, median of 25): " + ", ".join(
        f"{name} {ev:.4f} / {host:.4f}" for name, (ev, host) in times.items()) + f" [{card}]")
    return launches


def dense_pool(seq, frames: int, ds: int, device: str):
    """The first `frames` frames of `seq` as the solver's low-res dense
    inputs: DenseFrames (cloud, normals, valid inside the mask, intensity
    and its gradients) at 1/ds resolution, the low-res intrinsics, the
    true cam->model poses; on `device`."""
    import torch

    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.geometry.camera import scale_intrinsics
    from bundletrack_tpu_torch.ops.depth import process_depth
    from bundletrack_tpu_torch.ops.intensity import intensity_gradients
    from bundletrack_tpu_torch.ops.masks import preprocess_mask
    from bundletrack_tpu_torch.ops.pointcloud import depth_to_cloud_and_normals
    from bundletrack_tpu_torch.solver.dense_p2p import DenseFrames

    cfg = TrackerConfig()
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    depth = process_depth(up(seq.depth[:frames]), cfg.depth_processing)
    K = up(np.broadcast_to(seq.K.astype(np.float32), (frames, 3, 3)))
    pts, nrm, val = depth_to_cloud_and_normals(depth, K)
    val = (val & preprocess_mask(up(seq.mask[:frames]), cfg.segmentation))[..., ::ds, ::ds]
    inten = up(seq.gray[:frames].astype(np.float32))[..., ::ds, ::ds].contiguous()
    gx, gy = intensity_gradients(inten, val)
    frames_ = DenseFrames(points=pts[..., ::ds, ::ds, :].contiguous(), normals=nrm[..., ::ds, ::ds, :].contiguous(),
                          valid=val.contiguous(), intensity=inten, grad_x=gx, grad_y=gy)
    poses = up(np.linalg.inv(seq.ob_in_cam[:frames]).astype(np.float32))
    return frames_, scale_intrinsics(up(seq.K.astype(np.float32)), 1.0 / ds), poses


def photometric_fusion_phase(seq, card: str) -> None:
    """The photometric term and depth fusion on the card: the in-plane
    shift solve of tests/test_photometric.py; dense_p2p_from_compact with
    the colour term on a 16-frame pool at the tracker's low-res size, card
    against CPU, timed; fuse_depth_frames on 16 480x640 depth maps, card
    against CPU, timed."""
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.config import BundleConfig, TrackerConfig
    from bundletrack_tpu_torch.geometry.camera import unproject
    from bundletrack_tpu_torch.ops.fusion import fuse_depth_frames
    from bundletrack_tpu_torch.ops.intensity import intensity_gradients
    from bundletrack_tpu_torch.solver.dense_p2p import DenseFrames, compact_dense_frames, dense_p2p_from_compact
    from bundletrack_tpu_torch.solver.gauss_newton import GraphInputs, optimize_pose_graph
    from bundletrack_tpu_torch.solver.residuals import SparseCorres

    # ---- the in-plane shift: invisible to point-to-plane on a plane
    Hp, Wp = 48, 64
    K = torch.tensor([[60.0, 0, Wp / 2 - 0.5], [0, 60.0, Hp / 2 - 0.5], [0, 0, 1]], device="cuda")
    pts = unproject(torch.ones(Hp, Wp, device="cuda"), K)
    normals = torch.zeros(Hp, Wp, 3, device="cuda")
    normals[..., 2] = -1.0
    valid = torch.ones(Hp, Wp, dtype=torch.bool, device="cuda")
    inten = 0.5 + 0.2 * torch.sin(20.0 * pts[..., 0]) + 0.2 * torch.cos(17.0 * pts[..., 1])
    gx, gy = intensity_gradients(inten, valid)
    two = lambda a: torch.stack([a, a])  # noqa: E731
    poses = torch.eye(4, device="cuda").repeat(2, 1, 1)
    poses[1, 0, 3] = SHIFT_M
    corres = SparseCorres(torch.tensor([0], device="cuda"), torch.tensor([1], device="cuda"),
                          torch.zeros(1, 4, 3, device="cuda"), torch.zeros(1, 4, 3, device="cuda"),
                          torch.zeros(1, 4, dtype=torch.bool, device="cuda"))
    inputs = GraphInputs(poses, torch.ones(2, dtype=torch.bool, device="cuda"),
                         torch.tensor([False, True], device="cuda"), corres, K_lowres=K,
                         dense=DenseFrames(two(pts), two(normals), two(valid), two(inten), two(gx), two(gy)))
    out, _ = optimize_pose_graph(inputs, BundleConfig(w_sparse=0.0, w_dense_depth=0.0, w_dense_color=1.0,
                                                      num_iter_outer=6, lm_lambda=1e-4))
    left = abs(float(out[1, 0, 3]))
    log(f"photometric: in-plane shift {SHIFT_M * 1e3:.1f} mm -> {left * 1e3:.3e} mm after 6 GN iterations "
        f"(bar < {SHIFT_LEFT_M * 1e3:.1f} mm) [{card}]")

    # ---- the colour term on a 16-frame pool, card against CPU
    bundle = TrackerConfig().bundle
    ds, C = bundle.image_downscale, bundle.dense_src_capacity  # the tracker's low-res size and capacity
    frames, K_low, poses = dense_pool(seq, POOL_FRAMES, ds, "cuda")
    pi, pj = (torch.as_tensor(a, device="cuda") for a in np.triu_indices(POOL_FRAMES, k=1))
    fv = torch.ones(POOL_FRAMES, dtype=torch.bool, device="cuda")
    results, timing = {}, {}
    for device in ("cuda", "cpu"):
        mv = lambda t: t.to(device)  # noqa: E731
        f_d = DenseFrames(*(mv(t) for t in frames))
        cd = compact_dense_frames(f_d, capacity=C, with_color=True)
        args = (mv(poses), cd, mv(fv), mv(pi), mv(pj), mv(K_low))
        results[device] = [t.cpu() for t in dense_p2p_from_compact(*args, weight=1.0, weight_color=1.0)]
        C_used = cd.src.shape[-1]
        if device == "cuda":
            timing["compact"] = cuda_median_ms(lambda: compact_dense_frames(f_d, capacity=C, with_color=True))
            timing["depth"] = cuda_median_ms(lambda: dense_p2p_from_compact(*args, weight=1.0))
            timing["depth+colour"] = cuda_median_ms(
                lambda: dense_p2p_from_compact(*args, weight=1.0, weight_color=1.0))
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
           for a, b in zip(results["cuda"][:3], results["cpu"][:3])]
    count_diff = int((results["cuda"][3] - results["cpu"][3]).abs().max())
    log(f"photometric: dense_p2p_from_compact, w_dense_color 1, {POOL_FRAMES}-frame pool at "
        f"{frames.valid.shape[-2]}x{frames.valid.shape[-1]}, C={C_used}, {len(pi)} pairs, "
        f"{int(results['cpu'][3].sum())} correspondences: card vs CPU max |diff| / max |CPU| H {rel[0]:.3e}, "
        f"g {rel[1]:.3e}, cost {rel[2]:.3e} (tolerance {DENSE_CARD_RTOL}), counts differ by at most {count_diff} "
        f"(tolerance {DENSE_COUNT_DIFF})")
    log("photometric: card ms (CUDA events, median of 25): " + ", ".join(
        f"{k} {v:.4f}" for k, v in timing.items()) + f" [{card}]")

    # ---- depth fusion, card against CPU
    depths = torch.as_tensor(seq.depth[:POOL_FRAMES].astype(np.float32), device="cuda")
    Kf = torch.as_tensor(seq.K.astype(np.float32), device="cuda")
    fused = fuse_depth_frames(depths, poses, Kf, target_idx=POOL_FRAMES // 2)
    fused_cpu = fuse_depth_frames(depths.cpu(), poses.cpu(), Kf.cpu(), target_idx=POOL_FRAMES // 2)
    fuse_err = float((fused.cpu() - fused_cpu).abs().max())
    changed = float((fused != depths[POOL_FRAMES // 2]).float().mean())
    fuse_ms = cuda_median_ms(lambda: fuse_depth_frames(depths, poses, Kf, target_idx=POOL_FRAMES // 2))
    log(f"fusion: {POOL_FRAMES} depth maps at {depths.shape[1]}x{depths.shape[2]} into frame "
        f"{POOL_FRAMES // 2}: card vs CPU max |diff| {fuse_err:.3e} m (tolerance {FUSION_ATOL_M}), "
        f"{changed * 100:.2f} % of pixels fused; {fuse_ms:.4f} ms (CUDA events, median of 25) [{card}]")

    if left >= SHIFT_LEFT_M:
        raise AssertionError("photometric: the in-plane shift was not recovered")
    if max(rel) > DENSE_CARD_RTOL or count_diff > DENSE_COUNT_DIFF:
        raise AssertionError("photometric: the card's colour term differs from the CPU's")
    if not fuse_err <= FUSION_ATOL_M:
        raise AssertionError("fusion: the card's fused depth differs from the CPU's")


def hard_pass_specs(**kw) -> dict:
    """hard_passes' calls of render_hard_sequence, as (args, kwargs) by
    pass name, so each pass renders in a process of its own."""
    from bundletrack_tpu_torch.data import hard_world

    render = hard_world.render_hard_sequence
    hard_world.render_hard_sequence = lambda *a, **k: (a, k)
    try:
        return hard_world.hard_passes(**kw)
    finally:
        hard_world.render_hard_sequence = render


def render_new_phase_inputs():
    """The hard passes and the FAIL-path sequence, rendered in parallel in
    spawned processes (numpy on the host, ~0.6 s per 480x640 hard frame)."""
    from bundletrack_tpu_torch.cardrun import H, W, render_main_sequence
    from bundletrack_tpu_torch.data.hard_world import render_hard_sequence

    specs = hard_pass_specs(H=H, W=W, num_frames=HARD_FRAMES)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(specs) + 1, mp_context=multiprocessing.get_context("spawn")) as pool:
        hard = {name: pool.submit(render_hard_sequence, *a, **k) for name, (a, k) in specs.items()}
        main_seq = pool.submit(render_main_sequence, FAIL_FRAMES)
        passes = {name: f.result() for name, f in hard.items()}
        seq = main_seq.result()
    log(f"hard world: rendered {len(passes)} passes of {HARD_FRAMES} frames and a {FAIL_FRAMES}-frame "
        f"sequence at {H}x{W} in {time.perf_counter() - t0:.1f} s")
    return passes, seq


def hard_world_phase(passes, card: str) -> int:
    """bench.py's hard suite on the card: run_hard_suite on the five hard
    passes with bench.py's tracking configuration."""
    from bundletrack_tpu_torch import fleet_bench
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.eval import hard_suite
    from bundletrack_tpu_torch.kernels import matching as km

    cfg = fleet_bench.bench_config(H, W)  # bench.py's tracking configuration, classical frontend
    km.launches = 0  # count only this path's launches
    t0 = time.perf_counter()
    with recorded_calls(hard_suite, "track_sequence") as runs:
        aucs = hard_suite.run_hard_suite(cfg, passes=passes, device="cuda")
    track_s = time.perf_counter() - t0
    launches = km.launches
    tracked = sum(len(seq.gray) - 1 for seq in passes.values())
    for (name, seq), (poses, statuses, _) in zip(passes.items(), runs):
        rep = hard_suite.pass_report(poses, statuses, seq, hard_suite.PASS_SHAPES[name])
        log(f"hard world: {name}: ADD-S AUC {aucs[name]:.2f}, statuses {statuses.tolist()} "
            f"({int((statuses != 0).sum())} not OK), mean / max rotation error {rep['mean_rot_err_deg']:.2f} / "
            f"{rep['max_rot_err_deg']:.2f} deg, mean / max translation error {rep['mean_trans_err_mm']:.2f} / "
            f"{rep['max_trans_err_mm']:.2f} mm")
        if not np.all(np.isfinite(poses)):
            raise AssertionError(f"hard world: {name}: a pose is not finite")
    log(f"hard world: bench config at {H}x{W}, {HARD_FRAMES} frames per pass: mean ADD-S AUC {aucs['mean']:.2f}; "
        f"tracking {track_s:.1f} s; matcher launches {launches} for {tracked} tracked frames [{card}]")
    if launches != tracked:
        raise AssertionError(f"hard world: matcher launches {launches} != tracked frames {tracked}")
    missed = {n: aucs[n] for n in HARD_BARRED if aucs[n] <= HARD_ADDS_AUC_MIN}
    if missed:
        raise AssertionError(f"hard world: ADD-S AUC bars missed (> {HARD_ADDS_AUC_MIN}): {missed}")
    return launches


def fail_path_phase(seq, card: str) -> int:
    """An occlusion on the default configuration: the FAIL frames, the
    reinit gate and the recovery after it, on the card."""
    from bundletrack_tpu_torch.cardrun import H, W, timed_frames
    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.eval.metrics import pose_errors
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker
    from bundletrack_tpu_torch.tracker.state import STATUS_FAIL

    mask, depth = seq.mask.copy(), seq.depth.copy()
    for f in OCCLUDED:  # the object vanishes, as in tests/test_long_sequence.py
        mask[f] = False
        depth[f] = 0.0
    seq = seq._replace(mask=mask, depth=depth)
    tracker = Tracker(TrackerConfig(), H, W)
    km.launches = 0  # count only this path's launches
    poses, statuses, frame_ms = [], [], []
    for _, out, ms in timed_frames(tracker, seq, range(len(seq.gray)), np.linalg.inv(seq.ob_in_cam[0])):
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
        frame_ms.append(ms)
    launches = km.launches
    errs = [pose_errors(p, seq.ob_in_cam[f]) for f, p in enumerate(poses)]
    fails = {f for f, st in enumerate(statuses) if st == STATUS_FAIL}
    window = set(range(OCCLUDED[0], OCCLUDED[-1] + FAIL_WINDOW))
    tail = list(range(len(poses) - 10, len(poses)))
    tail_rot = float(np.mean([errs[f][0] for f in tail]))
    fail_ms = [frame_ms[f] for f in sorted(fails)]
    log(f"fail path: statuses {statuses}")
    log(f"fail path: FAIL frames {sorted(fails)} (must cover {list(OCCLUDED)} and lie in "
        f"{min(window)}..{max(window)}); rotation error per frame " + " ".join(f"{e[0]:.2f}" for e in errs))
    log(f"fail path: mean rotation error over frames {tail[0]}-{tail[-1]} {tail_rot:.4f} deg, terminal "
        f"{errs[-1][0]:.4f} deg / {errs[-1][1] * 1e3:.3f} mm; median frame {np.median(frame_ms[1:]):.2f} ms, "
        f"median FAIL frame {np.median(fail_ms) if fail_ms else float('nan'):.2f} ms; matcher launches {launches} "
        f"for {len(poses) - 1} tracked frames [{card}]")
    if not all(np.all(np.isfinite(p)) for p in poses):
        raise AssertionError("fail path: a pose is not finite")
    if launches != len(poses) - 1:
        raise AssertionError(f"fail path: matcher launches {launches} != tracked frames {len(poses) - 1}")
    if not set(OCCLUDED) <= fails <= window:
        raise AssertionError(f"fail path: FAIL frames {sorted(fails)}")
    if tail_rot >= FAIL_TAIL_ROT_DEG or errs[-1][1] >= FAIL_TERMINAL_TRANS_M:
        raise AssertionError(f"fail path: no recovery (tail rotation < {FAIL_TAIL_ROT_DEG} deg, terminal "
                             f"translation < {FAIL_TERMINAL_TRANS_M} m)")
    return launches


def verify_reject_phase(seq, card: str) -> int:
    """use_verification with a threshold below the keypoint noise: every BA
    solve is rejected and reverted, on the card."""
    import dataclasses

    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker
    from bundletrack_tpu_torch.tracker.state import STATUS_FAIL, STATUS_NO_BA

    cfg = TrackerConfig()
    cfg = cfg.replace(bundle=dataclasses.replace(cfg.bundle, use_verification=True, verify_dist_thresh=VERIFY_DIST))
    tracker = Tracker(cfg, H, W)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    km.launches = 0  # count only this path's launches
    statuses, errs = [], []
    for f in range(VERIFY_FRAMES):
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        pose = out.ob_in_cam.cpu().numpy()
        statuses.append(int(out.status))
        errs.append(float(np.linalg.norm(pose[:3, 3] - seq.ob_in_cam[f][:3, 3])) if np.all(np.isfinite(pose))
                    else float("inf"))
    launches = km.launches
    log(f"verify reject: threshold {VERIFY_DIST * 1e3:.2f} mm: statuses {statuses}; max translation error "
        f"{max(errs) * 1e3:.3f} mm; matcher launches {launches} [{card}]")
    if launches != VERIFY_FRAMES - 1:
        raise AssertionError(f"verify reject: matcher launches {launches} != tracked frames {VERIFY_FRAMES - 1}")
    if any(st != STATUS_NO_BA for st in statuses[1:]) or STATUS_FAIL in statuses or max(errs) >= VERIFY_TRANS_M:
        raise AssertionError(f"verify reject: bars missed (NO_BA after frame 0, no FAIL, translation < "
                             f"{VERIFY_TRANS_M} m)")
    return launches


# ---- training -----------------------------------------------------------------


def run_cli(main, argv) -> tuple:
    """(JSON metric lines, wall s) of a trainer's main(argv)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    return lines, time.perf_counter() - t0


def check_losses(name: str, lines, steps: int, trend: bool) -> list:
    losses = [line["loss"] for line in lines]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: {len(losses)} losses for {steps} steps, or one not finite: {losses}")
    head, tail = float(np.mean(losses[:TRAIN_TREND_N])), float(np.mean(losses[-TRAIN_TREND_N:]))
    log(f"{name}: losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; mean of the first {TRAIN_TREND_N} {head:.5f}, of the last {tail:.5f}")
    if trend and tail > head + TRAIN_TREND_SLACK:
        raise AssertionError(f"{name}: mean of the last losses {tail} > mean of the first {head} + {TRAIN_TREND_SLACK}")
    return losses


def one_step(make, batch_np, fields, dev: str) -> tuple:
    """(loss, {name: gradient as a flat f64 CPU tensor}) of one training
    step; `make(device)` -> (model, step)."""
    import torch

    model, step = make(dev)
    metrics = step([torch.from_numpy(batch_np[k]).to(dev) for k in fields])
    return float(metrics["loss"]), {n: p.grad.detach().double().cpu().flatten()
                                    for n, p in model.named_parameters() if p.grad is not None}


def card_vs_cpu_step(name: str, make, batch_np, fields, card: str) -> None:
    """One training step from the same weights on the same batch on the
    card and on the CPU: the relative loss difference and each gradient
    tensor's cosine.  `make(device)` -> (model, step)."""
    hold_step(name, one_step(make, batch_np, fields, "cuda"), one_step(make, batch_np, fields, "cpu"),
              "card vs CPU", card)


def hold_step(name: str, got: tuple, ref: tuple, what: str, card: str) -> None:
    """Holds one step's (loss, gradients) to a reference step's: the loss
    within TRAIN_CARD_LOSS_RTOL, every gradient's cosine at least
    TRAIN_CARD_GRAD_COS_MIN but the score convs' biases (logged)."""
    (loss_card, g_card), (loss_cpu, g_cpu) = got, ref
    if set(g_card) != set(g_cpu):
        raise AssertionError(f"{name}: {what}: the steps differ in which tensors get a gradient")
    rel = abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1e-12)
    cos, noise = {}, {}
    for n in g_cpu:
        c = float(g_card[n] @ g_cpu[n] / (g_card[n].norm() * g_cpu[n].norm() + 1e-300))
        (noise if n.startswith(TRAIN_NOISE_GRADS) and n.endswith(".bias") else cos)[n] = c
    worst = min(cos, key=cos.get)
    log(f"{name}: {what}, one step: loss {loss_card:.7g} / {loss_cpu:.7g} (relative {rel:.3e}, bar "
        f"{TRAIN_CARD_LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} ({worst}), median "
        f"{float(np.median(list(cos.values()))):.6f} over {len(cos)} tensors (bar {TRAIN_CARD_GRAD_COS_MIN})"
        + (f"; zero-in-exact-arithmetic biases (not barred): "
           + ", ".join(f"{n} {c:.3f}" for n, c in noise.items()) if noise else "") + f" [{card}]")
    if rel > TRAIN_CARD_LOSS_RTOL or cos[worst] < TRAIN_CARD_GRAD_COS_MIN:
        raise AssertionError(f"{name}: {what}: the steps disagree beyond the bars")


def timed_steps(name: str, step, batch, card: str) -> tuple:
    """(ms per step by CUDA events, median of TRAIN_TIMED_STEPS after
    TRAIN_WARMUP_STEPS, peak MiB) of step(batch); then TRAIN_PROFILED_STEPS
    more under utils/profiling.trace for launches and device time per step."""
    import collections

    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_median_ms(lambda: step(batch), runs=TRAIN_TIMED_STEPS, warmup=TRAIN_WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
        with trace(log_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILED_STEPS):
                step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / TRAIN_PROFILED_STEPS
    device_ms = sum(by_name.values())
    log(f"{name}: {ms:.2f} ms per step (CUDA events, median of {TRAIN_TIMED_STEPS} after "
        f"{TRAIN_WARMUP_STEPS} warm-up steps), peak {peak:.1f} MiB; profiler: {len(kernels) / TRAIN_PROFILED_STEPS:.0f} "
        f"launches, {device_ms:.3f} ms device time per step, busy {100 * device_ms * TRAIN_PROFILED_STEPS / wall_ms:.1f} %; "
        "top: " + "; ".join(f"{t:.3f} ms {n[:60]}" for n, t in by_name.most_common(3)) + f" [{card}]")
    return ms, peak


def compare_params(name: str, dir_a: str, dir_b: str, like) -> float:
    """Max over tensors of max |a - b| / max |a| between two params/ checkpoints."""
    from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state

    a, b = restore_tracker_state(dir_a, like), restore_tracker_state(dir_b, like)
    worst, noise = 0.0, []
    for n in a:
        r = float((a[n] - b[n]).abs().max() / a[n].abs().max().clamp(min=1e-30))
        if n.startswith(TRAIN_NOISE_GRADS) and n.endswith(".bias"):
            noise.append(f"{n} {r:.3e}")
        else:
            worst = max(worst, r)
    log(f"{name}: resumed vs uninterrupted parameters: max relative difference {worst:.3e} (bar {TRAIN_RESUME_RTOL})"
        + (f"; score-conv biases (not barred): {', '.join(noise)}" if noise else ""))
    return worst


def train_lfnet_phase(seq, card: str) -> dict:
    """The LF-Net trainer at the shipped widths: card against CPU for one
    step, the CLI at its defaults for 20 steps with a checkpoint at 10 and
    a resume from it, and the serving shape timed.  Returns the batch of
    the card-vs-CPU step (numpy)."""
    import torch

    from bundletrack_tpu_torch.apps import train_lfnet
    from bundletrack_tpu_torch.config import FrontendConfig
    from bundletrack_tpu_torch.data.pairs import lfnet_roi_pair_batch
    from bundletrack_tpu_torch.frontend.lfnet import init_lfnet
    from bundletrack_tpu_torch.models import LFNetTrainBatch, make_adam, make_lfnet_train_step

    cfg = FrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False)  # the CLI's defaults

    def make(dev, cfg=cfg):
        model, _ = init_lfnet(cfg, seed=0)
        model.to(dev)
        step = make_lfnet_train_step(model, make_adam(model.parameters(), 1e-3))
        return model, lambda b: step(LFNetTrainBatch(*b))

    pool = train_lfnet.build_batches(96, 8, 8, 0)
    card_vs_cpu_step("train_lfnet", make, pool[0], LFNetTrainBatch._fields, card)
    model, step = make("cuda")
    timed_steps("train_lfnet at the CLI's defaults (96x96, top-k 128, batch 8, f32)", step,
                [torch.from_numpy(pool[0][k]).cuda() for k in LFNetTrainBatch._fields], card)
    del model, step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lfnet_train_") as root:
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        save = train_lfnet.save_checkpoint

        def save_and_copy(ckpt_dir, step, *rest):
            save(ckpt_dir, step, *rest)
            if step == TRAIN_CKPT_STEP:
                shutil.copytree(ckpt_dir, b)

        argv = ["--steps", str(TRAIN_STEPS), "--log-every", "1", "--ckpt-every", str(TRAIN_CKPT_STEP)]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            train_lfnet.save_checkpoint = save_and_copy
            try:
                lines, s_a = run_cli(train_lfnet.main, argv + ["--ckpt-dir", a])
            finally:
                train_lfnet.save_checkpoint = save
            resumed, s_b = run_cli(train_lfnet.main, argv + ["--ckpt-dir", b, "--resume"])
        finally:
            torch.use_deterministic_algorithms(False)
        check_losses("train_lfnet CLI (--size 96 --batch 8 --top-k 128)", lines, TRAIN_STEPS, trend=True)
        log(f"train_lfnet CLI: {TRAIN_STEPS} steps in {s_a:.1f} s, resumed run ({TRAIN_STEPS - TRAIN_CKPT_STEP} "
            f"steps) {s_b:.1f} s, both rendering their pool")
        if [line["step"] for line in resumed] != list(range(TRAIN_CKPT_STEP + 1, TRAIN_STEPS + 1)):
            raise AssertionError(f"train_lfnet: the resumed run logged steps {[line['step'] for line in resumed]}")
        like = init_lfnet(cfg)[1]
        if compare_params("train_lfnet", os.path.join(a, "params"), os.path.join(b, "params"), like) > TRAIN_RESUME_RTOL:
            raise AssertionError("train_lfnet: the resumed run ends away from the uninterrupted one")

    serve = FrontendConfig(kind="lfnet", input_size=LFNET_SERVE_SIZE, top_k=LFNET_SERVE_TOPK, bf16=False)
    pairs = [(i, i + 1 + i % 4) for i in range(8)]
    batch_np = lfnet_roi_pair_batch(seq, pairs, LFNET_SERVE_SIZE, rng=np.random.RandomState(0))
    model, step = make("cuda", serve)
    batch = [torch.from_numpy(batch_np[k]).cuda() for k in LFNetTrainBatch._fields]
    timed_steps(f"train_lfnet at the serving shape ({LFNET_SERVE_SIZE}x{LFNET_SERVE_SIZE}, top-k "
                f"{LFNET_SERVE_TOPK}, batch 8, f32)", step, batch, card)
    del model, step, batch
    torch.cuda.empty_cache()
    return pool[0]


def train_vos_phase(seq, card: str) -> dict:
    """The VOS trainer at the shipped width 96, warm-started from the
    shipped weights: card against CPU for one step, 20 plain and 20
    rollout steps of the CLI at its defaults, steps timed at two sizes,
    and run_vos on the plain run's checkpoint.  Returns the clip batch of
    the card-vs-CPU step (numpy)."""
    import torch

    from bundletrack_tpu_torch.apps import run_vos, train_vos
    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
    from bundletrack_tpu_torch.data.native_io import read_png
    from bundletrack_tpu_torch.eval.vos_eval import mask_iou
    from bundletrack_tpu_torch.models import VOSTrainBatch, make_adam, make_vos_train_step
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    def make(dev, size=96, rollout=False):
        model, _ = load_vos_npz(VOS_CKPT)
        model.to(dev)
        step = make_vos_train_step(model, make_adam(model.parameters(), 1e-3), (size, size), rollout=rollout)
        return model, lambda b: step(VOSTrainBatch(*b))

    # a hard-world clip (stride 3) on which the shipped weights still err
    # (loss 0.017 plain, 0.047 rollout, on the CPU): on the CLI's easy clips
    # their loss is ~1e-7, where f32 rounding of p ~ 1 decides -log p
    clip = train_vos.build_clips(96, 4, 4, 3, 0, "hard", 35)[2]
    card_vs_cpu_step("train_vos", make, clip, VOSTrainBatch._fields, card)
    card_vs_cpu_step("train_vos --rollout", lambda dev: make(dev, rollout=True), clip, VOSTrainBatch._fields, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vos_train_") as root:
        ckpt = os.path.join(root, "ckpt")
        argv = ["--steps", str(TRAIN_STEPS), "--log-every", "1", "--init-npz", VOS_CKPT, "--width", "96"]
        plain, s_plain = run_cli(train_vos.main, argv + ["--ckpt-dir", ckpt])
        rollout, s_roll = run_cli(train_vos.main, argv + ["--rollout"])
        check_losses("train_vos CLI (--size 96 --batch 4 --clip-len 4, warm start)", plain, TRAIN_STEPS, trend=False)
        check_losses("train_vos CLI --rollout", rollout, TRAIN_STEPS, trend=False)
        log(f"train_vos CLI: {TRAIN_STEPS} plain steps in {s_plain:.1f} s, {TRAIN_STEPS} rollout steps in "
            f"{s_roll:.1f} s; last iou {plain[-1]['iou']:.4f} / iou_last {rollout[-1]['iou_last']:.4f}")

        data_dir = export_ycbineoat_sequence(seq, os.path.join(root, "cube"))
        out = os.path.join(root, "masks")
        run_vos.main(["--img_dir", os.path.join(data_dir, "rgb"), "--init_mask_file",
                      os.path.join(data_dir, "masks", "00000.png"), "--mask_save_dir", out,
                      "--checkpoint", os.path.join(ckpt, "params")])
        names = sorted(os.listdir(out))[1:]  # frame 0 is the given mask
        ious = [mask_iou(read_png(os.path.join(out, n)) > 0, seq.mask[f + 1]) for f, n in enumerate(names)]
    log(f"train_vos: run_vos --checkpoint <ckpt>/params (width 96 after {TRAIN_STEPS} steps) on the "
        f"{len(seq.gray)} VOS frames: mean IoU {np.mean(ious):.4f}, min {np.min(ious):.4f} over {len(ious)} "
        f"propagated frames (bars >= {VOS_TRAINED_MEAN_IOU_MIN}, >= {VOS_TRAINED_MIN_IOU_MIN}) [{card}]")
    if np.mean(ious) < VOS_TRAINED_MEAN_IOU_MIN or np.min(ious) < VOS_TRAINED_MIN_IOU_MIN:
        raise AssertionError("train_vos: the trained weights' IoU bars missed")

    for size in VOS_TRAIN_SIZES:
        clips = train_vos.build_clips(size, 4, 4, 1, 0, "easy", 35)[0]
        batch = [torch.from_numpy(clips[k]).cuda() for k in VOSTrainBatch._fields]
        for rollout in (False, True):
            model, step = make("cuda", size, rollout)
            timed_steps(f"train_vos {'--rollout ' if rollout else ''}at {size}x{size} (width 96, batch 4, "
                        f"clip 4)", step, batch, card)
            del model, step
    torch.cuda.empty_cache()
    return clip

# ---- the mesh: ranks of torch.distributed ---------------------------------------

MESH_SHARED_WORLD = 2  # ranks sharing the one card, over gloo
MESH_TIMEOUT_S = 300.0  # a collective that waits longer fails its rank, and so the run
MESH_TRACKER_ATOL = 1e-3  # max |pose entry| difference: JAX's bar, tests/test_pair_sharded.py:260
MESH_2D_STREAMS, MESH_2D_FRAMES = 2, 4
MESH_COLLECTIVE_FRAMES = 6  # frames of a fresh sharded tracker with the GN all-reduce timed


class MeshInputs(NamedTuple):
    seq: object  # the main 20-frame sequence
    tracker_poses: list  # the one-rank tracker's poses on it (tracker phase)
    fleet_seqs: list
    fleet_phases: list  # the fleet phase's RANSAC phases, per frame
    fleet_outs: list  # the one-rank fleet's (poses [S,4,4], statuses [S]) per frame
    join_outs: list  # the one-rank fleet's with streams 4-7 joining at JOIN_FRAME (join phase)
    lfnet_batch: dict  # the LF-Net card-vs-CPU batch (96x96, batch 8)
    vos_clip: dict  # the VOS card-vs-CPU clip batch (96x96, batch 4, clip 4)


def _timed_collectives(module):
    """Replaces module.all_reduce with a copy that waits for every rank of
    the group (a barrier) and synchronises the card before the call, and
    synchronises after it: the collective's own time, without the wait for
    the slowest rank.  Returns (the list of (numel, ms) it fills, undo)."""
    import torch
    import torch.distributed as dist

    original, calls = module.all_reduce, []

    def timed(t, group, *op):
        torch.cuda.synchronize()
        dist.barrier(group=group)
        t0 = time.perf_counter()
        out = original(t, group, *op)
        torch.cuda.synchronize()
        calls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return out

    module.all_reduce = timed
    return calls, lambda: setattr(module, "all_reduce", original)


def mesh_tracker(rank: int, world: int, seq) -> dict:
    """The default tracker with its BA pairs sharded over "pairs" (120 /
    world per rank): poses, statuses, frame ms, matcher launches, every
    launch held to the plain version on this rank's block; then a fresh
    tracker's GN all-reduces timed."""
    import torch

    from bundletrack_tpu_torch.cardrun import H, W, timed_frames
    from bundletrack_tpu_torch.config import BundleConfig, TrackerConfig
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.matching import pairwise
    from bundletrack_tpu_torch.parallel import make_mesh
    from bundletrack_tpu_torch.solver import gauss_newton
    from bundletrack_tpu_torch.tracker.driver import Tracker

    cfg = TrackerConfig(bundle=BundleConfig(ba_mesh_axis="pairs"))
    mesh = make_mesh({"pairs": world})
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    tracker = Tracker(cfg, H, W, mesh=mesh)
    with recorded_calls(pairwise, "fused_mutual_match_pairs") as outs, \
            recorded_calls(pairwise, "fused_mutual_match_pairs", args=True) as args:
        km.launches = 0
        run = list(timed_frames(tracker, seq, range(len(seq.gray)), init_pose))
        launches = km.launches
    per = P_PAIRS // world
    want_i = np.triu_indices(K_BA, k=1)[0][rank * per:(rank + 1) * per]
    max_err, report = 0.0, io.StringIO()
    try:
        with contextlib.redirect_stdout(report):  # a line per launch, printed only on a failure
            for f, (got, (a, kw)) in enumerate(zip(outs, args)):
                if not np.array_equal(a[4].cpu().numpy(), want_i):
                    raise AssertionError(f"mesh rank {rank}: the matcher's pairs are not this rank's block")
                ref = km.fused_mutual_match_pairs_reference(*a, **kw)
                torch.cuda.synchronize()
                max_err = max(max_err, check_kernel(f"mesh rank {rank} tracked frame {f + 1}", got, ref, a[:4],
                                                    a[4], a[5], kw))
    except AssertionError:
        log(report.getvalue())
        raise
    differ = [line for line in report.getvalue().splitlines() if "mutual differs" in line]
    log(f"mesh rank {rank}: {len(outs)} matcher launches held to the plain version on pairs "
        f"{rank * per}..{(rank + 1) * per - 1}: max |dist diff| {max_err:.3e}, {len(differ)} mutual rows differ, "
        "each a column near tie" + "".join("\n" + line for line in differ))
    del outs, args
    calls, undo = _timed_collectives(gauss_newton)
    try:
        fresh = Tracker(cfg, H, W, mesh=mesh)
        list(timed_frames(fresh, seq, range(MESH_COLLECTIVE_FRAMES), init_pose))
    finally:
        undo()
    ge = [ms for n, ms in calls if n > 1000]  # the H, g, cost all-reduce of each GN iteration
    return {"poses": np.stack([o.ob_in_cam.cpu().numpy() for _, o, _ in run]),
            "statuses": [int(o.status) for _, o, _ in run], "frame_ms": [ms for _, _, ms in run],
            "launches": launches, "max_abs_err": max_err, "pairs": per,
            "gn_allreduce_ms": float(np.median(ge)), "gn_allreduces_per_frame": len(ge) / (MESH_COLLECTIVE_FRAMES - 1),
            "other_collectives_ms": float(np.median([ms for n, ms in calls if n <= 1000]))}


def mesh_fleet(rank: int, world: int, fleet, phases, axis_sizes: dict, S: int, F: int, join: bool = False) -> dict:
    """S streams of the fleet phase over `axis_sizes`, each rank feeding and
    stepping its block of the streams with the fleet phase's phases; with
    `join`, streams 4-7 reset before JOIN_FRAME as in the join phase."""
    import torch

    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.config import BundleConfig, TrackerConfig
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.parallel import (
        fleet_observation,
        init_fleet_state,
        local_stream_slice,
        make_fleet_step,
        make_mesh,
    )
    from bundletrack_tpu_torch.tracker import set_streams

    cfg = TrackerConfig(bundle=BundleConfig(ba_mesh_axis="pairs" if "pairs" in axis_sizes else ""))
    mesh = make_mesh(axis_sizes)
    mine = range(S)[local_stream_slice(S, mesh)]
    rows = slice(mine.start, mine.stop)
    step, state = make_fleet_step(cfg, H, W, mesh=mesh), init_fleet_state(cfg, H, W, S, mesh=mesh)
    ip = torch.as_tensor(np.linalg.inv(fleet["ob_in_cam"][rows, 0]).astype(np.float32), device="cuda")
    km.launches = 0
    poses, statuses, frame_ms = [], [], []
    for f in range(F):
        if join and f == JOIN_FRAME:
            local = [s - mine.start for s in joined_streams() if s in mine]
            if local:
                state = set_streams(state, local, init_fleet_state(cfg, H, W, S, mesh=mesh))
            ip = torch.as_tensor(join_init_poses(fleet["ob_in_cam"], f, joined_streams())[rows], device="cuda")
        obs = fleet_observation(*(fleet[k][rows, f] for k in ("gray", "depth", "mask")), fleet["K"][rows], "cuda")
        ph = None if phases[f] is None else tuple(p[rows].cuda() for p in phases[f])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, obs, ip, ph)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(out.status.cpu().numpy())
    return {"streams": (mine.start, mine.stop), "poses": np.stack(poses), "statuses": np.stack(statuses),
            "frame_ms": frame_ms, "launches": km.launches}


def mesh_train(rank: int, world: int, lfnet_batch: dict, vos_clip: dict) -> dict:
    """One LF-Net step at dp=world,tp=1 and dp=1,tp=world, and one VOS step
    at dp=world, on the global batches of the training phases; each then
    timed.  Gradients made whole (rank 0 keeps them)."""
    import torch

    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.config import FrontendConfig
    from bundletrack_tpu_torch.frontend.lfnet import gather_lfnet_state_dict, init_lfnet
    from bundletrack_tpu_torch.models import LFNetTrainBatch, VOSTrainBatch, make_adam
    from bundletrack_tpu_torch.models.vos import load_vos_npz
    from bundletrack_tpu_torch.parallel import make_mesh, make_sharded_lfnet_train_step, make_sharded_vos_train_step

    def run(name, model, step, batch):
        metrics = step(batch)
        grads = {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}
        group = getattr(getattr(model, "descriptor", None), "model_group", None)
        if group is not None:
            grads = gather_lfnet_state_dict(grads, group)
        ms = cuda_median_ms(lambda: step(batch), runs=TRAIN_TIMED_STEPS, warmup=TRAIN_WARMUP_STEPS)
        return name, (float(metrics["loss"]), {n: g.double().cpu().flatten() for n, g in grads.items()}
                      if rank == 0 else None, ms)

    out = {}
    batch = LFNetTrainBatch(*(torch.from_numpy(lfnet_batch[k]).cuda() for k in LFNetTrainBatch._fields))
    for dp, tp in ((world, 1), (1, world)):
        model, _ = init_lfnet(FrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False), seed=0)
        model.cuda()
        opt = make_adam(model.parameters(), 1e-3)
        step = make_sharded_lfnet_train_step(model, opt, make_mesh({"data": dp, "model": tp}))
        if tp > 1 and tuple(model.descriptor.fc1.weight.shape)[0] != 512 // tp:
            raise AssertionError("mesh: fc1 is not split over the model axis")
        name, res = run(f"train_lfnet dp={dp} tp={tp}", model, step, batch)
        out[name] = res
    model, _ = load_vos_npz(VOS_CKPT)
    model.cuda()
    step = make_sharded_vos_train_step(model, make_adam(model.parameters(), 1e-3), make_mesh({"data": world}),
                                       (96, 96))
    clip = VOSTrainBatch(*(torch.from_numpy(vos_clip[k]).cuda() for k in VOSTrainBatch._fields))
    name, res = run(f"train_vos dp={world}", model, step, clip)
    out[name] = res
    return out


def mesh_rank(rank: int, tmp: str, fleet_phases_cpu: list) -> None:
    """One rank of the mesh phase: every job in turn, results to tmp."""
    import types

    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    d = np.load(os.path.join(tmp, "inputs.npz"))
    seq = types.SimpleNamespace(**{k: d["seq_" + k] for k in ("gray", "depth", "mask", "K", "ob_in_cam")})
    fleet = {k: d["fleet_" + k] for k in ("gray", "depth", "mask", "K", "ob_in_cam")}
    batches = [{k[len(p):]: d[k] for k in d.files if k.startswith(p)} for p in ("lfnet_", "vos_")]
    out = {"tracker": mesh_tracker(rank, world, seq),
           "fleet": mesh_fleet(rank, world, fleet, fleet_phases_cpu, {"stream": world}, FLEET_STREAMS, FLEET_FRAMES),
           "fleet_2d": mesh_fleet(rank, world, fleet, [None if p is None else tuple(t[:MESH_2D_STREAMS] for t in p)
                                                       for p in fleet_phases_cpu],
                                  {"stream": 1, "pairs": world}, MESH_2D_STREAMS, MESH_2D_FRAMES),
           "fleet_join": mesh_fleet(rank, world, fleet, fleet_phases_cpu, {"stream": world}, FLEET_STREAMS,
                                    FLEET_FRAMES, join=True),
           "train": mesh_train(rank, world, *batches)}
    out["launches"] = sum(out[k]["launches"] for k in ("tracker", "fleet", "fleet_2d", "fleet_join"))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def mesh_phase(inp: MeshInputs, backend: str, world: int, card: str, device=None) -> int:
    """The tracker with its BA pairs sharded, the fleet over "stream", a 2-D
    stream x pairs fleet and the dp x tp / dp training steps, on `world`
    spawned ranks (file:// rendezvous): with gloo, ranks sharing one card;
    with NCCL, one rank per card.  Held to the one-rank runs of the earlier
    phases; returns the matcher launches of all ranks."""
    import torch

    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.config import FrontendConfig
    from bundletrack_tpu_torch.eval.metrics import adds_auc, pose_errors
    from bundletrack_tpu_torch.frontend.lfnet import init_lfnet
    from bundletrack_tpu_torch.models import LFNetTrainBatch, VOSTrainBatch, make_adam, make_lfnet_train_step
    from bundletrack_tpu_torch.models import make_vos_train_step
    from bundletrack_tpu_torch.models.vos import load_vos_npz
    from bundletrack_tpu_torch.parallel.distributed import spawn_ranks

    where = "sharing one card" if backend == "gloo" else "one per card"
    tag = f"mesh[{world} ranks {where}, {backend}]"
    if backend == "nccl":  # every card's name and power limit, not only the first's
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()
        card = "; ".join(f"card {i}: {line}" for i, line in enumerate(smi))
    log(f"{tag}: backend {backend!r} asked for explicitly (NCCL refuses two ranks on one card); "
        f"rendezvous file://, collective timeout {MESH_TIMEOUT_S:.0f} s")

    def make_lfnet(dev):
        model, _ = init_lfnet(FrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False), seed=0)
        model.to(dev)
        step = make_lfnet_train_step(model, make_adam(model.parameters(), 1e-3))
        return model, lambda b: step(LFNetTrainBatch(*b))

    def make_vos(dev):
        model, _ = load_vos_npz(VOS_CKPT)
        model.to(dev)
        step = make_vos_train_step(model, make_adam(model.parameters(), 1e-3), (96, 96))
        return model, lambda b: step(VOSTrainBatch(*b))

    ref_lfnet = one_step(make_lfnet, inp.lfnet_batch, LFNetTrainBatch._fields, "cuda")
    ref_vos = one_step(make_vos, inp.vos_clip, VOSTrainBatch._fields, "cuda")
    one_device_ms = {}
    for key, make, batch_np, fields in (("train_lfnet", make_lfnet, inp.lfnet_batch, LFNetTrainBatch._fields),
                                        ("train_vos", make_vos, inp.vos_clip, VOSTrainBatch._fields)):
        _, step = make("cuda")
        batch = [torch.from_numpy(batch_np[k]).cuda() for k in fields]
        one_device_ms[key] = cuda_median_ms(lambda: step(batch), runs=TRAIN_TIMED_STEPS, warmup=TRAIN_WARMUP_STEPS)
    n_fl = FLEET_FRAMES
    arrays = {"seq_" + k: np.asarray(getattr(inp.seq, k)) for k in ("gray", "depth", "mask", "K", "ob_in_cam")}
    arrays.update({"fleet_" + k: np.stack([np.asarray(getattr(q, k))[:n_fl] if k != "K" else q.K
                                           for q in inp.fleet_seqs]) for k in ("gray", "depth", "mask", "K",
                                                                               "ob_in_cam")})
    arrays.update({"lfnet_" + k: v for k, v in inp.lfnet_batch.items()})
    arrays.update({"vos_" + k: v for k, v in inp.vos_clip.items()})
    phases_cpu = [None if p is None else tuple(t.cpu() for t in p) for p in inp.fleet_phases]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
        t0 = time.perf_counter()
        spawn_ranks(mesh_rank, world, (tmp, phases_cpu), backend=backend, device=device, timeout_s=MESH_TIMEOUT_S)
        log(f"{tag}: the ranks ran in {time.perf_counter() - t0:.1f} s (spawn, CUDA init and kernel load included)")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]

    # tracker: both ranks equal; the one-rank tracker's statuses, poses within 1e-3 and its bars
    tr = [r["tracker"] for r in res]
    same = max(float(np.abs(t["poses"] - tr[0]["poses"]).max()) for t in tr)
    vs_one = float(np.abs(tr[0]["poses"] - np.stack(inp.tracker_poses)).max())
    errs = [pose_errors(p, inp.seq.ob_in_cam[f]) for f, p in enumerate(tr[0]["poses"])]
    rot, trans = max(e[0] for e in errs), max(e[1] for e in errs)
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    auc = adds_auc(list(tr[0]["poses"]), list(inp.seq.ob_in_cam), model_pts)
    med = max(float(np.median(t["frame_ms"][3:])) for t in tr)
    log(f"{tag}: tracker, BA pairs sharded over 'pairs' ({tr[0]['pairs']} of {P_PAIRS} per rank): statuses "
        f"{tr[0]['statuses']}; the ranks' poses differ by max {same:.3e}; against the one-rank tracker max |pose "
        f"entry diff| {vs_one:.3e} (bar {MESH_TRACKER_ATOL}); worst rotation {rot:.4f} deg, translation "
        f"{trans * 1e3:.3f} mm, ADD-S AUC {auc:.2f}; median frame {med:.2f} ms (slowest rank, frames 3..); "
        f"matcher launches per rank {[t['launches'] for t in tr]}, each held to the plain version on its block "
        f"(max |dist diff| {max(t['max_abs_err'] for t in tr):.3e}); GN all-reduce of H, g, cost "
        f"{tr[0]['gn_allreduce_ms']:.3f} ms per iteration ({tr[0]['gn_allreduces_per_frame']:.1f} per frame), "
        f"the other collectives {tr[0]['other_collectives_ms']:.3f} ms each (after a barrier: the collective "
        f"alone) [{card}; {where}]")
    if any(t["statuses"] != tr[0]["statuses"] for t in tr) or same != 0.0:
        raise AssertionError(f"{tag}: the ranks' tracker results differ")
    if any(tr[0]["statuses"]) or vs_one > MESH_TRACKER_ATOL:
        raise AssertionError(f"{tag}: the sharded tracker differs from the one-rank tracker")
    if rot >= 1.0 or trans >= 0.005 or auc <= 95.0:
        raise AssertionError(f"{tag}: the sharded tracker misses the tracker's pose bars")
    if any(t["launches"] != len(inp.seq.gray) - 1 for t in tr):
        raise AssertionError(f"{tag}: matcher launches per rank != tracked frames")

    # fleets: the ranks' blocks in rank order against the one-rank fleet
    # (the join run's against the one-rank fleet with the same streams joining)
    for key, S, F in (("fleet", FLEET_STREAMS, FLEET_FRAMES), ("fleet_2d", MESH_2D_STREAMS, MESH_2D_FRAMES),
                      ("fleet_join", FLEET_STREAMS, FLEET_FRAMES)):
        blocks = {r[key]["streams"]: r[key] for r in res}
        worst = (0.0, 0.0)
        for f in range(F):
            poses = np.concatenate([b["poses"][f] for _, b in sorted(blocks.items())])
            statuses = np.concatenate([b["statuses"][f] for _, b in sorted(blocks.items())])
            ref_poses, ref_statuses = (inp.join_outs if key == "fleet_join" else inp.fleet_outs)[f]
            if not np.array_equal(statuses, ref_statuses[:S]):
                raise AssertionError(f"{tag}: {key}: statuses differ from the one-rank fleet at frame {f}")
            for s in range(S):
                e = pose_errors(poses[s], ref_poses[s])
                worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        med = max(float(np.median(r[key]["frame_ms"][3:])) for r in res)
        launches = [r[key]["launches"] for r in res]
        log(f"{tag}: {key} ({S} streams, {F} frames, blocks {sorted(blocks)}): against the one-rank fleet with the "
            f"same phases max {worst[0]:.3e} deg, {worst[1]:.3e} m (bars {FLEET_VS_SINGLE_ROT_DEG} deg, "
            f"{FLEET_VS_SINGLE_TRANS_M} m); median fleet frame {med:.2f} ms on the slowest rank, {S * 1e3 / med:.2f} "
            f"frames/s aggregate; matcher launches per rank {launches} [{card}; {where}]")
        if worst[0] >= FLEET_VS_SINGLE_ROT_DEG or worst[1] >= FLEET_VS_SINGLE_TRANS_M:
            raise AssertionError(f"{tag}: {key} differs from the one-rank fleet")
        # in the join run a rank whose streams all start on the join frame
        # tracks none there, so it launches the matcher once less
        want = [F - 1 - (key == "fleet_join" and all(s in joined_streams() for s in range(*st)))
                for st in (r[key]["streams"] for r in res)]
        if launches != want:
            raise AssertionError(f"{tag}: {key}: matcher launches per rank {launches} != fleet frames tracked {want}")

    # training: rank 0's whole gradients against the one-device step on the card
    for name, (loss, grads, _) in res[0]["train"].items():
        ref = ref_vos if name.startswith("train_vos") else ref_lfnet
        hold_step(f"{tag} {name}", (loss, grads), ref, "sharded vs one device", card)
        ms = [r["train"][name][2] for r in res]
        log(f"{tag} {name}: {max(ms):.2f} ms per step on the slowest rank (CUDA events, median of "
            f"{TRAIN_TIMED_STEPS} after {TRAIN_WARMUP_STEPS}), per rank {[round(m, 2) for m in ms]}; one device "
            f"{one_device_ms[name.split()[0]]:.2f} ms on the same global batch [{card}; {where}]")
    return sum(r["launches"] for r in res)


def mesh_phases(inp: MeshInputs, card: str, phase_s: dict) -> int:
    """The mesh phase with 2 ranks on cuda:0 over gloo, then, where the
    machine has two or more cards, over NCCL with one rank per card (world
    4 or 2); returns the matcher launches of all their ranks."""
    import torch

    t0 = time.perf_counter()
    launches = mesh_phase(inp, "gloo", MESH_SHARED_WORLD, card, device="cuda:0")
    phase_s["mesh, 2 ranks sharing one card"] = time.perf_counter() - t0
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        world = 4 if torch.cuda.device_count() >= 4 else 2
        launches += mesh_phase(inp, "nccl", world, card)
        phase_s[f"mesh, nccl over {world} cards"] = time.perf_counter() - t0
    return launches


def mesh_only(seq, cfg, card: str) -> None:
    """`chip_smoke.py --mesh-only`: the mesh phases and the one-rank runs
    they are held to (the tracker, the 8-stream fleet, the training
    batches), nothing else: a call on a machine with several cards."""
    from bundletrack_tpu_torch.apps import train_lfnet, train_vos

    _, _, poses = tracker_phase(seq, cfg, card)
    fleet_seqs = render_fleet_sequences()
    phases = fleet_phases(cfg, FLEET_STREAMS, FLEET_FRAMES)
    outs, frame_ms, _ = run_fleet(cfg, fleet_seqs, FLEET_FRAMES, phases)
    med = float(np.median(frame_ms[3:]))
    log(f"fleet, one rank: {FLEET_STREAMS} streams, median fleet frame {med:.2f} ms ({FLEET_STREAMS * 1e3 / med:.2f} "
        f"frames/s aggregate) over frames 3..{FLEET_FRAMES - 1} [{card}]")
    join_outs = run_fleet(cfg, fleet_seqs, FLEET_FRAMES, phases, join=True)[0]
    inp = MeshInputs(seq, poses, fleet_seqs, phases, outs, join_outs, train_lfnet.build_batches(96, 8, 8, 0)[0],
                     train_vos.build_clips(96, 4, 4, 3, 0, "hard", 35)[2])
    phase_s = {}
    launches = mesh_phases(inp, card, phase_s)
    log(f"mesh phases: matcher launches {launches} (all ranks); " + ", ".join(f"{k} {v:.1f} s"
                                                                             for k, v in phase_s.items()))


def main(argv) -> int:
    import torch

    if argv not in ([], ["--mesh-only"]):
        print("usage: chip_smoke.py [--mesh-only]", file=sys.stderr)
        return 2
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

    if argv == ["--mesh-only"]:
        mesh_only(seq, cfg, card)
        log(card)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    kernel = kernel_phase(seq, cfg, device, lf_cfg, lfnet)
    phase_s = {}
    t0 = time.perf_counter()
    classical_launches, _, classical_poses = tracker_phase(seq, cfg, card)
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
    t0 = time.perf_counter()
    fleet_seqs = render_fleet_sequences()
    fleet_launches, fleet_ph, fleet_outs = fleet_phase(fleet_seqs, cfg, card)
    phase_s["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    join_launches, join_outs = join_phase(fleet_seqs, cfg, card, fleet_ph, fleet_outs)
    phase_s["join"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    passes, fail_seq = render_new_phase_inputs()
    phase_s["hard world render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hard_launches = hard_world_phase(passes, card)
    phase_s["hard world"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fail_launches = fail_path_phase(fail_seq, card)
    phase_s["fail path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_launches = verify_reject_phase(seq, card)
    phase_s["verify reject"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lfnet_fleet_launches, _ = lfnet_fleet_phase(fleet_seqs, lf_cfg, lfnet, card)
    phase_s["lfnet fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcg_launches = pcg_tracker_phase(seq, cfg, card, classical_poses)
    phase_s["pcg tracker"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    photometric_fusion_phase(seq, card)
    phase_s["photometric and fusion"] = time.perf_counter() - t0
    from bundletrack_tpu_torch.kernels import matching as km

    km.launches = 0
    t0 = time.perf_counter()
    lfnet_batch = train_lfnet_phase(seq, card)
    phase_s["train lfnet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vos_clip = train_vos_phase(seq, card)
    phase_s["train vos"] = time.perf_counter() - t0
    if km.launches:  # the training paths reach no kernel of the port
        raise AssertionError(f"training phases launched the matcher {km.launches} times")
    mesh_inputs = MeshInputs(seq, classical_poses, fleet_seqs, fleet_ph, fleet_outs, join_outs, lfnet_batch, vos_clip)
    mesh_launches = mesh_phases(mesh_inputs, card, phase_s)
    launches = {
        "classical tracker phase": classical_launches, "lfnet CLI phase (filter 0 and filtered PNGs)": cli_launches,
        "VOS chain": vos_chain_launches, "NOCS chain": nocs_launches, "fleet": fleet_launches, "join": join_launches,
        "hard world": hard_launches, "fail path": fail_launches, "verify reject": verify_launches,
        "lfnet fleet": lfnet_fleet_launches, "pcg tracker": pcg_launches, "mesh (all ranks)": mesh_launches,
    }
    kernel["launches"] = sum(launches.values())
    log("matcher launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()) + "; training phases 0")
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
    sys.exit(main(sys.argv[1:]))
