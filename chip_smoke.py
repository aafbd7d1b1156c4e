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
   frames.  Then it tracks the 20 frames again on a fresh Tracker with the
   same inputs: every status and every pose bit-equal to the first run's.
   Then the normal-blocks kernel (csrc/normal_blocks.cu: the Gauss-Newton
   pair blocks summed into H and g in one fixed order, the CPU's): every
   call of both runs (the sparse and the dense terms at K=16, P=120) held
   bit for bit to its plain version on CPU copies of the same inputs, the
   same on a graph of 40 pairs over 6 frames drawn with replacement, on
   the 120 pairs with 7 repeated and 2 self pairs, on 300 pairs of two
   frames (one output block with more terms than the kernel lists at a
   time) and on 1500 pairs over 16 frames (more than one tile of pair
   indices); 20 calls on one input must give equal bits
   (`scatter_repeats_differ`); each shape timed with CUDA events (median
   of 25 after warm-up) and the profiler's device us beside the plain
   version on the card (index_add_, whose atomics add in a varying order)
   and index_add_ alone, with its bytes and operations bounds.  Every path
   whose GN solve runs (phases 3, 5, 7-16 and 19, every rank) must launch
   it.
4. LF-Net forward alone at 400x400 in bf16 with the shipped weights
   (checkpoints/lfnet_params.npz), CUDA events, median of 25 after warm-up;
   launches, device time, top kernels, the sums kernel's share and bound
   from the profiler.  Before it, the sums kernel (csrc/xla_order_sums.cu:
   the norms' statistics in XLA's order, which the bf16 forward computes
   as the jitted JAX forward does) on every norm input of one 400x400 bf16
   forward, the descriptor's at 512 keypoints included, and of the fleet's
   batched forward of 8 crops: at most 13 launches per forward (one per
   GroupNorm, one for the photo's instance norm, one for the five score
   maps'); its sums (and, for the GroupNorms, the mean and variance its
   last block derives; for the instance norms their means and variances)
   equal to its plain version's bit for bit, each shape timed beside
   torch.sum of the same tensor (torch.var_mean per map) and its bounds
   (the dependent chain of adds, bytes, operations).  Every path that runs
   the bf16 LF-Net (phases 4, 5, 10, 11, 14) must launch it.
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
   column near tie, as in phase 2), and timed there with its bound; every
   call of the normal-blocks kernel in the phase (the fleet's S=8 batched
   solve among them) is held bit for bit to its plain version, and timed
   at S=8.  Then aggregate frames/s at S = 1, 4 and 8 on
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
   Then the long-horizon phase: bench.py's long suite, the three
   128-frame passes of `long_hard_passes` (orbit, occluder, scale2x) at
   480x640, seed 0, rendered in a process pool, every frame tracked on the
   JAX tracker's own seed-0 RANSAC draws (eval/jax_draws_seed0.npz through
   `eval/replay.replay_long_suite`): LF-Net (400x400 bf16) on the three
   passes and on the orbit re-tracked on masks that VOS propagates online
   (shipped weights, long_range(128), 96x96), then the classical frontend
   on the three, with bench.py's tracking configuration; then bench.py's
   LF-Net hard-suite row on the 16-frame hard passes.  Each pass's report,
   status counts and median frame ms beside the JAX package's run of the
   same suite on the same draws (eval/jax_long_suite_cpu.json, on a CPU)
   and BENCH_full_r05.json's; bars: every pose finite, matcher launches =
   tracked frames, ADD-S AUC >= JAX's - 3 and FAIL frames <= JAX's + 2 on
   each pass where JAX's AUC >= 90 (LONG_*), except LF-Net orbit_vosmask,
   which is tracked again on the draws of the JAX trackers seeded 1-7 (the
   same VOS masks and frames) and barred on the means over the eight draw
   sets against JAX's means on them (`vosmask_seeds_missed`: mean AUC >=
   JAX's - 3, mean FAIL frames <= JAX's + 2), the VOS masks' mean IoU within
   0.05 of JAX's and, on the first 8 propagated frames, within
   VOS_CPU_DIFF_MAX of the port on the CPU; the LF-Net hard suite > 90 on
   cube, cylinder, lshape, fastrot.
11. Eval-suite phase: bench.py's `_frontend_quality`, `_bench_nocs` and
   `_bench_vos` at their own sizes and seeds, from the inputs the JAX
   package's run of them on a CPU recorded
   (eval/jax_eval_suite_cpu.json, rendered by the port in two spawned
   processes while phase 10 runs; `eval/replay.replay_eval_suite`):
   repeatability, inlier rate and matches of both frontends (LF-Net at
   400x400 bf16) on the easy world and the rolling L-shape (240x320, 5
   frames, gap 1, 3 px); the NOCS protocol on a 48-frame hard cube at
   480x640 (`nocs_config` with bench.py's bundle settings, every frame on
   the JAX tracker's seed-0 draws, the init pose perturbed by +-0.02 m from
   RandomState(0)); VOS on easy32, hard110, hard110 with long_range(110)
   and occluder48 at 96x96 with the shipped width-96 weights.  Printed
   beside the JAX file and BENCH_full_r05.json; bars
   (`eval/replay.eval_suite_missed`): repeatability and inlier rate within
   0.02 (classical) / 0.04 (LF-Net) of JAX's and matches within 5 %;
   5deg5cm and IoU25 at least JAX's - 2 and FAIL frames at most JAX's;
   each clip's mean IoU within 0.01 of JAX's and its min within 0.03;
   hard110's first 8 propagated masks within VOS_CPU_DIFF_MAX of the port
   on the CPU; matcher launches = the NOCS pass's tracked frames.
12. FAIL-path phase: 48 frames of the tracker phase's sequence with frames
   16-18 occluded (mask and depth empty), the default TrackerConfig; bars
   of tests/test_long_sequence.py: the FAIL frames cover 16-18 and lie in
   16..35, mean rotation error over frames 38-47 < 3 deg, terminal
   translation error < 15 mm.
13. Verify-reject phase: 10 frames with bundle.use_verification and a
   1.25 mm threshold (the test's 5 mm at 120x160, scaled to the 480x640
   pixel), which rejects every BA solve; bars of
   tests/test_verification_e2e.py: every frame after the first NO_BA, none
   FAIL, translation error < 10 mm.  In phases 10-13 the matcher launches
   once per tracked frame, FAIL frames included (the BA pair section runs
   on every frame after the first).
14. LF-Net fleet phase: phase 9's 8 streams through the fleet step with
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
15. PCG tracker phase: phase 3's frames with bundle.solver_backend="pcg",
   held to phase 3's bars; frame latency, kernel launches, device ms and
   device-to-host syncs per frame beside the Cholesky solve's.
16. Photometric and fusion phase: tests/test_photometric.py's in-plane
   shift solve on the card (the 4 mm shift below 2 mm);
   dense_p2p_from_compact with the colour term on a 16-frame pool of the
   rendered frames at the tracker's low-res size (120x160, C = 4096, 120
   pairs), card against CPU within DENSE_CARD_RTOL, timed beside the
   depth term alone and the compaction; fuse_depth_frames on 16 480x640
   depth maps, card against CPU within FUSION_ATOL_M, timed.
17. Train LF-Net phase, at the shipped widths (the default FrontendConfig,
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
18. Train VOS phase, at the shipped width 96 warm-started from
   checkpoints/vos_params.npz: card against CPU for one plain and one
   rollout step (the same bars); `apps.train_vos.main` at its defaults
   (96x96, batch 4, clip 4) for 20 plain and 20 --rollout steps, every
   loss finite; `apps.run_vos --checkpoint <ckpt>/params` with the plain
   run's weights on phase 6's frames (mean and min IoU bars
   VOS_TRAINED_*); plain and rollout steps timed at 96x96 and 256x256.
   The training phases launch the matcher 0 times.
19. Mesh phase: 2 ranks spawned with torch.multiprocessing (a file://
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
   dp=2,tp=1 and dp=1,tp=2 (phase 17's batch) and VOS at dp=2 (phase 18's
   clip), one step against the one-device step on the card (the training
   bars).  Logs ms per tracked frame, the fleets' aggregate frames/s, ms
   per training step and the GN all-reduce's ms per iteration: with two
   host processes on one card, a measure of the collectives' cost, not of
   scaling.  With two or more cards it runs again over NCCL, one rank per
   card (world 2 or 4).  A rank's failure fails the run.
20. Prints one JSON line describing every kernel (the matcher's launches
   summed over phases 3, 5, 7-15 and 19, every rank; the sums kernel's over
   phases 4, 5, 10, 11 and 14; the normal-blocks kernel's over phases 3, 5,
   7-16 and 19, every rank, each logged per path), the card's line, and as
   its last line {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and the last line is not
printed.  Without a CUDA device, or without the package beside it, it fails.

    python3 chip_smoke.py --mesh-only

runs step 1, the one-rank tracker, fleet and join runs of phases 3 and 9
and phase 19 alone: the call to make on a machine with several cards.

    python3 chip_smoke.py --long-only

runs step 1 and phase 10's long-horizon suite alone (rendering the hard
passes it needs for the LF-Net hard-suite row), with the same last line.

    python3 chip_smoke.py --eval-only

runs step 1 and phase 11's eval suite alone (rendering its sequences
itself), with the same last line.

    python3 chip_smoke.py --vosmask-repeats N

runs step 1, then checks that the card repeats phase 10's orbit_vosmask:
20 calls of the GN scatter on one input give equal bits, the VOS masks of
the rendered orbit generated twice are equal, and every draw set tracked N
times on them gives the same ADD-S AUC and FAIL frames each time (the
poses' differing bits logged); it logs each run's eight-set means against
the bars, and has the same last line.
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

# a rerun of the same chain on the card: the GN blocks are added in one
# fixed order (csrc/normal_blocks.cu), so a rerun should repeat its bits (the
# phase logs the byte-identical pose files); the bar stays the fleet-vs-single
# tolerance below, as the card sums products and convolutions in cuBLAS's
# and cuDNN's orders, not the CPU's
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

# bench.py's long-horizon suite: long_hard_passes(H=480, W=640,
# num_frames=128, seed=0), every frame on the JAX tracker's own seed-0 RANSAC
# draws (bundletrack_tpu_torch/eval/jax_draws_seed0.npz), held to the JAX
# package's run of the same suite on the same draws, on a CPU
# (bundletrack_tpu_torch/eval/jax_long_suite_cpu.json).
LONG_FRAMES = 128
# A pass is barred where that JAX run is well conditioned, its ADD-S AUC at
# least LONG_BARRED_AUC: the card's AUC at least JAX's - LONG_AUC_SLACK, its
# FAIL frames at most JAX's + LONG_FAIL_SLACK.  Below it (in that run both
# scale2x passes, 88.01 and 51.33) the JAX tracker itself degrades, and where
# it lands is chaotic in the draws and in f32 rounding (one BA edge flipped
# at a gate moves a frame by 0.7 deg, tests/test_torch_long_suite.py; on
# classical scale2x BENCH_full_r05.json, a TPU run of an older tree, has 61.92):
# those passes are printed beside JAX's, not barred.
LONG_BARRED_AUC, LONG_AUC_SLACK, LONG_FAIL_SLACK = 90.0, 3.0, 2
# The LF-Net orbit on online VOS masks (orbit_vosmask) is ill conditioned
# where the masks fail (frames 85-95, IoU down to 0.18): under a 2^-18
# change of its input the JAX tracker moves 22 deg at frame 95, so one draw
# set's AUC is a lottery.  That pass is tracked on LONG_SEEDS' draw sets
# (the JAX trackers seeded 0-7; eval/jax_draws_seed0.npz and
# eval/jax_draws_seeds.npz) and barred on the means over them against the
# JAX package's means on the same draws (eval/jax_long_suite_cpu.json for
# seed 0, eval/jax_long_vosmask_seeds_cpu.json for 1-7), with the slacks
# above: `vosmask_seeds_missed`.
LONG_SEEDS = tuple(range(8))
LONG_SEEDS_PASS = "orbit_vosmask"
# the online VOS masks of the orbit (long_range(128), 96x96): their mean IoU
# against mask_gt within this of the JAX run's; and on the first
# LONG_VOS_CPU_FRAMES propagated frames the card against the port on the CPU
# within VOS_CPU_DIFF_MAX, the VOS phase's bar
LONG_VOS_IOU_SLACK, LONG_VOS_CPU_FRAMES = 0.05, 8

# bench.py's frontend quality, NOCS protocol with a noisy initial pose and
# VOS clips, from the JAX package's run of them on a CPU with the inputs it
# recorded (bundletrack_tpu_torch/eval/jax_eval_suite_cpu.json); the bars
# are eval/replay.py's (FQ_*, NOCS_SLACK, VOS_*).  On the first
# EVAL_VOS_CPU_FRAMES propagated frames of this clip the card's masks
# against the port on the CPU within VOS_CPU_DIFF_MAX.
EVAL_VOS_CPU_CLIP, EVAL_VOS_CPU_FRAMES = "hard110", 8
EVAL_RENDER_PROCESSES = 2  # beside the long suite's render pool: the 48-frame NOCS pass in one, the rest in the other

FLEET_STREAMS, FLEET_FRAMES = 8, 12
# stream 0 of the fleet against a single-stream Tracker with the same
# phases: batched products sum in cuBLAS's order for the batched shapes,
# not the single stream's (the GN blocks themselves are added in one fixed
# order); the tolerance of the port's trajectory against JAX's
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
# |entry| of H, g and the cost: the products sum in cuBLAS's order, not the
# CPU's (the pair blocks are added in the CPU's order), and a pixel whose
# projection lies within an ulp of a half pixel or a gate can change its
# association (one of ~4000 pixels of a pair); correspondence counts per
# pair may differ by as many
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
def timed_calls(owner, name: str):
    """Times every call of owner.name (a class's method or a module's
    function) with CUDA events; yields the list of ms it fills."""
    import torch

    original = getattr(owner, name)
    ms = []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        return out

    setattr(owner, name, timed)
    try:
        yield ms
    finally:
        setattr(owner, name, original)


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


def tracker_repeat(seq, cfg, first_poses, card: str) -> int:
    """The tracker phase's frames again, on a fresh Tracker with the same
    inputs: every status OK and every pose equal to the first run's bit for
    bit.  Returns the matcher launches."""
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker

    tracker = Tracker(cfg, H, W)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    km.launches = 0
    poses, statuses = [], []
    for f in range(len(seq.gray)):
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
    differ = [f for f, (a, b) in enumerate(zip(poses, first_poses)) if not np.array_equal(a, b)]
    worst = max((float(np.abs(poses[f] - first_poses[f]).max()) for f in differ), default=0.0)
    log(f"tracker, second run on a fresh Tracker: statuses {statuses}; {len(differ)} of {len(poses)} poses differ "
        f"in bits from the first run's {differ} (max |entry diff| {worst:.3e}) [{card}]")
    if differ or any(statuses):
        raise AssertionError("tracker: the second run on the same inputs differs from the first")
    return km.launches


def lfnet_forward_phase(seq, lf_cfg, lfnet, card: str) -> float:
    """The LF-Net forward alone on the masked ROI crop of frame 0 at
    input_size (400x400): CUDA events, median of 25 runs after warm-up;
    launches, device time and the largest kernels from the profiler; its
    bound (profile_step.lfnet_forward_report)."""
    import torch

    from bundletrack_tpu_torch.cardrun import masked_crop
    from bundletrack_tpu_torch.profile_step import lfnet_forward_report

    S = lf_cfg.frontend.input_size
    out = lfnet(masked_crop(seq, 0, S)[..., None])
    n_valid = int(out.valid.sum())
    if not (bool(torch.isfinite(out.desc).all()) and n_valid > 0):
        raise AssertionError("lfnet forward: non-finite descriptors or no valid keypoint")
    rep = lfnet_forward_report(lfnet, lf_cfg, seq, card)
    log(f"lfnet forward at {S}x{S}, top_k {lf_cfg.frontend.top_k}, {n_valid} valid keypoints: {rep['median_ms']:.4f} ms "
        f"(CUDA events), {rep['device_ms_per_forward']:.4f} device ms, {rep['launches_per_forward']:.0f} launches [{card}]")
    return rep["median_ms"]


# ---- the norm statistics' sums kernel -----------------------------------------

SUMS_SOURCE = "bundletrack_tpu_torch/csrc/xla_order_sums.cu"
# what the sums kernel replaces: no TPU kernel; XLA's reduce order for the
# jitted norms (Flax GroupNorm(1) and instance_norm) of the JAX LF-Net
SUMS_REPLACES = ("none (no TPU kernel): XLA's reduction order of the jitted LF-Net norms, "
                 "bundletrack_tpu/frontend/lfnet.py:73 and bundletrack_tpu/frontend/detector_ops.py:18")
SUMS_REPORTED_SHAPE = (512, 64, 16, 16)  # the descriptor's first norm at 512 keypoints: the kernels line's shape
# one launch per GroupNorm (7 in the detector, 4 in the descriptor) and one
# per instance-norm list (the photo, the five score maps)
SUMS_LAUNCHES_PER_FORWARD = 13
ADD_CYCLES, SM_CLOCK_HZ = 4, 1.98e9  # an f32 add's dependent latency; the H100's boost clock
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
# launches per path of the sums kernel (the paths that run the bf16 LF-Net)
# and of the normal-blocks kernel (the paths whose GN solve runs), each
# counted from 0 just before the path and read just after (`counted`)
LAUNCHES = {"sums": {}, "blocks": {}}
_WITHOUT = {"sums": "the bf16 LF-Net ran without the sums kernel",
            "blocks": "the GN solve ran without the normal-blocks kernel"}


@contextlib.contextmanager
def counted(kernel: str, path: str):
    """Counts the launches of one kernel, "sums" or "blocks", over one path
    (from 0, read after it) into LAUNCHES[kernel]; a path that launched it
    no time fails."""
    from bundletrack_tpu_torch.kernels import norm_sums, normal_blocks

    module = {"sums": norm_sums, "blocks": normal_blocks}[kernel]
    module.launches = 0
    yield
    LAUNCHES[kernel][path] = module.launches
    if module.launches == 0:
        raise AssertionError(f"{path}: {_WITHOUT[kernel]}")


def sums_bounds(shape, per_channel: bool, shift: bool) -> dict:
    """Least times for one sums launch: the longest dependent chain (a
    window's elements, then the group's window partials, one add each at
    ADD_CYCLES), the bytes (the input once, the shift, both outputs), and
    the operations (add, multiply, add per element, + subtract with a shift)
    at the f32 peak."""
    from bundletrack_tpu_torch.kernels.norm_sums import axis_windows

    shape4 = tuple(shape) + (1, 1) if len(shape) == 2 else tuple(shape)
    B, C, H, W = shape4
    dims = (H, W, 1 if per_channel else C)
    win = [axis_windows(n) for n in dims]
    chain = int(np.prod([w for w, _, _ in win])) + int(np.prod([nw for _, nw, _ in win]))
    G = B * C if per_channel else B
    n = B * C * H * W
    return {
        "chain": chain * ADD_CYCLES / SM_CLOCK_HZ * 1e3,
        "bytes": (4 * n + (4 * G if shift else 0) + 8 * G) / HBM_BYTES_PER_S * 1e3,
        "operations": (4 if shift else 3) * n / F32_FLOP_PER_S * 1e3,
    }


def instance_bounds(shapes) -> dict:
    """Least times for one instance-statistics launch: the longest chain (per
    map a window, then its group's partials, for the sums and again for the
    shifted squares), the bytes (each map once, the means and variances) and
    the operations (add; subtract, multiply, add per element) at the f32 peak."""
    n = sum(int(np.prod(s)) for s in shapes)
    G = sum(s[0] * s[1] for s in shapes)
    return {
        "chain": max(2 * sums_bounds(s, True, False)["chain"] for s in shapes),
        "bytes": (4 * n + 8 * G) / HBM_BYTES_PER_S * 1e3,
        "operations": 4 * n / F32_FLOP_PER_S * 1e3,
    }


def sums_kernel_phase(seq, lf_cfg, lfnet, card: str) -> dict:
    """The sums kernel on every norm input of one 400x400 bf16 forward (the
    detector's and the descriptor's GroupNorms at 512 keypoints, each one
    launch, and the photo's and the score maps' instance norms, one launch
    per list) and of the fleet's batched forward (8 crops): at most
    SUMS_LAUNCHES_PER_FORWARD launches per forward; held to its plain
    version bit for bit (the GroupNorms' mean and variance and the instance
    norms' too), then timed (CUDA events) per shape beside torch.sum of the
    same tensor (torch.var_mean per map for the instance norms) and its
    bounds.  Returns the kernels line's entry for SUMS_REPORTED_SHAPE
    (launches filled in later).  These comparison launches are not counted."""
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms, masked_crop
    from bundletrack_tpu_torch.kernels import norm_sums as ns
    from bundletrack_tpu_torch.ops.numerics import xla_mean_var

    S = lf_cfg.frontend.input_size
    saved = ns.launches
    single = masked_crop(seq, 0, S)[..., None]
    fleet = torch.stack([masked_crop(seq, f, S) for f in range(FLEET_STREAMS)])[..., None]
    with recorded_calls(ns, "_launch", args=True) as calls, \
            recorded_calls(ns, "_launch_instance", args=True) as instance_calls:
        ns.launches = 0
        lfnet(single)
        n_single, n_single_sums = ns.launches, len(calls)
        ns.launches = 0
        lfnet(fleet)
        n_fleet = ns.launches
    torch.cuda.synchronize()
    log(f"sums kernel: {n_single} launches in one {S}x{S} bf16 forward ({n_single_sums} sums, "
        f"{n_single - n_single_sums} instance statistics), {n_fleet} in the batched forward of {FLEET_STREAMS} crops "
        f"(at most {SUMS_LAUNCHES_PER_FORWARD} each)")
    if max(n_single, n_fleet) > SUMS_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"sums kernel: {n_single} / {n_fleet} launches per forward, more than "
                             f"{SUMS_LAUNCHES_PER_FORWARD}")
    cases = {}
    n_stats = 0
    for (x4, per_channel, round_bf16, shift), kwargs in calls:
        key = (tuple(x4.shape), per_channel, round_bf16, shift is not None)
        want = ns.xla_order_sums_reference(x4, per_channel, round_bf16, shift)
        checks = [("sums", ns._launch(x4, per_channel, round_bf16, shift), want)]
        if kwargs.get("stats"):  # GroupNorm's mean and variance, derived in the kernel's last block
            n_stats += 1
            checks.append(("mean and variance", ns._launch(x4, per_channel, round_bf16, shift, stats=True),
                           xla_mean_var(*want, x4[0].numel())))
        torch.cuda.synchronize()
        for what, got, ref in checks:
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                raise AssertionError(f"sums kernel: {what} at {key} differ from the plain version's "
                                     f"(max |diff| {err:.3e})")
        cases.setdefault(key, (x4, per_channel, round_bf16, shift))
    instance_cases = {}
    for (maps,), _ in instance_calls:
        got = ns._launch_instance(maps)
        want = ns.xla_order_instance_stats_reference(maps)
        torch.cuda.synchronize()
        for what, g, w in zip(("means", "variances"), got, want):
            if not all(torch.equal(a, b) for a, b in zip(g, w)):
                err = max(float((a - b).abs().max()) for a, b in zip(g, w))
                raise AssertionError(f"sums kernel: instance {what} of {[list(x.shape) for x in maps]} differ from "
                                     f"the plain version's (max |diff| {err:.3e})")
        instance_cases.setdefault(tuple(tuple(x.shape) for x in maps), maps)
    log(f"sums kernel: equal bits on every call; {n_stats} of them also derived GroupNorm's mean and variance, "
        f"equal to xla_mean_var of the plain sums; {len(instance_calls)} instance-statistics launches equal to the "
        f"plain version's means and variances")
    if SUMS_REPORTED_SHAPE not in {k[0] for k in cases}:
        raise AssertionError(f"sums kernel: no norm input of shape {SUMS_REPORTED_SHAPE} in the forward")
    entry = None
    for key, (x4, per_channel, round_bf16, shift) in sorted(cases.items(), key=lambda kv: -kv[1][0].numel()):
        ms = cuda_median_ms(lambda: ns._launch(x4, per_channel, round_bf16, shift))
        dims = (2, 3) if per_channel else tuple(range(1, x4.dim()))
        sum_ms = cuda_median_ms(lambda: torch.sum(x4, dim=dims))
        b = sums_bounds(key[0], per_channel, shift is not None)
        least = max(b.values())
        log(f"sums kernel {list(key[0])} per_channel={per_channel} round_bf16={round_bf16} shift={shift is not None}: "
            f"equal bits; {ms:.4f} ms, torch.sum {sum_ms:.4f} ms; bounds chain {b['chain']:.4f} ms, bytes "
            f"{b['bytes']:.4f} ms, operations {b['operations']:.5f} ms; {100 * least / ms:.1f} % of the larger [{card}]")
        if key[0] == SUMS_REPORTED_SHAPE and entry is None:
            plain_ms = cuda_median_ms(lambda: ns.xla_order_sums_reference(x4, per_channel, round_bf16, shift), runs=5)
            term = "bytes" if b["bytes"] >= b["operations"] else "operations"
            entry = {
                "name": "xla_order_sums",
                "route": "cuda",
                "source": SUMS_SOURCE,
                "replaces": SUMS_REPLACES,
                "launches": None,
                "max_abs_err": 0.0,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b[term],
                "bound_by": term,
                "library_ms": None,  # no PyTorch call sums in XLA's order; torch.sum is logged as a yardstick
            }
            log(f"sums kernel at {list(key[0])}: plain version (host, sequential) {plain_ms:.4f} ms; the kernels "
                f"line's bound counts bytes and operations, the dependent chain ({b['chain']:.4f} ms) is logged")
    for shapes, maps in instance_cases.items():
        ms = cuda_median_ms(lambda: ns._launch_instance(maps))
        lib_ms = cuda_median_ms(lambda: [torch.var_mean(x, dim=(2, 3), unbiased=False) for x in maps])
        b = instance_bounds(shapes)
        log(f"sums kernel, instance statistics of {[list(s) for s in shapes]} in one launch: equal bits; {ms:.4f} ms, "
            f"torch.var_mean per map {lib_ms:.4f} ms; bounds chain {b['chain']:.4f} ms, bytes {b['bytes']:.4f} ms, "
            f"operations {b['operations']:.5f} ms; {100 * max(b.values()) / ms:.1f} % of the larger [{card}]")
    ns.launches = saved
    return entry


# ---- the normal-blocks kernel ----------------------------------------------------

BLOCKS_SOURCE = "bundletrack_tpu_torch/csrc/normal_blocks.cu"
# what the normal-blocks kernel replaces: no TPU kernel; the XLA scatter-add
# of the Gauss-Newton pair blocks in the JAX package
BLOCKS_REPLACES = ("none (no TPU kernel): the XLA scatter-add of the Gauss-Newton pair blocks, "
                   "bundletrack_tpu/solver/residuals.py:81 (scatter_blocks)")
BLOCKS_REPEATS = 20  # calls on one input in `scatter_repeats_differ`


def blocks_shape(args) -> tuple:
    """(batch, K, P) of one recorded call of normal_blocks._launch."""
    return tuple(args[3].shape[:-3]), args[0], args[1].shape[0]


def blocks_bounds(batch, K: int, P: int) -> dict:
    """Least times for one launch: the bytes (the five block arrays, the
    pair indices, H and g, each once) and the f32 adds (per graph 4P 6x6
    blocks and 2P 6-vectors) at the f32 peak."""
    B = int(np.prod(batch))
    floats = B * P * (3 * 36 + 2 * 6) + B * K * (K * 36 + 6)
    return {"bytes": (4 * floats + 2 * 8 * P) / HBM_BYTES_PER_S * 1e3,
            "operations": B * P * (4 * 36 + 2 * 6) / F32_FLOP_PER_S * 1e3}


def device_us(fn, calls: int = 10) -> tuple:
    """(device us, kernel launches) per call of fn, from the profiler."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / calls, len(kernels) / calls


def blocks_check(name: str, outs, calls) -> dict:
    """Holds every recorded result of the normal-blocks kernel on a path
    (`outs`, with their arguments `calls`) to the plain version on CPU
    copies of the same inputs, bit for bit; returns the first call's
    arguments per (batch, K, P)."""
    import torch

    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    torch.cuda.synchronize()
    if not outs:
        raise AssertionError(f"normal blocks [{name}]: the path made no call")
    first, counts = {}, {}
    for got, (args, _) in zip(outs, calls):
        key = blocks_shape(args)
        want = nb.scatter_blocks_reference(args[0], *(a.cpu() for a in args[1:]))
        for what, a, b in zip(("H", "g"), got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"normal blocks [{name}]: {what} of a call at (batch, K, P) {key} differs from "
                                     f"the plain version's (max |diff| {float((a.cpu() - b).abs().max()):.3e})")
        counts[key] = counts.get(key, 0) + 1
        first.setdefault(key, args)
    log(f"normal blocks [{name}]: {len(outs)} calls equal to the plain version bit for bit, " + ", ".join(
        f"{n} at batch {list(b)} K={K} P={P}" for (b, K, P), n in counts.items()))
    return first


def blocks_timed(name: str, args, card: str) -> dict:
    """The normal-blocks kernel on one recorded input, timed (CUDA events,
    median of 25 after warm-up, and device us from the profiler) beside its
    plain version on the card (the cats, zero fills and index_add_ with
    atomics) and the library call alone (index_add_ of the gathered rows
    into H and into g, the rows and the outputs made beforehand), with its
    bounds; returns the kernels
    line's entry (launches filled in later).  These launches are not
    counted."""
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    saved = nb.launches
    batch, K, P = blocks_shape(args)
    ms = cuda_median_ms(lambda: nb._launch(*args))
    plain_ms = cuda_median_ms(lambda: nb.scatter_blocks_reference(*args))
    blk, vals, row, gvals = nb.flat_rows(*args)
    B = int(np.prod(batch))
    H0 = torch.zeros((B * K * K, 36), dtype=vals.dtype, device=vals.device)
    g0 = torch.zeros((B * K, 6), dtype=gvals.dtype, device=gvals.device)
    library = lambda: (H0.index_add_(0, blk, vals), g0.index_add_(0, row, gvals))  # noqa: E731
    library_ms = cuda_median_ms(library)
    device = {what: device_us(fn) for what, fn in (("kernel", lambda: nb._launch(*args)),
                                                   ("plain", lambda: nb.scatter_blocks_reference(*args)),
                                                   ("library", library))}
    nb.launches = saved
    b = blocks_bounds(batch, K, P)
    term = max(b, key=b.get)
    log(f"normal blocks [{name}] at batch {list(batch)} K={K} P={P}: {ms:.4f} ms (CUDA events around the wrapper), "
        f"plain version on the card {plain_ms:.4f} ms, index_add_ alone {library_ms:.4f} ms; device time per call "
        f"(profiler): kernel {device['kernel'][0]:.2f} us in {device['kernel'][1]:.0f} launch, plain version "
        f"{device['plain'][0]:.2f} us in {device['plain'][1]:.0f} launches, index_add_ alone "
        f"{device['library'][0]:.2f} us in {device['library'][1]:.0f}; bounds bytes {b['bytes']:.5f} ms, "
        f"operations {b['operations']:.5f} ms; {100 * b[term] / ms:.2f} % of the larger [{card}]")
    return {
        "name": "normal_blocks",
        "route": "cuda",
        "source": BLOCKS_SOURCE,
        "replaces": BLOCKS_REPLACES,
        "launches": None,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b[term],
        "bound_by": term,
        "library_ms": library_ms,
    }


def blocks_edge_case(card: str) -> None:
    """The kernel on a small graph with repeated pairs and pairs whose i
    equals j (K=6, 40 pairs drawn with replacement, and the 120 pairs of
    16 frames with 7 repeated and 2 self pairs), on one output block with
    more terms than the kernel lists at a time (300 pairs of two frames,
    most on (0, 0), (0, 1), (1, 0)) and on more pairs than one tile of
    indices (1500 over 16 frames, drawn with replacement; both graphs
    blocks_bench's), bit for bit against the plain version; these launches
    are not counted."""
    import torch

    from bundletrack_tpu_torch.blocks_bench import pair_graph
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    saved = nb.launches
    rng = np.random.RandomState(0)
    i16, j16 = np.triu_indices(K_BA, k=1)
    extra = rng.choice(len(i16), 7, replace=False)
    graphs = {"K=6, 40 pairs with replacement": (6, rng.randint(0, 6, 40), rng.randint(0, 6, 40)),
              "K=16, 120 pairs + 7 repeated + 2 self": (K_BA, np.concatenate([i16, i16[extra], [3, 11]]),
                                                        np.concatenate([j16, j16[extra], [3, 11]]))}
    graphs["K=2, 300 pairs, ~640 terms on block (0, 0)"] = (2, *pair_graph("tiled_list", 2))
    graphs["K=16, 1500 pairs with replacement"] = (K_BA, *pair_graph("beyond_a_tile", K_BA))
    for name, (K, i, j) in graphs.items():
        P = len(i)
        sizes = [(P, 6, 6)] * 3 + [(P, 6)] * 2
        blocks = [torch.from_numpy((rng.choice([-1.0, 1.0], s) * 10.0 ** rng.uniform(-3, 3, s)).astype(np.float32))
                  for s in sizes]
        pi, pj = torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64))
        got = nb.scatter_blocks(K, pi.cuda(), pj.cuda(), *(b.cuda() for b in blocks))
        want = nb.scatter_blocks_reference(K, pi, pj, *blocks)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"normal blocks [{name}]: the kernel differs from the plain version")
        log(f"normal blocks [{name}]: equal to the plain version bit for bit [{card}]")
    nb.launches = saved


def blocks_kernel_phase(outs, calls, card: str) -> dict:
    """The normal-blocks kernel on the GN inputs of the tracker phase's
    frames (every call, sparse and dense terms, bit for bit against the
    plain version on CPU copies), on the repeated- and self-pair graphs,
    and BLOCKS_REPEATS calls on one input that must repeat their bits;
    each shape timed.  Returns the kernels line's entry, at the tracked
    frame's K=16, P=120 (batch [1])."""
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    first = blocks_check("tracker phase", outs, calls)
    blocks_edge_case(card)
    saved = nb.launches
    differ = scatter_repeats_differ()
    nb.launches = saved
    log(f"normal blocks: {differ} of {BLOCKS_REPEATS - 1} repeats on one input differ in bits from the first "
        f"(scatter_repeats_differ) [{card}]")
    if differ:
        raise AssertionError(f"normal blocks: {differ} repeats on one input gave other bits")
    key = ((1,), K_BA, P_PAIRS)  # the tracker steps a fleet of one stream
    if key not in first:
        raise AssertionError(f"normal blocks: no call at K={K_BA} P={P_PAIRS} in the tracker phase: {sorted(first)}")
    entry = blocks_timed("tracker phase", first[key], card)
    for other, args in first.items():
        if other != key:
            blocks_timed("tracker phase", args, card)
    return entry


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


def pass_specs(passes_fn, **kw) -> dict:
    """The render_hard_sequence calls of hard_world.hard_passes or
    long_hard_passes, as (args, kwargs) by pass name, so each pass renders
    in a process of its own."""
    from bundletrack_tpu_torch.data import hard_world

    render = hard_world.render_hard_sequence
    hard_world.render_hard_sequence = lambda *a, **k: (a, k)
    try:
        return passes_fn(**kw)
    finally:
        hard_world.render_hard_sequence = render


def render_new_phase_inputs():
    """The hard passes and the FAIL-path sequence, rendered in parallel in
    spawned processes (numpy on the host, ~0.6 s per 480x640 hard frame)."""
    from bundletrack_tpu_torch.cardrun import H, W, render_main_sequence
    from bundletrack_tpu_torch.data.hard_world import hard_passes, render_hard_sequence

    specs = pass_specs(hard_passes, H=H, W=W, num_frames=HARD_FRAMES)
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


# ---- the long-horizon suite ----------------------------------------------------


def render_long_passes(hard: bool) -> tuple:
    """long_hard_passes at 480x640 with LONG_FRAMES frames, seed 0 (and with
    `hard` the 16-frame hard passes too), each pass rendered in a spawned
    process of its own; returns (long passes, hard passes or None)."""
    from bundletrack_tpu_torch.cardrun import H, W
    from bundletrack_tpu_torch.data.hard_world import hard_passes, long_hard_passes, render_hard_sequence

    specs = {("long", n): s for n, s in pass_specs(long_hard_passes, H=H, W=W, num_frames=LONG_FRAMES).items()}
    if hard:
        specs.update({("hard", n): s for n, s in pass_specs(hard_passes, H=H, W=W, num_frames=HARD_FRAMES).items()})
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(specs), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(render_hard_sequence, *a, **k) for key, (a, k) in specs.items()}
        seqs = {key: f.result() for key, f in futures.items()}
    log(f"long suite: rendered {len(specs)} passes at {H}x{W} in {time.perf_counter() - t0:.1f} s "
        f"({LONG_FRAMES} frames per long pass)")
    long_passes = {n: seq for (kind, n), seq in seqs.items() if kind == "long"}
    return long_passes, ({n: seq for (kind, n), seq in seqs.items() if kind == "hard"} if hard else None)


def long_references() -> tuple:
    """The JAX package's figures: its run of this suite on the same draws
    (the committed JSON) with its orbit_vosmask runs on the other seeds'
    draws under "vosmask_seeds" ({seed: report}, seed 0 included), and
    BENCH_full_r05.json's (a TPU run of an older tree, accuracy only)."""
    from bundletrack_tpu_torch.eval import replay

    here = os.path.dirname(replay.__file__)
    with open(os.path.join(here, "jax_long_suite_cpu.json")) as f:
        jax_cpu = json.load(f)
    with open(os.path.join(here, "jax_long_vosmask_seeds_cpu.json")) as f:
        seeds = json.load(f)
    jax_cpu["vosmask_seeds"] = {0: jax_cpu["long_horizon_128f"]["lfnet"]["passes"][LONG_SEEDS_PASS],
                                **{int(k): v for k, v in seeds["passes"].items()}}
    if sorted(jax_cpu["vosmask_seeds"]) != list(LONG_SEEDS):
        raise AssertionError(f"JAX orbit_vosmask figures for seeds {sorted(jax_cpu['vosmask_seeds'])}, not {LONG_SEEDS}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_full_r05.json")) as f:
        r05 = json.load(f)["extra"]
    return jax_cpu, r05


def vosmask_seeds_phase(lf_cfg, cfg, seq, vos_masks, seed0_run, lfnet, jax_cpu: dict, card: str) -> tuple:
    """orbit_vosmask on the other LONG_SEEDS' draw sets, on the VOS masks of
    the seed-0 run and the same rendered orbit; returns (bars missed by the
    mean over every draw set, seed 0's included, matcher launches)."""
    from bundletrack_tpu_torch.eval import replay
    from bundletrack_tpu_torch.eval.hard_suite import LONG_PASS_SHAPES, pass_report
    from bundletrack_tpu_torch.kernels import matching as km

    seq_vos = seq._replace(mask=vos_masks)
    runs = {0: seed0_run}
    km.launches = 0  # count only these passes' launches
    for seed in LONG_SEEDS[1:]:
        runs[seed] = replay.replay_pass(lf_cfg, seq_vos, replay.load_jax_draws(cfg, LONG_FRAMES, seed), lfnet,
                                        device="cuda")
    launches = km.launches
    reports = {}
    for seed, run in runs.items():
        reports[seed] = {**pass_report(run.poses, run.statuses, seq, LONG_PASS_SHAPES["orbit"]),
                         "finite": bool(np.all(np.isfinite(run.poses)))}
    missed, lines = vosmask_seeds_missed(reports, jax_cpu["vosmask_seeds"], launches,
                                         (len(LONG_SEEDS) - 1) * (LONG_FRAMES - 1))
    for line in lines:
        log(f"long suite: lfnet {LONG_SEEDS_PASS} over draw sets: {line} [{card}]")
    return missed, launches


def vosmask_seeds_missed(card: dict, jax: dict, launches: int, tracked: int) -> tuple:
    """The orbit_vosmask bar over draw sets.  `card` maps each seed to the
    port's pass report with "finite" (every pose finite), `jax` each seed to
    the JAX package's report on the same draws; `launches` and `tracked`
    are the matcher launches and tracked frames over every seed.  Every
    pose finite, launches = tracked frames, the mean ADD-S AUC at least
    JAX's mean - LONG_AUC_SLACK and the mean FAIL frames at most JAX's mean
    + LONG_FAIL_SLACK.  Returns (bars missed, lines to log)."""
    if sorted(card) != sorted(jax):
        raise ValueError(f"seeds differ: card {sorted(card)}, JAX {sorted(jax)}")
    lines = [f"seed {s}: ADD-S AUC card {card[s]['adds_auc']:.2f} JAX {jax[s]['adds_auc']:.2f}, FAIL frames card "
             f"{card[s]['n_fail']} JAX {jax[s]['n_fail']}, NO_BA card {card[s]['n_no_ba']} JAX {jax[s]['n_no_ba']}"
             for s in sorted(card)]
    auc, jauc = (float(np.mean([r[s]["adds_auc"] for s in sorted(card)])) for r in (card, jax))
    fail, jfail = (float(np.mean([r[s]["n_fail"] for s in sorted(card)])) for r in (card, jax))
    lines.append(f"mean over {len(card)} draw sets: ADD-S AUC card {auc:.4f} JAX {jauc:.4f} (bar >= {jauc - LONG_AUC_SLACK:.4f}), "
                 f"FAIL frames card {fail:.3f} JAX {jfail:.3f} (bar <= {jfail + LONG_FAIL_SLACK:.3f}); "
                 f"card AUC >= JAX's - {LONG_AUC_SLACK} on {sum(card[s]['adds_auc'] >= jax[s]['adds_auc'] - LONG_AUC_SLACK for s in card)} "
                 f"of {len(card)}")
    missed = [f"{LONG_SEEDS_PASS} seed {s}: a pose is not finite" for s in sorted(card) if not card[s]["finite"]]
    if launches != tracked:
        missed.append(f"{LONG_SEEDS_PASS} seeds: matcher launches {launches} != tracked frames {tracked}")
    if auc < jauc - LONG_AUC_SLACK:
        missed.append(f"{LONG_SEEDS_PASS}: mean ADD-S AUC {auc:.4f} over {len(card)} draw sets < JAX's {jauc:.4f} - "
                      f"{LONG_AUC_SLACK}")
    if fail > jfail + LONG_FAIL_SLACK:
        missed.append(f"{LONG_SEEDS_PASS}: mean FAIL frames {fail:.3f} over {len(card)} draw sets > JAX's {jfail:.3f} + "
                      f"{LONG_FAIL_SLACK}")
    return missed, lines


def check_long_pass(frontend: str, name: str, run, rep: dict, jax_cpu: dict, r05, card: str) -> list:
    """Logs one tracked long pass beside the JAX figures; returns the bars it
    missed."""
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, steady_median

    jrep = jax_cpu["long_horizon_128f"][frontend]["passes"][name]
    rrep = r05["long_horizon_128f"][frontend]["passes"][name]
    st = run.statuses
    jst = jax_cpu["statuses"][f"{frontend}/{name}"]
    differ = [f for f in range(len(st)) if str(int(st[f])) != jst[f]]
    log(f"long suite: {frontend} {name}: card     {json.dumps(rep)}")
    log(f"long suite: {frontend} {name}: JAX CPU  {json.dumps(jrep)}")
    log(f"long suite: {frontend} {name}: JAX r05  {json.dumps(rrep)}")
    log(f"long suite: {frontend} {name}: statuses OK {int((st == 0).sum())}, FAIL {int((st == 1).sum())}, "
        f"NO_BA {int((st == 2).sum())}; {len(differ)} frames differ from the JAX run's statuses {differ[:40]}; "
        f"median frame {steady_median(list(run.frame_ms)):.2f} ms over frames {WARMUP_FRAMES}..{len(st) - 1}, "
        f"first frame {run.frame_ms[0]:.1f} ms [{card}]")
    missed = []
    if not np.all(np.isfinite(run.poses)):
        missed.append(f"{frontend} {name}: a pose is not finite")
    if frontend == "lfnet" and name == LONG_SEEDS_PASS:
        log(f"long suite: {frontend} {name}: barred on its mean over {len(LONG_SEEDS)} draw sets (below)")
    elif jrep["adds_auc"] >= LONG_BARRED_AUC:
        if rep["adds_auc"] < jrep["adds_auc"] - LONG_AUC_SLACK:
            missed.append(f"{frontend} {name}: ADD-S AUC {rep['adds_auc']} < JAX's {jrep['adds_auc']} - {LONG_AUC_SLACK}")
        if rep["n_fail"] > jrep["n_fail"] + LONG_FAIL_SLACK:
            missed.append(f"{frontend} {name}: {rep['n_fail']} FAIL frames > JAX's {jrep['n_fail']} + {LONG_FAIL_SLACK}")
    else:
        log(f"long suite: {frontend} {name}: JAX's ADD-S AUC {jrep['adds_auc']} < {LONG_BARRED_AUC}: recorded, not barred")
    return missed


def long_vos_check(seq, vos_masks, model, seg_cfg, jax_cpu: dict, card: str) -> list:
    """The online VOS masks of the orbit: IoU against mask_gt beside JAX's,
    and the first LONG_VOS_CPU_FRAMES propagated frames against the port on
    the CPU; returns the bars missed."""
    from bundletrack_tpu_torch.eval.hard_suite import generate_vos_masks
    from bundletrack_tpu_torch.eval.vos_eval import mask_iou

    ious = np.asarray([mask_iou(vos_masks[f], seq.mask_gt[f]) for f in range(1, len(vos_masks))])
    jious = np.asarray(jax_cpu["vos_mask_iou"])
    n = LONG_VOS_CPU_FRAMES + 1
    cpu = generate_vos_masks(seq._replace(gray=seq.gray[:n], mask=seq.mask[:n]), model, seg_cfg, device="cpu")
    shares = [float((cpu[f] != vos_masks[f]).mean()) for f in range(1, n)]
    log(f"long suite: VOS masks (long_range(128): range {seg_cfg.range_}, ring {seg_cfg.history_cap}; 96x96): "
        f"mean IoU {ious.mean():.4f} (JAX {jious.mean():.4f}), min {ious.min():.4f} at frame {int(ious.argmin()) + 1} "
        f"(JAX {jious.min():.4f} at frame {int(jious.argmin()) + 1}) [{card}]")
    log("long suite: VOS IoU every 8th frame, card / JAX: " + " ".join(
        f"{f}:{ious[f - 1]:.3f}/{jious[f - 1]:.3f}" for f in range(1, len(vos_masks), 8)))
    log(f"long suite: VOS card vs CPU on frames 1-{n - 1}: masks differ on "
        + " ".join(f"{100 * x:.4f}" for x in shares) + " % of pixels")
    missed = []
    if abs(ious.mean() - jious.mean()) > LONG_VOS_IOU_SLACK:
        missed.append(f"VOS mean IoU {ious.mean():.4f} not within {LONG_VOS_IOU_SLACK} of JAX's {jious.mean():.4f}")
    if max(shares) > VOS_CPU_DIFF_MAX:
        missed.append(f"VOS card and CPU masks differ on {100 * max(shares):.3f} % of pixels")
    return missed


def log_long_mean(frontend: str, got: dict, jax_cpu: dict, r05) -> None:
    log(f"long suite: {frontend}: mean ADD-S AUC {got['mean_adds_auc']} (JAX CPU "
        f"{jax_cpu['long_horizon_128f'][frontend]['mean_adds_auc']}, "
        f"r05 {r05['long_horizon_128f'][frontend]['mean_adds_auc']})")


def scatter_repeats_differ(runs: int = BLOCKS_REPEATS) -> int:
    """How many of `runs` calls of the GN solve's scatter
    (solver/residuals.scatter_blocks: the normal-blocks kernel on the card)
    on one seeded input give other bits than the first: 0 where each entry's
    terms are added in one order (index_add_'s atomics gave 19 of 19)."""
    import torch

    from bundletrack_tpu_torch.solver.residuals import scatter_blocks

    gen = torch.Generator().manual_seed(0)
    K, P = 16, 120
    pi, pj = torch.triu_indices(K, K, 1)[:, :P]
    blocks = [torch.randn(s, generator=gen).cuda() for s in [(P, 6, 6)] * 3 + [(P, 6)] * 2]
    pi, pj = pi.cuda(), pj.cuda()
    first = scatter_blocks(K, pi, pj, *blocks)
    differ = 0
    for _ in range(runs - 1):
        again = scatter_blocks(K, pi, pj, *blocks)
        differ += not all(torch.equal(a, b) for a, b in zip(first, again))
    return differ


def vosmask_repeats_phase(card: str, repeats: int) -> None:
    """Whether the card's run of orbit_vosmask repeats on unchanged inputs:
    the GN scatter repeats its bits (`scatter_repeats_differ`, 0 of 19);
    the orbit rendered once and its VOS masks generated twice, bit-equal;
    then every LONG_SEEDS draw set tracked `repeats` times on the first
    masks, each set's ADD-S AUC and FAIL frames equal in every repeat (the
    poses' differing bits logged); per repeat the eight-set means against
    the bars (`vosmask_seeds_missed`, logged).  A difference raises."""
    from bundletrack_tpu_torch import fleet_bench
    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.cardrun import H, W, shipped_lfnet
    from bundletrack_tpu_torch.config import SegmentationConfig
    from bundletrack_tpu_torch.data.hard_world import long_hard_passes, render_hard_sequence
    from bundletrack_tpu_torch.eval import replay
    from bundletrack_tpu_torch.eval.hard_suite import LONG_PASS_SHAPES, generate_vos_masks, pass_report
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    differ = scatter_repeats_differ()
    log(f"GN scatter (the normal-blocks kernel on the card): {differ} of {BLOCKS_REPEATS - 1} repeats differ in "
        f"bits from the first [{card}]")
    if differ:
        raise AssertionError(f"vosmask repeats: the GN scatter gave other bits on {differ} repeats")
    t0 = time.perf_counter()
    args, kwargs = pass_specs(long_hard_passes, H=H, W=W, num_frames=LONG_FRAMES)["orbit"]
    seq = render_hard_sequence(*args, **kwargs)
    log(f"vosmask repeats: orbit rendered in {time.perf_counter() - t0:.1f} s")
    jax_cpu, _ = long_references()
    cfg = fleet_bench.bench_config(H, W)
    lf_cfg = fleet_bench.lfnet_config(H, W)
    lfnet = shipped_lfnet(lf_cfg)
    vos_model, _ = load_vos_npz(VOS_CKPT)
    seg_cfg = SegmentationConfig().long_range(LONG_FRAMES)
    masks = generate_vos_masks(seq, vos_model, seg_cfg, device="cuda")
    again = generate_vos_masks(seq, vos_model, seg_cfg, device="cuda")
    mask_differ = [f for f in range(len(masks)) if not np.array_equal(masks[f], again[f])]
    log(f"vosmask repeats: VOS masks generated twice: {len(mask_differ)} of {len(masks)} frames differ "
        f"{mask_differ[:20]} [{card}]")
    if mask_differ:
        raise AssertionError("vosmask repeats: the VOS masks differ between two runs on the same frames")
    del again
    seq_vos = seq._replace(mask=masks)
    draws = {s: replay.load_jax_draws(cfg, LONG_FRAMES, s) for s in LONG_SEEDS}
    missed_runs, first, unequal = 0, {}, []
    for r in range(repeats):
        reports = {}
        for s in LONG_SEEDS:
            run = replay.replay_pass(lf_cfg, seq_vos, draws[s], lfnet, device="cuda")
            reports[s] = {**pass_report(run.poses, run.statuses, seq, LONG_PASS_SHAPES["orbit"]),
                          "finite": bool(np.all(np.isfinite(run.poses)))}
            if r == 0:
                first[s] = (reports[s], np.asarray(run.poses))
                continue
            bits = int(np.sum(np.any(np.asarray(run.poses) != first[s][1], axis=(-2, -1))))
            same = all(reports[s][k] == first[s][0][k] for k in ("adds_auc", "n_fail"))
            log(f"vosmask repeats: run {r}: seed {s}: {bits} of {len(run.poses)} poses differ in bits from run 0; "
                f"ADD-S AUC and FAIL frames {'equal' if same else 'DIFFER'}")
            if not same:
                unequal.append(f"run {r} seed {s}: ADD-S AUC {reports[s]['adds_auc']} FAIL {reports[s]['n_fail']} "
                               f"against run 0's {first[s][0]['adds_auc']} / {first[s][0]['n_fail']}")
        tracked = len(LONG_SEEDS) * (LONG_FRAMES - 1)
        missed, lines = vosmask_seeds_missed(reports, jax_cpu["vosmask_seeds"], tracked, tracked)
        missed_runs += bool(missed)
        for line in lines:
            log(f"vosmask repeats: run {r}: {line} [{card}]")
        log(f"vosmask repeats: run {r}: bars " + ("missed: " + "; ".join(missed) if missed else "met"))
    log(f"vosmask repeats: {missed_runs} of {repeats} runs missed a bar; {len(unequal)} draw-set runs with another "
        f"ADD-S AUC or FAIL count than run 0's [{card}]")
    if unequal:
        raise AssertionError("vosmask repeats: a draw set does not repeat: " + "; ".join(unequal))


def long_suite_phase(hard_passes_16, card: str, phase_s: dict) -> int:
    """bench.py's long-horizon suite on the card, each frame on the JAX
    tracker's seed-0 draws: LF-Net on orbit, occluder, scale2x, then the
    orbit on online VOS masks, then the classical frontend on the three
    passes; then bench.py's LF-Net hard-suite row.  Returns the matcher
    launches."""
    from bundletrack_tpu_torch import fleet_bench
    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.cardrun import H, W, shipped_lfnet
    from bundletrack_tpu_torch.config import SegmentationConfig
    from bundletrack_tpu_torch.eval import hard_suite, replay
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.matching import pairwise
    from bundletrack_tpu_torch.models.vos import VOSPropagator, load_vos_npz

    t0 = time.perf_counter()
    passes, rendered_hard = render_long_passes(hard=hard_passes_16 is None)
    hard_passes_16 = hard_passes_16 or rendered_hard
    phase_s["long suite render"] = time.perf_counter() - t0
    jax_cpu, r05 = long_references()
    cfg = fleet_bench.bench_config(H, W)  # bench.py's tracking configuration
    lf_cfg = fleet_bench.lfnet_config(H, W)
    lfnet = shipped_lfnet(lf_cfg)
    draws = replay.load_jax_draws(cfg, LONG_FRAMES)
    vos_model, _ = load_vos_npz(VOS_CKPT)
    tracked = (len(passes) + 1) * (LONG_FRAMES - 1)
    missed, launches = [], 0

    t0 = time.perf_counter()
    km.launches = 0  # count only this path's launches
    with timed_calls(VOSPropagator, "propagate") as vos_ms:
        lf = replay.replay_long_suite(lf_cfg, passes, draws, lfnet_apply=lfnet, vos_model=vos_model, device="cuda")
    phase_s["long suite lfnet (with VOS)"] = time.perf_counter() - t0
    log(f"long suite: lfnet: matcher launches {km.launches} for {tracked} tracked frames; VOS propagate "
        f"{np.median(vos_ms):.3f} ms median of {len(vos_ms)} (CUDA events) [{card}]")
    if km.launches != tracked:
        missed.append(f"lfnet: matcher launches {km.launches} != tracked frames {tracked}")
    launches += km.launches
    for name, rep in lf["passes"].items():
        missed += check_long_pass("lfnet", name, lf["runs"][name], rep, jax_cpu, r05, card)
    log_long_mean("lfnet", lf, jax_cpu, r05)
    seg_cfg = SegmentationConfig().long_range(LONG_FRAMES)
    missed += long_vos_check(passes["orbit"], lf["vos_masks"], vos_model, seg_cfg, jax_cpu, card)
    t0 = time.perf_counter()
    seeds_missed, seeds_launches = vosmask_seeds_phase(lf_cfg, cfg, passes["orbit"], lf["vos_masks"],
                                                       lf["runs"][LONG_SEEDS_PASS], lfnet, jax_cpu, card)
    phase_s[f"long suite lfnet {LONG_SEEDS_PASS}, seeds {LONG_SEEDS[1]}-{LONG_SEEDS[-1]}"] = time.perf_counter() - t0
    missed += seeds_missed
    launches += seeds_launches
    del lf

    t0 = time.perf_counter()
    km.launches = 0
    cl = replay.replay_long_suite(cfg, passes, draws, device="cuda")
    phase_s["long suite classical"] = time.perf_counter() - t0
    tracked = len(passes) * (LONG_FRAMES - 1)
    log(f"long suite: classical: matcher launches {km.launches} for {tracked} tracked frames [{card}]")
    if km.launches != tracked:
        missed.append(f"classical: matcher launches {km.launches} != tracked frames {tracked}")
    launches += km.launches
    for name, rep in cl["passes"].items():
        missed += check_long_pass("classical", name, cl["runs"][name], rep, jax_cpu, r05, card)
    log_long_mean("classical", cl, jax_cpu, r05)
    del cl, passes

    t0 = time.perf_counter()
    km.launches = 0
    with timed_calls(pairwise, "fused_mutual_match_pairs") as matcher_ms:
        aucs = hard_suite.run_hard_suite(lf_cfg, lfnet_apply=lfnet, passes=hard_passes_16, device="cuda")
    phase_s["lfnet hard suite"] = time.perf_counter() - t0
    tracked = sum(len(seq.gray) - 1 for seq in hard_passes_16.values())
    log(f"long suite: lfnet hard suite: card {json.dumps(aucs)}")
    log(f"long suite: lfnet hard suite: JAX CPU {json.dumps(jax_cpu['hard_suite_16f']['lfnet'])}")
    log(f"long suite: lfnet hard suite: JAX r05 {json.dumps(r05['hard_suite_16f']['lfnet'])}")
    log(f"long suite: lfnet hard suite: matcher launches {km.launches} for {tracked} tracked frames; the matcher's "
        f"wrapper at {P_PAIRS} pairs in these frames {np.median(matcher_ms):.4f} ms median of {len(matcher_ms)} "
        f"(CUDA events) [{card}]")
    if km.launches != tracked:
        missed.append(f"lfnet hard suite: matcher launches {km.launches} != tracked frames {tracked}")
    launches += km.launches
    missed += [f"lfnet hard suite: {n} ADD-S AUC {aucs[n]} <= {HARD_ADDS_AUC_MIN}"
               for n in HARD_BARRED if aucs[n] <= HARD_ADDS_AUC_MIN]
    if missed:
        raise AssertionError("long suite: bars missed: " + "; ".join(missed))
    return launches


# ---- bench.py's frontend quality, noisy-init NOCS and VOS clips ------------------


def eval_references() -> tuple:
    """The JAX package's run of bench.py's three evaluations on a CPU, with
    the inputs it recorded (the committed JSON), and BENCH_full_r05.json's
    figures for them (a TPU run of an older tree, accuracy only)."""
    from bundletrack_tpu_torch.eval import replay

    with open(os.path.join(os.path.dirname(replay.__file__), "jax_eval_suite_cpu.json")) as f:
        ref = json.load(f)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_full_r05.json")) as f:
        r05 = json.load(f)["extra"]
    return ref, r05


def submit_eval_renders(pool, inputs) -> dict:
    """Every sequence the eval suite's inputs render, submitted to `pool`:
    {spec_key: future}."""
    from bundletrack_tpu_torch.eval.replay import eval_suite_specs, render_spec

    return {key: pool.submit(render_spec, spec) for key, spec in eval_suite_specs(inputs).items()}


def eval_suite_phase(card: str, phase_s: dict, seqs=None) -> int:
    """bench.py's `_frontend_quality`, `_bench_nocs` and `_bench_vos` on the
    card at their own sizes and seeds, from the inputs the JAX package's run
    recorded (`replay.replay_eval_suite`; the NOCS pass on the JAX tracker's
    seed-0 draws), held to that run's figures (`replay.eval_suite_missed`)
    and printed beside them and r05's; the hard110 clip's first
    EVAL_VOS_CPU_FRAMES propagated masks against the port on the CPU.
    `seqs` maps spec keys to sequences rendered already.  Returns the
    matcher launches."""
    from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
    from bundletrack_tpu_torch.cardrun import WARMUP_FRAMES, shipped_lfnet, steady_median
    from bundletrack_tpu_torch.config import TrackerConfig, load_config
    from bundletrack_tpu_torch.eval import replay
    from bundletrack_tpu_torch.eval.vos_eval import evaluate_vos
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    ref, r05 = eval_references()
    inputs = ref["inputs"]
    if seqs is None:
        t0 = time.perf_counter()
        specs = replay.eval_suite_specs(inputs)
        with ProcessPoolExecutor(max_workers=len(specs), mp_context=multiprocessing.get_context("spawn")) as pool:
            seqs = {key: f.result() for key, f in submit_eval_renders(pool, inputs).items()}
        phase_s["eval suite render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lf_cfg = TrackerConfig().replace(frontend=load_config({"frontend": inputs["frontend_quality"]["configs"]["lfnet"]}).frontend)
    lfnet = shipped_lfnet(lf_cfg)
    vos_model, _ = load_vos_npz(VOS_CKPT)
    nocs_cfg = load_config(inputs["nocs"]["tracker"])
    frames = inputs["nocs"]["render"]["kwargs"]["num_frames"]
    km.launches = 0  # count only this phase's launches
    got = replay.replay_eval_suite(inputs, replay.load_jax_draws(nocs_cfg, frames), lfnet_apply=lfnet,
                                   vos_model=vos_model, seqs=seqs, device="cuda")
    launches = km.launches
    missed, lines = replay.eval_suite_missed(got, ref)
    for line in lines:
        log(f"eval suite: {line}")
    for world, row in got["frontend_quality"].items():
        for frontend, g in row.items():
            w, r = ref["frontend_quality"][world][frontend], r05["frontend_quality"][world][frontend]
            log(f"eval suite: frontend {world}/{frontend}: repeatability / inlier rate / n_matches card "
                f"{g['repeatability']:.4f} / {g['inlier_rate']:.4f} / {g['n_matches']:.2f}, JAX CPU "
                f"{w['repeatability']:.4f} / {w['inlier_rate']:.4f} / {w['n_matches']:.2f}, r05 "
                f"{r['repeatability']:.4f} / {r['inlier_rate']:.4f} / {r['n_matches']:.2f} [{card}]")
    run = got["nocs_run"]
    st = "".join(str(int(x)) for x in run.statuses)
    log(f"eval suite: nocs (48-frame hard cube at 480x640, noisy init, the JAX tracker's draws): card "
        f"{json.dumps(got['nocs'])}; JAX CPU {json.dumps({k: v for k, v in ref['nocs'].items() if k != 'statuses'})}; "
        f"r05 {json.dumps(r05['nocs'])}")
    log(f"eval suite: nocs statuses card {st}, {sum(a != b for a, b in zip(st, ref['nocs']['statuses']))} frames "
        f"differ from JAX's; median frame {steady_median(list(run.frame_ms)):.2f} ms over frames "
        f"{WARMUP_FRAMES}..{frames - 1}; matcher launches {launches} for {frames - 1} tracked frames [{card}]")
    if launches != frames - 1:
        missed.append(f"nocs: matcher launches {launches} != tracked frames {frames - 1}")
    for clip in ref["vos"]:
        if clip != "width":
            g, w, r = got["vos"][clip], ref["vos"][clip], r05["vos"][clip]
            log(f"eval suite: vos {clip}: mean / min / tail10 IoU card {g['mean_iou']:.4f} / {g['min_iou']:.4f} / "
                f"{g['tail10_mean']:.4f}, JAX CPU {w['mean_iou']:.4f} / {w['min_iou']:.4f} / {w['tail10_mean']:.4f}, "
                f"r05 {json.dumps(r)} [{card}]")
    clip = inputs["vos"]["clips"][EVAL_VOS_CPU_CLIP]
    n = EVAL_VOS_CPU_FRAMES + 1
    cpu = evaluate_vos(vos_model, load_config({"segmentation": clip["segmentation"]}).segmentation,
                       seqs[replay.spec_key(clip["render"])], num_frames=n, device="cpu")["masks"]
    card_masks = got["vos_runs"][EVAL_VOS_CPU_CLIP]["masks"]
    shares = [float((c != m).mean()) for c, m in zip(cpu, card_masks)]
    log(f"eval suite: vos {EVAL_VOS_CPU_CLIP} card vs CPU on frames 1-{n - 1}: masks differ on "
        + " ".join(f"{100 * x:.4f}" for x in shares) + " % of pixels")
    if max(shares) > VOS_CPU_DIFF_MAX:
        missed.append(f"vos {EVAL_VOS_CPU_CLIP}: card and CPU masks differ on {100 * max(shares):.3f} % of pixels")
    phase_s["eval suite"] = time.perf_counter() - t0
    if missed:
        raise AssertionError("eval suite: bars missed: " + "; ".join(missed))
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
    from bundletrack_tpu_torch.kernels import normal_blocks as nb
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
        km.launches = nb.launches = 0
        run = list(timed_frames(tracker, seq, range(len(seq.gray)), init_pose))
        launches, blocks_launches = km.launches, nb.launches
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
            "launches": launches, "blocks_launches": blocks_launches, "max_abs_err": max_err, "pairs": per,
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
    from bundletrack_tpu_torch.kernels import normal_blocks as nb
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
    km.launches = nb.launches = 0
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
            "frame_ms": frame_ms, "launches": km.launches, "blocks_launches": nb.launches}


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
    out["blocks_launches"] = {k: out[k]["blocks_launches"] for k in ("tracker", "fleet", "fleet_2d", "fleet_join")}
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
    for r, rank_res in enumerate(res):
        blocks = rank_res["blocks_launches"]
        log(f"{tag}: rank {r}: normal-blocks kernel launches " + ", ".join(f"{k} {v}" for k, v in blocks.items()))
        if not all(blocks.values()):
            raise AssertionError(f"{tag}: rank {r}: a GN solve ran without the normal-blocks kernel: {blocks}")
        LAUNCHES["blocks"][f"mesh (phase 19), {backend}, rank {r}"] = sum(blocks.values())
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

    repeats = int(argv[1]) if len(argv) == 2 and argv[0] == "--vosmask-repeats" and argv[1].isdigit() else 0
    if argv not in ([], ["--mesh-only"], ["--long-only"], ["--eval-only"]) and not repeats:
        print("usage: chip_smoke.py [--mesh-only | --long-only | --eval-only | --vosmask-repeats N]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
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

    if argv in (["--mesh-only"], ["--long-only"], ["--eval-only"]) or repeats:
        if argv == ["--mesh-only"]:
            mesh_only(seq, cfg, card)
        elif repeats:
            vosmask_repeats_phase(card, repeats)
        else:
            phase_s = {}
            if argv == ["--long-only"]:
                launches = {"long suite": long_suite_phase(None, card, phase_s)}
            else:
                launches = {"eval suite": eval_suite_phase(card, phase_s)}
            log("matcher launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
            log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
                + f"; whole script {time.perf_counter() - t_main:.1f}")
        log(card)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    kernel = kernel_phase(seq, cfg, device, lf_cfg, lfnet)
    sums_kernel = sums_kernel_phase(seq, lf_cfg, lfnet, card)
    phase_s = {}
    t0 = time.perf_counter()
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    with counted("blocks", "classical tracker (phase 3, both runs)"), \
            recorded_calls(nb, "_launch") as tracked_blocks, \
            recorded_calls(nb, "_launch", args=True) as tracked_block_args:
        classical_launches, _, classical_poses = tracker_phase(seq, cfg, card)
        repeat_launches = tracker_repeat(seq, cfg, classical_poses, card)
    blocks_kernel = blocks_kernel_phase(tracked_blocks, tracked_block_args, card)
    del tracked_blocks, tracked_block_args
    with counted("sums", "lfnet forward (phase 4)"):
        lfnet_forward_phase(seq, lf_cfg, lfnet, card)
    with counted("sums", "lfnet CLI (phase 5)"), counted("blocks", "lfnet CLI (phase 5)"):
        cli_launches = cli_phase(seq, card)
    phase_s["tracker, lfnet, cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vos_phase(seq, card)
    phase_s["vos"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "VOS chain (phase 7)"):
        vos_chain_launches = vos_chain_phase(seq, card)
    phase_s["vos chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "NOCS chain (phase 8)"):
        nocs_launches = nocs_phase(seq, card)
    phase_s["nocs chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_seqs = render_fleet_sequences()
    with counted("blocks", "fleet (phase 9)"), recorded_calls(nb, "_launch") as fleet_blocks, \
            recorded_calls(nb, "_launch", args=True) as fleet_block_args:
        fleet_launches, fleet_ph, fleet_outs = fleet_phase(fleet_seqs, cfg, card)
    fleet_block_inputs = blocks_check("fleet phase", fleet_blocks, fleet_block_args)
    del fleet_blocks, fleet_block_args
    blocks_timed("fleet phase", fleet_block_inputs[((FLEET_STREAMS,), K_BA, P_PAIRS)], card)
    del fleet_block_inputs
    phase_s["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "join (phase 9)"):
        join_launches, join_outs = join_phase(fleet_seqs, cfg, card, fleet_ph, fleet_outs)
    phase_s["join"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    passes, fail_seq = render_new_phase_inputs()
    phase_s["hard world render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "hard world (phase 10)"):
        hard_launches = hard_world_phase(passes, card)
    phase_s["hard world"] = time.perf_counter() - t0
    # the eval suite's sequences render in processes of their own while the
    # long suite runs
    with ProcessPoolExecutor(max_workers=EVAL_RENDER_PROCESSES, mp_context=multiprocessing.get_context("spawn")) as pool:
        eval_futures = submit_eval_renders(pool, eval_references()[0]["inputs"])
        with counted("sums", "long suite and lfnet hard suite (phase 10)"), \
                counted("blocks", "long suite and lfnet hard suite (phase 10)"):
            long_launches = long_suite_phase(passes, card, phase_s)
        del passes
        t0 = time.perf_counter()
        eval_seqs = {key: f.result() for key, f in eval_futures.items()}
        phase_s["eval suite render (left after the long suite)"] = time.perf_counter() - t0
    with counted("sums", "eval suite (phase 11)"), counted("blocks", "eval suite (phase 11)"):
        eval_launches = eval_suite_phase(card, phase_s, eval_seqs)
    del eval_seqs
    t0 = time.perf_counter()
    with counted("blocks", "fail path (phase 12)"):
        fail_launches = fail_path_phase(fail_seq, card)
    phase_s["fail path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "verify reject (phase 13)"):
        verify_launches = verify_reject_phase(seq, card)
    phase_s["verify reject"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("sums", "lfnet fleet (phase 14)"), counted("blocks", "lfnet fleet (phase 14)"):
        lfnet_fleet_launches, _ = lfnet_fleet_phase(fleet_seqs, lf_cfg, lfnet, card)
    phase_s["lfnet fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "pcg tracker (phase 15)"):
        pcg_launches = pcg_tracker_phase(seq, cfg, card, classical_poses)
    phase_s["pcg tracker"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("blocks", "photometric and fusion (phase 16)"):
        photometric_fusion_phase(seq, card)
    phase_s["photometric and fusion"] = time.perf_counter() - t0
    from bundletrack_tpu_torch.kernels import matching as km

    km.launches = nb.launches = 0
    t0 = time.perf_counter()
    lfnet_batch = train_lfnet_phase(seq, card)
    phase_s["train lfnet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vos_clip = train_vos_phase(seq, card)
    phase_s["train vos"] = time.perf_counter() - t0
    if km.launches or nb.launches:  # the training paths reach neither kernel
        raise AssertionError(f"training phases launched the matcher {km.launches} times and the normal-blocks "
                             f"kernel {nb.launches} times")
    mesh_inputs = MeshInputs(seq, classical_poses, fleet_seqs, fleet_ph, fleet_outs, join_outs, lfnet_batch, vos_clip)
    mesh_launches = mesh_phases(mesh_inputs, card, phase_s)
    launches = {
        "classical tracker phase": classical_launches, "classical tracker phase, second run": repeat_launches,
        "lfnet CLI phase (filter 0 and filtered PNGs)": cli_launches,
        "VOS chain": vos_chain_launches, "NOCS chain": nocs_launches, "fleet": fleet_launches, "join": join_launches,
        "hard world": hard_launches, "long suite (with the lfnet hard suite)": long_launches,
        "eval suite (nocs)": eval_launches,
        "fail path": fail_launches, "verify reject": verify_launches,
        "lfnet fleet": lfnet_fleet_launches, "pcg tracker": pcg_launches, "mesh (all ranks)": mesh_launches,
    }
    kernel["launches"] = sum(launches.values())
    sums_kernel["launches"] = sum(LAUNCHES["sums"].values())
    blocks_kernel["launches"] = sum(LAUNCHES["blocks"].values())
    log("matcher launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()) + "; training phases 0")
    log("sums kernel launches: " + ", ".join(f"{k} {v}" for k, v in LAUNCHES["sums"].items()))
    log("normal-blocks kernel launches: " + ", ".join(f"{k} {v}" for k, v in LAUNCHES["blocks"].items())
        + "; training phases 0")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; whole script {time.perf_counter() - t_main:.1f}")

    log(json.dumps({"kernels": [kernel, sums_kernel, blocks_kernel]}))
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
