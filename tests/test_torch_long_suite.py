"""bench.py's long-horizon suite: the JAX package's figures and the port's replay.

`jax_reference()` runs the JAX package exactly as bench.py's
`_bench_long_horizon` and the LF-Net row of `_bench_hard_suite` do, at full
scale (480x640, 128-frame long passes, 16-frame hard passes), and
`python tests/test_torch_long_suite.py --write-reference` writes its reports
to `bundletrack_tpu_torch/eval/jax_long_suite_cpu.json`, the figures the
port's card run is held against.  The JAX tracker draws its RANSAC phases
from its key alone, so the committed draws file
(`bundletrack_tpu_torch/eval/jax_draws_seed0.npz`) is what the port replays.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from jax_draws import jax_draws_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_JSON = os.path.join(REPO, "bundletrack_tpu_torch", "eval", "jax_long_suite_cpu.json")
DRAWS_NPZ = os.path.join(REPO, "bundletrack_tpu_torch", "eval", "jax_draws_seed0.npz")
REFERENCE_COMMAND = "python tests/test_torch_long_suite.py --write-reference"
H_FULL, W_FULL, LONG_FRAMES, HARD_FRAMES = 480, 640, 128, 16

torch.set_num_threads(2)


def jax_bench_configs():
    """bench.py main()'s tracking config and its LF-Net variant, with the
    LF-Net apply on the shipped weights."""
    from bundletrack_tpu.config import BundleConfig, FrontendConfig, ShapeConfig, TrackerConfig
    from bundletrack_tpu.frontend import load_params_npz, make_lfnet_apply

    cfg = TrackerConfig(
        shapes=ShapeConfig(image_h=H_FULL, image_w=W_FULL),
        bundle=BundleConfig(dense_src_capacity=2048, early_stop_delta=0.005),
    )
    lf_fcfg = FrontendConfig(kind="lfnet")
    _, lf_params = load_params_npz(os.path.join(REPO, "checkpoints", "lfnet_params.npz"), lf_fcfg)
    return cfg, cfg.replace(frontend=lf_fcfg), make_lfnet_apply(lf_fcfg, lf_params)


def jax_reference():
    """bench.py's long-horizon suite (LF-Net with VOS in the loop, then
    classical) and its LF-Net hard-suite row, on the JAX package.  Besides
    the reports, keeps each long pass's per-frame statuses and the VOS masks'
    per-frame IoU, recorded around the JAX functions without changing them."""
    import bundletrack_tpu.eval.hard_suite as jhs
    import bundletrack_tpu.tracker.driver as jdriver
    from bundletrack_tpu.data.hard_world import hard_passes, long_hard_passes
    from bundletrack_tpu.eval.vos_eval import mask_iou

    statuses, vos_ious = [], []
    track_sequence, generate_vos_masks = jdriver.track_sequence, jhs.generate_vos_masks

    def recording_track_sequence(*args, **kwargs):
        out = track_sequence(*args, **kwargs)
        statuses.append("".join(str(int(s)) for s in out[1]))
        return out

    def recording_generate_vos_masks(seq, *args, **kwargs):
        masks = generate_vos_masks(seq, *args, **kwargs)
        vos_ious.extend(round(float(mask_iou(masks[f], seq.mask_gt[f])), 4) for f in range(1, len(masks)))
        return masks

    seconds = {}
    t_all = time.perf_counter()
    cfg, lf_cfg, lfnet_apply = jax_bench_configs()
    vos_ckpt = os.path.join(REPO, "checkpoints", "vos_params.npz")
    t0 = time.perf_counter()
    passes = long_hard_passes(H=H_FULL, W=W_FULL, num_frames=LONG_FRAMES)
    seconds["render_long"] = time.perf_counter() - t0
    jdriver.track_sequence, jhs.generate_vos_masks = recording_track_sequence, recording_generate_vos_masks
    try:
        t0 = time.perf_counter()
        lfnet = jhs.run_long_suite(lf_cfg, lfnet_apply=lfnet_apply, passes=passes, vos_ckpt=vos_ckpt)
        seconds["long_lfnet"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        classical = jhs.run_long_suite(cfg, passes=passes)
        seconds["long_classical"] = time.perf_counter() - t0
    finally:
        jdriver.track_sequence, jhs.generate_vos_masks = track_sequence, generate_vos_masks
    # run_long_suite tracks its passes in order, then the VOS orbit
    names = [f"lfnet/{n}" for n in list(passes) + ["orbit_vosmask"]] + [f"classical/{n}" for n in passes]
    del passes
    t0 = time.perf_counter()
    hard = hard_passes(H=H_FULL, W=W_FULL, num_frames=HARD_FRAMES)
    seconds["render_hard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hard_lfnet = jhs.run_hard_suite(lf_cfg, lfnet_apply=lfnet_apply, passes=hard)
    seconds["hard_lfnet"] = time.perf_counter() - t0
    return {
        "long_horizon_128f": {"lfnet": lfnet, "classical": classical},
        "hard_suite_16f": {"lfnet": hard_lfnet},
        "statuses": dict(zip(names, statuses)),
        "vos_mask_iou": vos_ious,
        "seconds": {k: round(v, 1) for k, v in seconds.items()},
        "wall_s": round(time.perf_counter() - t_all, 1),
    }


def _jax_package_commit():
    out = subprocess.run(["git", "log", "-1", "--format=%H", "--", "bundletrack_tpu"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def write_draws(path=DRAWS_NPZ, seed=0):
    """The draws file: a JAX Tracker seeded with `seed` on bench.py's
    configuration, LONG_FRAMES frames, as uint8 (every phase is below M)."""
    from bundletrack_tpu.config import TrackerConfig

    cfg = TrackerConfig()  # bench.py's (M, max_iter, K) are the defaults
    neighbour, pairs = jax_draws_arrays(cfg, LONG_FRAMES, seed)
    assert neighbour.max() < 256 and pairs.max() < 256
    np.savez_compressed(path, neighbour=neighbour.astype(np.uint8), pairs=pairs.astype(np.uint8), seed=seed,
                        max_matches=cfg.shapes.max_matches, max_iter=cfg.ransac.max_iter,
                        max_ba_frames=cfg.bundle.max_ba_frames)


def write_reference(path=REFERENCE_JSON):
    ref = jax_reference()
    ref = {
        "what": "the JAX package (bundletrack_tpu) running bench.py's long-horizon suite and "
                "its LF-Net hard-suite row on the CPU (XLA matcher), at full scale",
        "jax_package_commit": _jax_package_commit(),
        "command": REFERENCE_COMMAND,
        "host": {"platform": jax.default_backend(), "machine": platform.machine(),
                 "cpu_count": os.cpu_count(), "jax": jax.__version__},
        "config": {"H": H_FULL, "W": W_FULL, "long_frames": LONG_FRAMES, "hard_frames": HARD_FRAMES,
                   "seed": 0, "dense_src_capacity": 2048, "early_stop_delta": 0.005,
                   "vos_ckpt": "checkpoints/vos_params.npz", "lfnet_ckpt": "checkpoints/lfnet_params.npz"},
        **ref,
    }
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    return ref


@pytest.mark.slow
def test_jax_reference_reproduces():
    """The committed JAX figures are what the JAX package gives: a rerun of
    jax_reference() on the CPU equals the file to its rounding (the JAX
    tracker's draws are fixed by its key, and XLA on the CPU is
    deterministic)."""
    with open(REFERENCE_JSON) as f:
        want = json.load(f)
    got = jax_reference()
    for key in ("long_horizon_128f", "hard_suite_16f", "statuses", "vos_mask_iou"):
        assert got[key] == want[key], key


# ---- the draws file ----------------------------------------------------------


def _port_bench_cfg():
    from bundletrack_tpu_torch import fleet_bench

    return fleet_bench.bench_config(H_FULL, W_FULL)


def test_draws_file_equals_jax_draws():
    """The committed draws are the JAX tracker's at seed 0 for all 128
    frames, and the loader gives each frame's phases as the tracker takes
    them."""
    from bundletrack_tpu.config import TrackerConfig as JTrackerConfig
    from bundletrack_tpu_torch.eval.replay import load_jax_draws

    neighbour, pairs = jax_draws_arrays(JTrackerConfig(), LONG_FRAMES, seed=0)
    with np.load(DRAWS_NPZ) as data:
        assert int(data["seed"]) == 0
        assert data["neighbour"].dtype == np.uint8 and data["pairs"].dtype == np.uint8
        np.testing.assert_array_equal(data["neighbour"], neighbour)
        np.testing.assert_array_equal(data["pairs"], pairs)
    draws = load_jax_draws(_port_bench_cfg(), LONG_FRAMES)
    assert len(draws) == LONG_FRAMES
    for f in (0, 1, 64, LONG_FRAMES - 1):
        assert draws[f][0].dtype == np.int64 and draws[f][0].shape == (3, 8)
        assert draws[f][1].shape == (120, 3, 8)
        np.testing.assert_array_equal(draws[f][0], neighbour[f])
        np.testing.assert_array_equal(draws[f][1], pairs[f])


def test_load_jax_draws_refuses_other_draws():
    import dataclasses

    from bundletrack_tpu_torch.eval.replay import load_jax_draws

    cfg = _port_bench_cfg()
    with pytest.raises(ValueError, match="max_iter"):
        load_jax_draws(cfg.replace(ransac=dataclasses.replace(cfg.ransac, max_iter=512)), 4)
    with pytest.raises(ValueError, match="128 frames"):
        load_jax_draws(cfg, LONG_FRAMES + 1)


# ---- the replay against the JAX package, small -------------------------------

TINY_H, TINY_W, TINY_FRAMES = 96, 128, 12
# tests/test_torch_fleet.py's trajectory tolerances (the same draws, f32 sums
# in another order) and its count tolerance (a residual at a threshold may
# flip)
SEQ_TRANS_TOL, SEQ_ROT_TOL, COUNT_TOL = 1e-4, 0.01, 2  # m, deg, edges
AUC_TOL = 0.5  # ADD-S AUC points of a pass report
# A frame whose BA edge count differs from JAX's had one correspondence
# flip at a gate: on the occluder pass at frame 7 the frame's normals differ
# from JAX's by 1.6e-5 (f32 noise), every later stage given the port's
# inputs equals JAX's, and the 15th BA edge (JAX has 14) moves that frame's
# pose by 0.73 deg; the next frame is back within 2.3e-4 deg.  Such frames
# are held to the tracker's own pose bar (tests/test_tracker_synthetic.py)
# instead, and there may be at most one per pass.
FLIP_ROT_DEG, FLIP_TRANS_M, FLIPS_PER_PASS = 1.0, 0.005, 1


def test_replay_long_suite_matches_jax():
    """The three long passes at 96x128, 12 frames, classical frontend (the
    JAX long-suite test's small configuration): JAX's run_long_suite on its
    own seed-0 draws against the port's replay of the same draws on the CPU.
    Statuses equal frame for frame, BA edge counts within COUNT_TOL, poses
    within the fleet test's trajectory tolerances (FLIP_* on a frame whose
    edge count differs), each report's ADD-S AUC within AUC_TOL."""
    import bundletrack_tpu.tracker.driver as jdriver
    from bundletrack_tpu.config import BundleConfig as JBundleConfig
    from bundletrack_tpu.config import ShapeConfig as JShapeConfig
    from bundletrack_tpu.config import TrackerConfig as JTrackerConfig
    from bundletrack_tpu.data.hard_world import long_hard_passes as jlong_hard_passes
    from bundletrack_tpu.eval.hard_suite import run_long_suite as jrun_long_suite
    from bundletrack_tpu_torch.config import BundleConfig, ShapeConfig, TrackerConfig
    from bundletrack_tpu_torch.data.hard_world import long_hard_passes
    from bundletrack_tpu_torch.eval.metrics import pose_errors
    from bundletrack_tpu_torch.eval.replay import load_jax_draws, replay_long_suite

    jcfg = JTrackerConfig(shapes=JShapeConfig(image_h=TINY_H, image_w=TINY_W),
                          bundle=JBundleConfig(dense_src_capacity=256))
    jruns = []
    track_sequence = jdriver.track_sequence

    def recording(*args, **kwargs):
        out = track_sequence(*args, **kwargs)
        jruns.append(out)
        return out

    jdriver.track_sequence = recording
    try:
        want = jrun_long_suite(jcfg, passes=jlong_hard_passes(TINY_H, TINY_W, TINY_FRAMES))
    finally:
        jdriver.track_sequence = track_sequence
    cfg = TrackerConfig(shapes=ShapeConfig(image_h=TINY_H, image_w=TINY_W), bundle=BundleConfig(dense_src_capacity=256))
    passes = long_hard_passes(TINY_H, TINY_W, TINY_FRAMES)
    got = replay_long_suite(cfg, passes, load_jax_draws(cfg, TINY_FRAMES), device="cpu")
    assert list(got["passes"]) == list(want["passes"]) == ["orbit", "occluder", "scale2x"]
    for name, (jposes, jstatuses, jtrk) in zip(passes, jruns):
        run = got["runs"][name]
        assert run.statuses.tolist() == np.asarray(jstatuses).tolist(), name
        assert run.frame_ms.shape == (TINY_FRAMES,)
        jedges = [int(o.num_ba_edges) for o in jtrk.outputs]
        flips = 0
        for f in range(TINY_FRAMES):
            assert np.all(np.isfinite(run.poses[f]))
            assert abs(run.num_ba_edges[f] - jedges[f]) <= COUNT_TOL, (name, f, run.num_ba_edges[f], jedges[f])
            rot, trans = pose_errors(run.poses[f], np.asarray(jposes[f]))
            if run.num_ba_edges[f] == jedges[f]:
                assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (name, f, rot, trans)
            else:
                flips += 1
                assert rot < FLIP_ROT_DEG and trans < FLIP_TRANS_M, (name, f, rot, trans)
        assert flips <= FLIPS_PER_PASS, (name, run.num_ba_edges.tolist(), jedges)
        rep, jrep = got["passes"][name], want["passes"][name]
        assert abs(rep["adds_auc"] - jrep["adds_auc"]) <= AUC_TOL, (name, rep, jrep)
        assert (rep["frames"], rep["n_fail"], rep["n_no_ba"]) == (jrep["frames"], jrep["n_fail"], jrep["n_no_ba"])
    assert abs(got["mean_adds_auc"] - want["mean_adds_auc"]) <= AUC_TOL


# ---- VOS over a full long-range ring -----------------------------------------

VOS_FRAMES, VOS_WORK_HW = 110, (48, 64)
VOS_NPZ = os.path.join(REPO, "checkpoints", "vos_params.npz")


def test_vos_masks_over_a_full_long_range_ring_equal_jax():
    """generate_vos_masks with SegmentationConfig().long_range(110) (range
    100, a ring of 128) over 110 frames of the long orbit at 96x128, at a
    48x64 work size, with the shipped weights in both packages: the ring
    fills and the long-range references come into play, and the masks equal
    JAX's on every pixel.  (A small randomly initialised VOSNet loses the
    object within 40 frames, after which both packages propagate empty
    masks; the shipped weights still hold it at frame 100.)"""
    from bundletrack_tpu.config import SegmentationConfig as JSegmentationConfig
    from bundletrack_tpu.data.hard_world import render_hard_sequence
    from bundletrack_tpu.eval.hard_suite import generate_vos_masks as jgenerate_vos_masks
    from bundletrack_tpu.models.vos import load_vos_npz as jload_vos_npz
    from bundletrack_tpu_torch.config import SegmentationConfig
    from bundletrack_tpu_torch.eval.hard_suite import generate_vos_masks
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    seg_cfg = SegmentationConfig().long_range(VOS_FRAMES)
    assert (seg_cfg.range_, seg_cfg.history_cap) == (100, 128)
    seq = render_hard_sequence("lshape", VOS_FRAMES, TINY_H, TINY_W, seed=11, orbit_deg_per_frame=3.0)
    jmodel, params = jload_vos_npz(VOS_NPZ)
    want = jgenerate_vos_masks(seq, params, jmodel, JSegmentationConfig().long_range(VOS_FRAMES), work_hw=VOS_WORK_HW)
    model, _ = load_vos_npz(VOS_NPZ)
    got = generate_vos_masks(seq, model, seg_cfg, work_hw=VOS_WORK_HW, device="cpu")
    assert got.shape == (VOS_FRAMES, TINY_H, TINY_W) and got.dtype == bool
    assert got[100:].any(axis=(1, 2)).sum() >= 5  # the masks did not collapse
    np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-draws", action="store_true",
                    help=f"write the JAX tracker's draws to {os.path.relpath(DRAWS_NPZ, REPO)}")
    ap.add_argument("--write-reference", action="store_true",
                    help=f"run the JAX package's suite and write {os.path.relpath(REFERENCE_JSON, REPO)}")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    if args.write_draws:
        write_draws()
    if args.write_reference:
        print(json.dumps(write_reference()["long_horizon_128f"]))
