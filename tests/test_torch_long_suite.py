"""bench.py's long-horizon suite: the JAX package's figures and the port's replay.

`jax_reference()` runs the JAX package exactly as bench.py's
`_bench_long_horizon` and the LF-Net row of `_bench_hard_suite` do, at full
scale (480x640, 128-frame long passes, 16-frame hard passes), and
`python tests/test_torch_long_suite.py --write-reference` writes its reports
to `bundletrack_tpu_torch/eval/jax_long_suite_cpu.json`, the figures the
port's card run is held against.  The JAX tracker draws its RANSAC phases
from its key alone, so the committed draws file
(`bundletrack_tpu_torch/eval/jax_draws_seed0.npz`) is what the port replays.

The LF-Net orbit on online VOS masks is ill conditioned where the masks
fail (frames 85-95), so its bar is a mean over eight draw sets:
`jax_vosmask_seeds()` tracks that pass on the JAX trackers seeded 1-7 (seed
0 is in the file above), `--write-seed-draws` writes their draws to
`jax_draws_seeds.npz` and `--write-seed-reference` their reports to
`jax_long_vosmask_seeds_cpu.json`.
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
SEED_DRAWS_NPZ = os.path.join(REPO, "bundletrack_tpu_torch", "eval", "jax_draws_seeds.npz")
SEED_REFERENCE_JSON = os.path.join(REPO, "bundletrack_tpu_torch", "eval", "jax_long_vosmask_seeds_cpu.json")
REFERENCE_COMMAND = "python tests/test_torch_long_suite.py --write-reference"
SEED_REFERENCE_COMMAND = "python tests/test_torch_long_suite.py --write-seed-reference"
EXTRA_SEEDS = tuple(range(1, 8))  # the draw sets beside seed 0 in the orbit_vosmask bar
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


def jax_vosmask_seeds(seeds=EXTRA_SEEDS):
    """The LF-Net orbit on online VOS masks, as `run_long_suite` tracks it,
    on the JAX trackers seeded with each of `seeds` (`track_sequence` seeds
    its tracker with 0; this is its loop with the seed given).  The masks do
    not depend on the draws, so VOS propagates them once."""
    from bundletrack_tpu.config import SegmentationConfig
    from bundletrack_tpu.data.hard_world import long_hard_passes
    from bundletrack_tpu.eval.hard_suite import LONG_PASS_SHAPES, generate_vos_masks, pass_report
    from bundletrack_tpu.eval.vos_eval import mask_iou
    from bundletrack_tpu.models.vos import load_vos_npz
    from bundletrack_tpu.tracker.driver import Tracker

    seconds = {}
    t_all = time.perf_counter()
    _, lf_cfg, lfnet_apply = jax_bench_configs()
    t0 = time.perf_counter()
    seq = long_hard_passes(H=H_FULL, W=W_FULL, num_frames=LONG_FRAMES)["orbit"]
    seconds["render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, params = load_vos_npz(os.path.join(REPO, "checkpoints", "vos_params.npz"))
    vos_masks = generate_vos_masks(seq, params, model, SegmentationConfig().long_range(LONG_FRAMES))
    seconds["vos"] = time.perf_counter() - t0
    ious = [round(float(mask_iou(vos_masks[f], seq.mask_gt[f])), 4) for f in range(1, LONG_FRAMES)]
    seq_vos = seq._replace(mask=vos_masks)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    passes, statuses = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        tracker = Tracker(lf_cfg, H_FULL, W_FULL, lfnet_apply, seed=seed)
        poses, st = [], []
        for f in range(LONG_FRAMES):
            out = tracker.process_frame(seq_vos.gray[f], seq_vos.depth[f], seq_vos.mask[f], seq_vos.K,
                                        init_pose=init_pose)
            poses.append(np.asarray(out.ob_in_cam))
            st.append(int(out.status))
        passes[str(seed)] = pass_report(np.stack(poses), np.asarray(st), seq, LONG_PASS_SHAPES["orbit"])
        statuses[str(seed)] = "".join(str(s) for s in st)
        seconds[f"seed_{seed}"] = time.perf_counter() - t0
        print(f"seed {seed}: {json.dumps(passes[str(seed)])}", flush=True)
    return {
        "passes": passes,
        "statuses": statuses,
        "vos_mask_iou": ious,
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


def write_seed_draws(path=SEED_DRAWS_NPZ, seeds=EXTRA_SEEDS):
    """The draws of the JAX trackers seeded with each of `seeds` on bench.py's
    configuration, LONG_FRAMES frames each, stacked as [seed, frame, ...]
    uint8."""
    from bundletrack_tpu.config import TrackerConfig

    cfg = TrackerConfig()
    neighbour, pairs = zip(*(jax_draws_arrays(cfg, LONG_FRAMES, s) for s in seeds))
    neighbour, pairs = np.stack(neighbour), np.stack(pairs)
    assert neighbour.max() < 256 and pairs.max() < 256
    np.savez_compressed(path, neighbour=neighbour.astype(np.uint8), pairs=pairs.astype(np.uint8),
                        seeds=np.asarray(seeds), max_matches=cfg.shapes.max_matches,
                        max_iter=cfg.ransac.max_iter, max_ba_frames=cfg.bundle.max_ba_frames)


def _host():
    return {"platform": jax.default_backend(), "machine": platform.machine(),
            "cpu_count": os.cpu_count(), "jax": jax.__version__}


def write_seed_reference(path=SEED_REFERENCE_JSON):
    ref = {
        "what": "the JAX package (bundletrack_tpu) tracking bench.py's long-suite orbit on online VOS "
                "masks (orbit_vosmask, LF-Net) on the CPU, its tracker seeded with each seed; seed 0 "
                "is in jax_long_suite_cpu.json",
        "jax_package_commit": _jax_package_commit(),
        "command": SEED_REFERENCE_COMMAND,
        "host": _host(),
        "config": {"H": H_FULL, "W": W_FULL, "long_frames": LONG_FRAMES, "pass": "orbit_vosmask",
                   "frontend": "lfnet", "seeds": list(EXTRA_SEEDS), "dense_src_capacity": 2048,
                   "early_stop_delta": 0.005, "vos_ckpt": "checkpoints/vos_params.npz",
                   "lfnet_ckpt": "checkpoints/lfnet_params.npz"},
        **jax_vosmask_seeds(),
    }
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    return ref


def write_reference(path=REFERENCE_JSON):
    ref = jax_reference()
    ref = {
        "what": "the JAX package (bundletrack_tpu) running bench.py's long-horizon suite and "
                "its LF-Net hard-suite row on the CPU (XLA matcher), at full scale",
        "jax_package_commit": _jax_package_commit(),
        "command": REFERENCE_COMMAND,
        "host": _host(),
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


@pytest.mark.slow
def test_jax_seed_reference_reproduces():
    """The committed orbit_vosmask figures of seeds 1-7 are what the JAX
    package gives on a rerun (~20 min on 8 CPU cores)."""
    with open(SEED_REFERENCE_JSON) as f:
        want = json.load(f)
    got = jax_vosmask_seeds()
    for key in ("passes", "statuses", "vos_mask_iou"):
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


@pytest.mark.parametrize("seed", EXTRA_SEEDS)
def test_seed_draws_file_equals_jax_draws(seed):
    """The committed draws of seed `seed` are the JAX tracker's for all 128
    frames, and the loader gives them for that seed."""
    from bundletrack_tpu.config import TrackerConfig as JTrackerConfig
    from bundletrack_tpu_torch.eval.replay import draw_seeds, load_jax_draws

    neighbour, pairs = jax_draws_arrays(JTrackerConfig(), LONG_FRAMES, seed=seed)
    with np.load(SEED_DRAWS_NPZ) as data:
        assert data["seeds"].tolist() == list(EXTRA_SEEDS)
        assert data["neighbour"].dtype == np.uint8 and data["pairs"].dtype == np.uint8
        i = EXTRA_SEEDS.index(seed)
        np.testing.assert_array_equal(data["neighbour"][i], neighbour)
        np.testing.assert_array_equal(data["pairs"][i], pairs)
    assert draw_seeds() == [0, *EXTRA_SEEDS]
    draws = load_jax_draws(_port_bench_cfg(), LONG_FRAMES, seed=seed)
    assert len(draws) == LONG_FRAMES
    for f in (0, 1, 64, LONG_FRAMES - 1):
        assert draws[f][0].dtype == np.int64 and draws[f][1].shape == (120, 3, 8)
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
    with pytest.raises(ValueError, match="128 frames"):
        load_jax_draws(cfg, LONG_FRAMES + 1, seed=3)
    with pytest.raises(ValueError, match="no draws for seed 8"):
        load_jax_draws(cfg, 4, seed=8)


def test_seed_reference_file():
    """The JAX figures of orbit_vosmask on seeds 1-7: one report per seed,
    the run's provenance, and the VOS masks the seed-0 run propagated (the
    masks do not depend on the draws)."""
    with open(SEED_REFERENCE_JSON) as f:
        ref = json.load(f)
    with open(REFERENCE_JSON) as f:
        seed0 = json.load(f)
    assert ref["command"] == SEED_REFERENCE_COMMAND and len(ref["jax_package_commit"]) == 40
    assert ref["config"]["seeds"] == list(EXTRA_SEEDS)
    assert list(ref["passes"]) == list(ref["statuses"]) == [str(s) for s in EXTRA_SEEDS]
    want_keys = set(seed0["long_horizon_128f"]["lfnet"]["passes"]["orbit_vosmask"])
    for seed, rep in ref["passes"].items():
        assert set(rep) | {"vos_mask_mean_iou", "vos_mask_min_iou"} == want_keys, seed
        assert rep["frames"] == LONG_FRAMES and len(ref["statuses"][seed]) == LONG_FRAMES
        assert rep["n_fail"] == ref["statuses"][seed].count("1")
    assert ref["vos_mask_iou"] == seed0["vos_mask_iou"]


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _report(auc, n_fail=0, finite=True):
    return {"adds_auc": auc, "n_fail": n_fail, "n_no_ba": 0, "finite": finite}


VOSMASK_BAR_CASES = {
    # every seed 2.9 below JAX: the mean is within LONG_AUC_SLACK
    "met": ({s: _report(88.0) for s in range(8)}, 7 * 127, []),
    # one seed far below, the rest equal: a lottery loss the mean absorbs
    "one_seed_lost": ({**{s: _report(90.9) for s in range(8)}, 3: _report(70.0)}, 7 * 127, []),
    # every seed 3.1 below: a systematic gap
    "systematic_gap": ({s: _report(87.8) for s in range(8)}, 7 * 127, ["mean ADD-S AUC"]),
    "fail_frames": ({**{s: _report(90.9, n_fail=2) for s in range(8)}, 5: _report(90.9, n_fail=12)}, 7 * 127,
                    ["mean FAIL frames"]),
    "not_finite": ({**{s: _report(90.9) for s in range(8)}, 6: _report(90.9, finite=False)}, 7 * 127,
                   ["seed 6: a pose is not finite"]),
    "launches": ({s: _report(90.9) for s in range(8)}, 7 * 127 - 1, ["matcher launches"]),
}


@pytest.mark.parametrize("case", list(VOSMASK_BAR_CASES))
def test_vosmask_seeds_bar(case):
    """chip_smoke.py's orbit_vosmask bar on made-up reports against JAX's
    90.9 AUC and 1 FAIL frame on every seed: the mean over the draw sets
    decides, not one draw."""
    cs = _chip_smoke()
    card, launches, want = VOSMASK_BAR_CASES[case]
    jax_reps = {s: {"adds_auc": 90.9, "n_fail": 1, "n_no_ba": 0} for s in range(8)}
    missed, lines = cs.vosmask_seeds_missed(card, jax_reps, launches, 7 * 127)
    assert len(missed) == len(want) and all(w in m for w, m in zip(want, missed)), missed
    assert len(lines) == 9 and "mean over 8 draw sets" in lines[-1]
    assert (cs.LONG_AUC_SLACK, cs.LONG_FAIL_SLACK, cs.LONG_SEEDS) == (3.0, 2, tuple(range(8)))
    with pytest.raises(ValueError, match="seeds differ"):
        cs.vosmask_seeds_missed({0: card[0]}, jax_reps, launches, 7 * 127)


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
    ap.add_argument("--write-seed-draws", action="store_true",
                    help=f"write the draws of seeds {EXTRA_SEEDS} to {os.path.relpath(SEED_DRAWS_NPZ, REPO)}")
    ap.add_argument("--write-seed-reference", action="store_true",
                    help="run the JAX package's orbit_vosmask pass on those seeds and write "
                         f"{os.path.relpath(SEED_REFERENCE_JSON, REPO)}")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    if args.write_draws:
        write_draws()
    if args.write_reference:
        print(json.dumps(write_reference()["long_horizon_128f"]))
    if args.write_seed_draws:
        write_seed_draws()
    if args.write_seed_reference:
        print(json.dumps(write_seed_reference()["passes"]))
