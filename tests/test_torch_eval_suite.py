"""bench.py's frontend quality, noisy-init NOCS and VOS clips: the JAX package's figures and the port's.

`jax_reference()` runs bench.py's own `_frontend_quality`, `_bench_nocs` and
`_bench_vos` on the JAX package at full scale, recording around the JAX
functions, without changing them, the sequences they render (renderer and
arguments), the configurations they run and their unrounded results.
`python tests/test_torch_eval_suite.py --write-reference` writes that to
`bundletrack_tpu_torch/eval/jax_eval_suite_cpu.json`, whose "inputs" the
port's card run (`chip_smoke.py`) renders and evaluates through
`eval/replay.replay_eval_suite`, and whose results it is held to
(`eval/replay.eval_suite_missed`).  The NOCS pass tracks on the JAX
tracker's own RANSAC draws: `track_sequence` seeds its `Tracker` with 0,
and `nocs_config` keeps bench.py's (M, max_iter, K) = (256, 2000, 16), so
its 48 frames draw the first 48 of `eval/jax_draws_seed0.npz`.

The tier-1 tests run the same three evaluations in both packages at a small
size from inputs of the same form, and hold the port to the same bars.
"""

import argparse
import dataclasses
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
REFERENCE_JSON = os.path.join(REPO, "bundletrack_tpu_torch", "eval", "jax_eval_suite_cpu.json")
REFERENCE_COMMAND = "python tests/test_torch_eval_suite.py --write-reference"
LFNET_NPZ = os.path.join(REPO, "checkpoints", "lfnet_params.npz")
VOS_NPZ = os.path.join(REPO, "checkpoints", "vos_params.npz")
VOS_CLIPS = ("easy32", "hard110", "hard110_longrange", "occluder48")  # bench.py's _bench_vos, in order

torch.set_num_threads(2)


def _spec(fn, args, kwargs) -> dict:
    return {"renderer": fn.__name__, "args": list(args), "kwargs": dict(kwargs)}


def jax_reference() -> dict:
    """bench.py's three evaluations on the JAX package, as bench.py's main()
    calls them (the LF-Net apply at FrontendConfig(kind="lfnet") on the
    shipped weights), with their inputs and unrounded results recorded."""
    sys.path.insert(0, REPO)
    import bench
    import bundletrack_tpu.data as jdata
    import bundletrack_tpu.data.hard_world as jhw
    import bundletrack_tpu.eval as jeval
    import bundletrack_tpu.eval.nocs_protocol as jnocs
    import bundletrack_tpu.tracker.driver as jdriver
    from bundletrack_tpu.config import FrontendConfig
    from bundletrack_tpu.frontend import load_params_npz, make_lfnet_apply

    renders, tracked, frontend_cfgs, nocs_metrics, vos_calls = [], [], {}, [], []
    originals = {"syn": jdata.render_synthetic_sequence, "hard": jdata.render_hard_sequence,
                 "hard_hw": jhw.render_hard_sequence, "track": jdriver.track_sequence,
                 "frontend": jeval.evaluate_frontend, "vos": jeval.evaluate_vos, "nocs": jnocs.evaluate_nocs}

    def recording_render(fn):
        def render(*args, **kwargs):
            seq = fn(*args, **kwargs)
            renders.append((id(seq), _spec(fn, args, kwargs)))
            return seq
        return render

    def spec_of(seq):
        return next(spec for i, spec in reversed(renders) if i == id(seq))

    def recording_track(cfg, seq, *args, **kwargs):
        out = originals["track"](cfg, seq, *args, **kwargs)
        tracked.append((dataclasses.asdict(cfg), spec_of(seq), "".join(str(int(s)) for s in out[1])))
        return out

    def recording_frontend(seq, cfg, *args, **kwargs):
        frontend_cfgs[cfg.kind] = dataclasses.asdict(cfg)
        return originals["frontend"](seq, cfg, *args, **kwargs)

    def recording_vos(params, model, seg_cfg, seq, *args, **kwargs):
        r = originals["vos"](params, model, seg_cfg, seq, *args, **kwargs)
        vos_calls.append((spec_of(seq), dataclasses.asdict(seg_cfg), r))
        return r

    def recording_nocs(*args, **kwargs):
        r = originals["nocs"](*args, **kwargs)
        nocs_metrics.append(r)
        return r

    _, lf_params = load_params_npz(LFNET_NPZ, FrontendConfig(kind="lfnet"))
    lfnet_apply = make_lfnet_apply(FrontendConfig(kind="lfnet"), lf_params)
    jdata.render_synthetic_sequence = recording_render(originals["syn"])
    jdata.render_hard_sequence = jhw.render_hard_sequence = recording_render(originals["hard_hw"])
    jdriver.track_sequence, jeval.evaluate_frontend = recording_track, recording_frontend
    jeval.evaluate_vos, jnocs.evaluate_nocs = recording_vos, recording_nocs
    seconds = {}
    try:
        t0 = time.perf_counter()
        fq = bench._frontend_quality(lfnet_apply)
        seconds["frontend_quality"] = time.perf_counter() - t0
        fq_specs = [spec for _, spec in renders]
        t0 = time.perf_counter()
        nocs = bench._bench_nocs()
        seconds["nocs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vos = bench._bench_vos()
        seconds["vos"] = time.perf_counter() - t0
    finally:
        jdata.render_synthetic_sequence, jdata.render_hard_sequence = originals["syn"], originals["hard"]
        jhw.render_hard_sequence, jdriver.track_sequence = originals["hard_hw"], originals["track"]
        jeval.evaluate_frontend, jeval.evaluate_vos = originals["frontend"], originals["vos"]
        jnocs.evaluate_nocs = originals["nocs"]
    assert len(fq_specs) == 2 and len(tracked) == 1 and len(nocs_metrics) == 1 and len(vos_calls) == len(VOS_CLIPS)
    nocs_cfg, nocs_spec, statuses = tracked[0]
    inputs = {
        "frontend_quality": {"worlds": dict(zip(fq, ({"render": s} for s in fq_specs))),
                             "configs": frontend_cfgs, "gap": 1, "eps_px": 3.0},
        # bench.py's _bench_nocs: model_points("cube", size=0.2), class "laptop", RandomState(0)
        "nocs": {"render": nocs_spec, "tracker": nocs_cfg, "shape": "cube", "size": 0.2, "category": "laptop",
                 "noise_seed": 0},
        "vos": {"clips": {name: {"render": spec, "segmentation": seg}
                          for name, (spec, seg, _) in zip(VOS_CLIPS, vos_calls)}},
    }
    vos_out = {"width": vos["width"]}
    for name, (_, _, r) in zip(VOS_CLIPS, vos_calls):
        vos_out[name] = {"mean_iou": r["mean_iou"], "min_iou": r["min_iou"],
                         "tail10_mean": float(np.mean(r["per_frame"][-10:])),
                         "per_frame": [round(float(x), 6) for x in r["per_frame"]]}
    return {
        "inputs": inputs,
        "frontend_quality": fq,
        "nocs": {**nocs_metrics[0], "n_fail": statuses.count("1"), "statuses": statuses},
        "vos": vos_out,
        "bench_py": {"nocs": nocs, "vos": vos},  # bench.py's own rounded rows
        "seconds": {k: round(v, 1) for k, v in seconds.items()},
    }


def _jax_package_commit():
    out = subprocess.run(["git", "log", "-1", "--format=%H", "--", "bundletrack_tpu"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def write_reference(path=REFERENCE_JSON) -> dict:
    t0 = time.perf_counter()
    ref = jax_reference()
    ref = {
        "what": "the JAX package (bundletrack_tpu) running bench.py's _frontend_quality, _bench_nocs and "
                "_bench_vos on the CPU, at full scale, with their inputs recorded",
        "jax_package_commit": _jax_package_commit(),
        "command": REFERENCE_COMMAND,
        "host": {"platform": jax.default_backend(), "machine": platform.machine(),
                 "cpu_count": os.cpu_count(), "jax": jax.__version__},
        **ref,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    return ref


# ---- the JAX package on inputs of the reference's form -----------------------


def jax_suite(inputs: dict, lfnet_apply) -> dict:
    """The three evaluations on the JAX package from `inputs`, as bench.py's
    functions compute them (a small configuration for the tier-1 test)."""
    from bundletrack_tpu.config import TrackerConfig
    from bundletrack_tpu.config import load_config as jload_config
    from bundletrack_tpu.data import render_hard_sequence, render_synthetic_sequence
    from bundletrack_tpu.data.hard_world import model_points
    from bundletrack_tpu.eval import evaluate_frontend, evaluate_vos
    from bundletrack_tpu.eval.nocs_protocol import evaluate_nocs, perturb_init_pose, reanchor_trajectory
    from bundletrack_tpu.models.vos import load_vos_npz
    from bundletrack_tpu.tracker.driver import track_sequence
    from bundletrack_tpu_torch.eval.replay import box_corners

    renderers = {"render_synthetic_sequence": render_synthetic_sequence, "render_hard_sequence": render_hard_sequence}

    def render(spec):
        return renderers[spec["renderer"]](*spec["args"], **spec["kwargs"])

    fq_in = inputs["frontend_quality"]
    fq = {}
    for wname, world in fq_in["worlds"].items():
        seq = render(world["render"])
        fq[wname] = {k: evaluate_frontend(seq, jload_config({"frontend": c}).frontend,
                                          lfnet_apply=lfnet_apply if k == "lfnet" else None,
                                          gap=fq_in["gap"], eps_px=fq_in["eps_px"])
                     for k, c in fq_in["configs"].items()}
    nin = inputs["nocs"]
    seq = render(nin["render"])
    poses, statuses, _ = track_sequence(jload_config(nin["tracker"], TrackerConfig()), seq)
    noisy_init = perturb_init_pose(seq.ob_in_cam[0], rng=np.random.RandomState(nin["noise_seed"]))
    nocs = evaluate_nocs(reanchor_trajectory(list(poses), noisy_init), list(seq.ob_in_cam),
                         box_corners(model_points(nin["shape"], size=nin["size"])), nin["category"])
    nocs["n_fail"] = int(np.sum(np.asarray(statuses) == 1))
    model, params = load_vos_npz(VOS_NPZ)
    vos = {"width": int(model.width)}
    for name, clip in inputs["vos"]["clips"].items():
        r = evaluate_vos(params, model, jload_config({"segmentation": clip["segmentation"]}).segmentation,
                         render(clip["render"]))
        vos[name] = {"mean_iou": r["mean_iou"], "min_iou": r["min_iou"],
                     "tail10_mean": float(np.mean(r["per_frame"][-10:])), "per_frame": r["per_frame"]}
    return {"frontend_quality": fq, "nocs": nocs, "vos": vos}


# ---- tier 1: both packages at a small size -----------------------------------

# The frontend worlds keep bench.py's 240x320 (at 96x128 an LF-Net crop
# holds a few tens of keypoints, and one keypoint moves the repeatability by
# several points), with 3 frames and LF-Net at input 192 (top_k 256, the seed
# study's); the NOCS pass and the VOS clips are cut to 96x128 x 8 frames and
# 96x96 x 8 frames.
SMALL_FQ_H, SMALL_FQ_W, SMALL_FQ_FRAMES = 240, 320, 3
SMALL_H, SMALL_W, SMALL_NOCS_FRAMES, SMALL_VOS_FRAMES = 96, 128, 8, 8


def small_inputs() -> dict:
    """bench.py's three evaluations cut to a small size: the same renderers,
    seeds and settings, fewer and smaller frames."""
    from bundletrack_tpu.config import BundleConfig, FrontendConfig, SegmentationConfig, ShapeConfig, nocs_config

    H, W = SMALL_H, SMALL_W
    clean = dict(depth_noise=0.0, depth_quant=0.0, hole_fraction=0.0, mask_errors=False)
    syn = lambda **kw: {"renderer": "render_synthetic_sequence", "args": [], "kwargs": kw}  # noqa: E731
    hard = lambda shape, **kw: {"renderer": "render_hard_sequence", "args": [shape], "kwargs": kw}  # noqa: E731
    vos_kw = dict(H=96, W=96, orbit_deg_per_frame=3.0, background=True, **clean)
    n = SMALL_VOS_FRAMES
    seg = SegmentationConfig()
    return {
        "frontend_quality": {
            "worlds": {
                "easy": {"render": syn(num_frames=SMALL_FQ_FRAMES, H=SMALL_FQ_H, W=SMALL_FQ_W,
                                       orbit_deg_per_frame=4.0, seed=123)},
                "hard": {"render": hard("lshape", num_frames=SMALL_FQ_FRAMES, H=SMALL_FQ_H, W=SMALL_FQ_W,
                                        orbit_deg_per_frame=4.0, roll_deg_per_frame=2.0, seed=123, **clean)},
            },
            "configs": {"classical": dataclasses.asdict(FrontendConfig(kind="classical")),
                        "lfnet": dataclasses.asdict(FrontendConfig(kind="lfnet", input_size=192, top_k=256))},
            "gap": 1, "eps_px": 3.0,
        },
        "nocs": {
            "render": hard("cube", num_frames=SMALL_NOCS_FRAMES, H=H, W=W, seed=29, orbit_deg_per_frame=3.0),
            "tracker": dataclasses.asdict(nocs_config(
                shapes=ShapeConfig(image_h=H, image_w=W),
                bundle=BundleConfig(min_fm_edges_newframe=10, dense_src_capacity=256, early_stop_delta=0.005))),
            "shape": "cube", "size": 0.2, "category": "laptop", "noise_seed": 0,
        },
        "vos": {"clips": {
            "easy": {"render": syn(num_frames=n, H=96, W=96, seed=999, orbit_deg_per_frame=4.0),
                     "segmentation": dataclasses.asdict(seg)},
            "hard": {"render": hard("lshape", num_frames=n, seed=777, **vos_kw),
                     "segmentation": dataclasses.asdict(seg)},
            "hard_longrange": {"render": hard("lshape", num_frames=n, seed=777, **vos_kw),
                               "segmentation": dataclasses.asdict(seg.long_range(n))},
            "occluder": {"render": hard("cube", num_frames=n, seed=778, occluder=True, **vos_kw),
                         "segmentation": dataclasses.asdict(seg)},
        }},
    }


@pytest.fixture(scope="module")
def small_runs():
    """Both packages' runs of small_inputs(), and the bars each part misses
    (eval_suite_missed)."""
    from bundletrack_tpu.config import FrontendConfig as JFrontendConfig
    from bundletrack_tpu.frontend import load_params_npz as jload_params_npz
    from bundletrack_tpu.frontend import make_lfnet_apply as jmake_lfnet_apply
    from bundletrack_tpu_torch.config import FrontendConfig, load_config
    from bundletrack_tpu_torch.eval.replay import eval_suite_missed, load_jax_draws, replay_eval_suite
    from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    inputs = small_inputs()
    jcfg = JFrontendConfig(**inputs["frontend_quality"]["configs"]["lfnet"])
    want = jax_suite(inputs, jmake_lfnet_apply(jcfg, jload_params_npz(LFNET_NPZ, jcfg)[1]))
    fcfg = FrontendConfig(**inputs["frontend_quality"]["configs"]["lfnet"])
    lfnet = make_lfnet_apply(fcfg, load_params_npz(LFNET_NPZ, fcfg)[1])
    draws = load_jax_draws(load_config(inputs["nocs"]["tracker"]), SMALL_NOCS_FRAMES)
    got = replay_eval_suite(inputs, draws, lfnet_apply=lfnet, vos_model=load_vos_npz(VOS_NPZ)[0], device="cpu")
    missed, lines = eval_suite_missed(got, want)
    print("\n".join(lines))
    return got, missed


@pytest.mark.parametrize("frontend", ["classical", "lfnet"])
def test_frontend_quality_small_matches_jax(small_runs, frontend):
    """Repeatability, inlier rate and matches of each frontend on both
    worlds, in both packages on the CPU at a small size, within the card
    run's bars of JAX's (eval_suite_missed)."""
    _, missed = small_runs
    missed = [m for m in missed if m.startswith("frontend") and f"/{frontend} " in m]
    assert not missed, missed


def test_nocs_protocol_small_matches_jax(small_runs):
    """The NOCS protocol with a noisy initial pose, the pass tracked on the
    JAX tracker's draws, in both packages: 5deg5cm and IoU25 within the
    card run's bars, FAIL frames at most JAX's."""
    got, missed = small_runs
    assert not [m for m in missed if m.startswith("nocs")], missed
    assert got["nocs_run"].statuses.shape == (SMALL_NOCS_FRAMES,)


def test_vos_clips_small_match_jax(small_runs):
    """The four VOS clips in both packages: each clip's mean and min IoU
    within the card run's bars."""
    _, missed = small_runs
    assert not [m for m in missed if m.startswith("vos")], missed


def test_reference_file():
    """The committed JAX figures: written by this file's --write-reference
    from the JAX package's commit, at bench.py's sizes and seeds, with every
    input the card run renders and every figure it is held to."""
    with open(REFERENCE_JSON) as f:
        ref = json.load(f)
    assert ref["command"] == REFERENCE_COMMAND and len(ref["jax_package_commit"]) == 40
    assert ref["host"]["platform"] == "cpu"
    inp = ref["inputs"]
    worlds = inp["frontend_quality"]["worlds"]
    assert list(worlds) == ["easy", "hard"]
    assert worlds["easy"]["render"] == {"renderer": "render_synthetic_sequence", "args": [], "kwargs": {
        "num_frames": 5, "H": 240, "W": 320, "orbit_deg_per_frame": 4.0, "seed": 123}}
    assert worlds["hard"]["render"]["args"] == ["lshape"] and worlds["hard"]["render"]["kwargs"]["roll_deg_per_frame"] == 2.0
    cfgs = inp["frontend_quality"]["configs"]
    assert cfgs["lfnet"]["kind"] == "lfnet" and (cfgs["lfnet"]["input_size"], cfgs["lfnet"]["bf16"]) == (400, True)
    nocs = inp["nocs"]
    assert nocs["render"]["kwargs"] == {"num_frames": 48, "H": 480, "W": 640, "seed": 29, "orbit_deg_per_frame": 3.0}
    t = nocs["tracker"]
    # the draws of jax_draws_seed0.npz apply: (M, max_iter, K) as they were drawn for
    assert (t["shapes"]["max_matches"], t["ransac"]["max_iter"], t["bundle"]["max_ba_frames"]) == (256, 2000, 16)
    assert (t["shapes"]["image_h"], t["shapes"]["image_w"], t["bundle"]["dense_src_capacity"]) == (480, 640, 2048)
    assert t["segmentation"]["nocs_mask_fill"] and nocs["noise_seed"] == 0
    clips = inp["vos"]["clips"]
    assert list(clips) == list(VOS_CLIPS)
    assert [c["render"]["kwargs"]["num_frames"] for c in clips.values()] == [32, 110, 110, 48]
    assert clips["hard110_longrange"]["segmentation"]["range_"] == 100
    for world in ("easy", "hard"):
        for frontend in ("classical", "lfnet"):
            row = ref["frontend_quality"][world][frontend]
            assert 0 <= row["repeatability"] <= 1 and 0 <= row["inlier_rate"] <= 1 and row["n_matches"] > 0
    assert len(ref["nocs"]["statuses"]) == 48 and ref["nocs"]["num_frames"] == 48
    for name, n in zip(VOS_CLIPS, (32, 110, 110, 48)):
        assert len(ref["vos"][name]["per_frame"]) == n - 1
        assert ref["vos"][name]["min_iou"] == pytest.approx(min(ref["vos"][name]["per_frame"]), abs=1e-6)


def test_reference_draws_are_the_nocs_trackers():
    """The NOCS pass's JAX Tracker (seeded 0 by track_sequence) draws the
    first 48 frames of the committed draws file."""
    from bundletrack_tpu.config import load_config as jload_config
    from bundletrack_tpu_torch.config import load_config
    from bundletrack_tpu_torch.eval.replay import load_jax_draws

    with open(REFERENCE_JSON) as f:
        tracker = json.load(f)["inputs"]["nocs"]["tracker"]
    neighbour, pairs = jax_draws_arrays(jload_config(tracker), 48, seed=0)
    draws = load_jax_draws(load_config(tracker), 48)
    for f in (0, 1, 47):
        np.testing.assert_array_equal(draws[f][0], neighbour[f])
        np.testing.assert_array_equal(draws[f][1], pairs[f])


# ---- full scale (slow) ---------------------------------------------------------


@pytest.mark.slow
def test_jax_reference_reproduces():
    """A rerun of bench.py's three evaluations on the JAX package equals the
    committed file (XLA on the CPU is deterministic)."""
    with open(REFERENCE_JSON) as f:
        want = json.load(f)
    got = json.loads(json.dumps(jax_reference()))
    for key in ("inputs", "frontend_quality", "nocs", "vos"):
        assert got[key] == want[key], key


@pytest.mark.slow
def test_port_on_the_cpu_at_full_scale():
    """The port on the CPU on the committed inputs, against the JAX figures:
    the gaps the card's bars were derived from (printed), held to them."""
    from bundletrack_tpu_torch.config import load_config
    from bundletrack_tpu_torch.eval.replay import eval_suite_missed, load_jax_draws, replay_eval_suite
    from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply
    from bundletrack_tpu_torch.models.vos import load_vos_npz

    with open(REFERENCE_JSON) as f:
        ref = json.load(f)
    inputs = ref["inputs"]
    fcfg = load_config({"frontend": inputs["frontend_quality"]["configs"]["lfnet"]}).frontend
    draws = load_jax_draws(load_config(inputs["nocs"]["tracker"]), 48)
    got = replay_eval_suite(inputs, draws, lfnet_apply=make_lfnet_apply(fcfg, load_params_npz(LFNET_NPZ, fcfg)[1]),
                            vos_model=load_vos_npz(VOS_NPZ)[0], device="cpu")
    missed, lines = eval_suite_missed(got, ref)
    print("\n".join(lines))
    assert not missed, missed


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-reference", action="store_true",
                    help=f"run bench.py's evaluations on the JAX package and write {os.path.relpath(REFERENCE_JSON, REPO)}")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    if args.write_reference:
        ref = write_reference()
        print(json.dumps({k: ref[k] for k in ("frontend_quality", "nocs", "bench_py", "seconds", "wall_s")}))
