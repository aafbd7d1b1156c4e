"""The long-horizon suite replayed on the JAX tracker's own RANSAC draws.

Re-acquisition and drift on the hostile long passes depend on the RANSAC
draws, and the port's trackers draw from `torch.Generator`, not JAX's
threefry.  The JAX tracker splits its key the same way on every frame,
whatever the data, so its draws depend only on its seed and on
(max_matches, ransac.max_iter, bundle.max_ba_frames): `jax_draws_seed0.npz`
holds those of a JAX `Tracker` seeded with 0 at bench.py's (256, 2000, 16)
for 128 frames, as uint8 (every phase lies in [0, 256)), and
`jax_draws_seeds.npz` those of the trackers seeded 1-7 (the LF-Net orbit on
VOS masks is barred on its mean over the eight draw sets).  With them the
port tracks a pass on the JAX tracker's draws, and its reports can be held
to the JAX package's figures pass for pass.

`replay_long_suite` tracks the passes as `hard_suite.run_long_suite` does
(its pass order and `LONG_PASS_SHAPES`, `pass_report`, the VOS orbit on
`generate_vos_masks` with `SegmentationConfig().long_range`), each frame
given its draws through `Tracker.process_frame(..., phases=)`.

`replay_eval_suite` runs bench.py's other accuracy evaluations (frontend
quality, the NOCS protocol with a noisy initial pose, VOS over long clips)
from the inputs the JAX package's run of them records
(`jax_eval_suite_cpu.json`'s "inputs": each sequence's renderer and
arguments, each configuration): the same sequences, configurations and
seeds, and the NOCS pass on the same draws.  The JAX `track_sequence`
seeds its `Tracker` with 0, so a pass of F frames at (256, 2000, 16) draws
the first F frames of the draws file.  Tracking and the networks run on
the card unless `device` says otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from bundletrack_tpu_torch.eval.hard_suite import LONG_PASS_SHAPES, generate_vos_masks, pass_report

_EVAL_DIR = os.path.dirname(os.path.abspath(__file__))
DRAWS_NPZ = os.path.join(_EVAL_DIR, "jax_draws_seed0.npz")
SEED_DRAWS_NPZ = os.path.join(_EVAL_DIR, "jax_draws_seeds.npz")  # seeds 1-7, stacked


def draw_seeds() -> List[int]:
    """The seeds whose JAX draws are committed: 0 and those of SEED_DRAWS_NPZ."""
    with np.load(SEED_DRAWS_NPZ) as data:
        return [0] + [int(s) for s in data["seeds"]]


def load_jax_draws(cfg, num_frames: int, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The phases of the JAX tracker seeded with `seed` for frames
    0..num_frames-1, each frame's (neighbour [3, n_rep], BA pairs [P, 3,
    n_rep]) as int64, the form `Tracker.process_frame(..., phases=)` takes.
    Raises if the file was drawn for another (M, max_iter, K), holds fewer
    frames, other shapes or not that seed."""
    path = DRAWS_NPZ if seed == 0 else SEED_DRAWS_NPZ
    with np.load(path) as data:
        neighbour, pairs = data["neighbour"], data["pairs"]
        drawn_for = tuple(int(data[k]) for k in ("max_matches", "max_iter", "max_ba_frames"))
        if seed != 0:
            seeds = [int(s) for s in data["seeds"]]
            if seed not in seeds:
                raise ValueError(f"no draws for seed {seed}: {path} holds seeds {seeds}")
            neighbour, pairs = neighbour[seeds.index(seed)], pairs[seeds.index(seed)]
    M, K = cfg.shapes.max_matches, cfg.bundle.max_ba_frames
    want = (M, cfg.ransac.max_iter, K)
    if drawn_for != want:
        raise ValueError(f"{path} holds draws for (M, max_iter, K) = {drawn_for}, not {want}")
    if len(neighbour) < num_frames:
        raise ValueError(f"{path} holds {len(neighbour)} frames of draws, not {num_frames}")
    n_rep = -(-cfg.ransac.max_iter // M)
    if neighbour.shape[1:] != (3, n_rep) or pairs.shape[1:] != (K * (K - 1) // 2, 3, n_rep):
        raise ValueError(f"{path}: draws of shapes {neighbour.shape}, {pairs.shape}")
    return [(neighbour[f].astype(np.int64), pairs[f].astype(np.int64)) for f in range(num_frames)]


class PassRun(NamedTuple):
    poses: np.ndarray  # [F, 4, 4] ob_in_cam
    statuses: np.ndarray  # [F]
    num_ba_edges: np.ndarray  # [F]
    frame_ms: np.ndarray  # [F] host clock from the upload to the outputs read back


def replay_pass(cfg, seq, draws, lfnet_apply=None, device=None) -> PassRun:
    """Track `seq` as `track_sequence` does, frame f on draws[f].  A frame's
    ms ends when its outputs are read back, which waits for the device."""
    from bundletrack_tpu_torch.tracker.driver import Tracker

    F, H, W = seq.gray.shape
    tracker = Tracker(cfg, H, W, lfnet_apply=lfnet_apply, device=device)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    poses, statuses, edges, frame_ms = [], [], [], []
    for f in range(F):
        t0 = time.perf_counter()
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=draws[f])
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
        edges.append(int(out.num_ba_edges))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return PassRun(np.stack(poses), np.asarray(statuses), np.asarray(edges), np.asarray(frame_ms))


def replay_long_suite(cfg, passes: Dict, draws, lfnet_apply=None, vos_model=None, device=None) -> Dict:
    """`run_long_suite` on the given draws, with `vos_model` (a VOSNet with
    its weights) in place of its `vos_ckpt`.  Returns {"passes": {pass:
    report}, "mean_adds_auc": mean} as it does, and beside them "runs":
    {pass: PassRun} and, with `vos_model`, the "orbit_vosmask" pass's
    "vos_masks"."""
    reports, runs = {}, {}
    for name, seq in passes.items():
        runs[name] = replay_pass(cfg, seq, draws, lfnet_apply, device)
        reports[name] = pass_report(runs[name].poses, runs[name].statuses, seq, LONG_PASS_SHAPES.get(name, "cube"))
    out = {}
    if vos_model is not None:
        from bundletrack_tpu_torch.config import SegmentationConfig
        from bundletrack_tpu_torch.eval.vos_eval import mask_iou

        seq = passes["orbit"]
        seg_cfg = SegmentationConfig().long_range(len(seq.gray))
        vos_masks = generate_vos_masks(seq, vos_model, seg_cfg, device=device)
        runs["orbit_vosmask"] = replay_pass(cfg, seq._replace(mask=vos_masks), draws, lfnet_apply, device)
        run = runs["orbit_vosmask"]
        rep = pass_report(run.poses, run.statuses, seq, LONG_PASS_SHAPES["orbit"])
        gt = getattr(seq, "mask_gt", seq.mask)
        ious = [mask_iou(vos_masks[f], gt[f]) for f in range(1, len(vos_masks))]
        rep["vos_mask_mean_iou"] = round(float(np.mean(ious)), 3)
        rep["vos_mask_min_iou"] = round(float(np.min(ious)), 3)
        reports["orbit_vosmask"] = rep
        out["vos_masks"] = vos_masks
    mean = float(np.mean([r["adds_auc"] for r in reports.values()]))
    return {"passes": reports, "mean_adds_auc": round(mean, 2), "runs": runs, **out}


# ---- bench.py's frontend quality, NOCS protocol and VOS clips ----------------


def spec_key(spec: dict) -> str:
    """A render spec {"renderer", "args", "kwargs"} as a hashable key."""
    return json.dumps(spec, sort_keys=True)


def render_spec(spec: dict):
    """The sequence a recorded render spec names, from the port's renderers
    (numpy, the same arithmetic as the JAX package's)."""
    from bundletrack_tpu_torch.data.hard_world import render_hard_sequence
    from bundletrack_tpu_torch.data.synthetic import render_synthetic_sequence

    fn = {"render_synthetic_sequence": render_synthetic_sequence,
          "render_hard_sequence": render_hard_sequence}[spec["renderer"]]
    return fn(*spec["args"], **spec["kwargs"])


def eval_suite_specs(inputs: dict) -> Dict[str, dict]:
    """{spec_key: spec} of every sequence the eval suite's inputs render,
    each distinct one once (a caller may render them in parallel)."""
    specs = [w["render"] for w in inputs["frontend_quality"]["worlds"].values()]
    specs += [inputs["nocs"]["render"]] + [c["render"] for c in inputs["vos"]["clips"].values()]
    return {spec_key(s): s for s in specs}


def box_corners(points: np.ndarray) -> np.ndarray:
    """[3, 8] corners of the axis-aligned box around points [N, 3]."""
    lo, hi = points.min(0), points.max(0)
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                    np.float32).T


def nocs_protocol_run(cfg, seq, draws, shape: str, size: float, category: str, noise_seed: int,
                      device=None) -> Tuple[dict, PassRun]:
    """bench.py's `_bench_nocs` on the given draws: track `seq`, perturb the
    true first pose with the reference's +-0.02 m noise from
    RandomState(noise_seed), re-anchor the trajectory on it and score it
    (evaluate_nocs: 5deg5cm, IoU25, mean errors) against the truth with the
    model's bounding box; with "n_fail", the FAIL frames.  Returns (metrics,
    the tracked run)."""
    from bundletrack_tpu_torch.data.hard_world import model_points
    from bundletrack_tpu_torch.eval.nocs_protocol import evaluate_nocs, perturb_init_pose, reanchor_trajectory

    run = replay_pass(cfg, seq, draws, device=device)
    noisy_init = perturb_init_pose(seq.ob_in_cam[0], rng=np.random.RandomState(noise_seed))
    preds = reanchor_trajectory(list(run.poses), noisy_init)
    res = evaluate_nocs(preds, list(seq.ob_in_cam), box_corners(model_points(shape, size=size)), category)
    res["n_fail"] = int(np.sum(run.statuses == 1))
    return res, run


def replay_eval_suite(inputs: dict, draws, lfnet_apply=None, vos_model=None, seqs=None, device=None) -> Dict:
    """bench.py's `_frontend_quality`, `_bench_nocs` and `_bench_vos` from
    recorded `inputs`, the NOCS pass on `draws`.  `seqs` maps spec_key to
    an already rendered sequence (the rest are rendered here).  Returns
    their results as bench.py lays them out, unrounded, with "per_frame"
    IoUs for each VOS clip, and beside them "nocs_run" (a PassRun) and
    "vos_runs" (each clip's evaluate_vos output, masks included)."""
    from bundletrack_tpu_torch.config import load_config
    from bundletrack_tpu_torch.eval.frontend_eval import evaluate_frontend
    from bundletrack_tpu_torch.eval.vos_eval import evaluate_vos

    seqs = dict(seqs or {})
    for key, spec in eval_suite_specs(inputs).items():
        if key not in seqs:
            seqs[key] = render_spec(spec)

    fq_in = inputs["frontend_quality"]
    fq = {}
    for wname, world in fq_in["worlds"].items():
        seq = seqs[spec_key(world["render"])]
        row = {}
        for frontend, fcfg in fq_in["configs"].items():
            if frontend == "lfnet" and lfnet_apply is None:
                continue
            cfg = load_config({"frontend": fcfg}).frontend
            row[frontend] = evaluate_frontend(seq, cfg, lfnet_apply=lfnet_apply if frontend == "lfnet" else None,
                                              gap=fq_in["gap"], eps_px=fq_in["eps_px"], device=device)
        fq[wname] = row

    nin = inputs["nocs"]
    nocs, nocs_run = nocs_protocol_run(load_config(nin["tracker"]), seqs[spec_key(nin["render"])], draws,
                                       nin["shape"], nin["size"], nin["category"], nin["noise_seed"], device=device)

    vos, vos_runs = {}, {}
    if vos_model is not None:
        vos["width"] = int(vos_model.width)
        for name, clip in inputs["vos"]["clips"].items():
            seg_cfg = load_config({"segmentation": clip["segmentation"]}).segmentation
            r = evaluate_vos(vos_model, seg_cfg, seqs[spec_key(clip["render"])], device=device)
            vos[name] = {"mean_iou": r["mean_iou"], "min_iou": r["min_iou"],
                         "tail10_mean": float(np.mean(r["per_frame"][-10:])), "per_frame": r["per_frame"]}
            vos_runs[name] = r
    return {"frontend_quality": fq, "nocs": nocs, "vos": vos, "nocs_run": nocs_run, "vos_runs": vos_runs}


# Bars of the eval suite, the port against the JAX package's run of it,
# each beside the gap the port on the CPU showed against the JAX CPU file at
# full scale (tests/test_torch_eval_suite.py::test_port_on_the_cpu_at_full_scale).
# Frontend quality, per world and frontend: repeatability and inlier rate
# within FQ_RATE_SLACK of JAX's (largest CPU gap: classical 0.0041, the easy
# world's inlier rate; LF-Net 0.0060, the easy world's repeatability: bf16
# roundings flip between summation orders), n_matches within
# FQ_MATCHES_RTOL of JAX's (largest CPU gap 1.2 %, LF-Net on the hard world).
FQ_RATE_SLACK = {"classical": 0.02, "lfnet": 0.04}
FQ_MATCHES_RTOL = 0.05
# NOCS: 5deg5cm and IoU25 at least JAX's minus this many points, FAIL frames
# at most JAX's (CPU: 100 / 100 / 0 FAIL, as JAX's; mean errors 0.235 deg,
# 0.960 cm against 0.223, 0.958)
NOCS_SLACK = 2.0
# VOS, per clip: mean IoU within VOS_MEAN_SLACK of JAX's, min within
# VOS_MIN_SLACK (CPU: equal to 4 digits on all four clips)
VOS_MEAN_SLACK, VOS_MIN_SLACK = 0.01, 0.03


def eval_suite_missed(got: Dict, want: Dict) -> Tuple[List[str], List[str]]:
    """`replay_eval_suite`'s results against the JAX package's (the same
    layout): (the bars missed, one log line per figure with its gap)."""
    missed, lines = [], []

    def hold(name, g, w, slack, below_only=False):
        gap = g - w
        lines.append(f"{name}: port {g:.4f}, JAX {w:.4f}, gap {gap:+.4f} (bar {'-' if below_only else '+-'}{slack:g})")
        if (-gap if below_only else abs(gap)) > slack:
            missed.append(f"{name} {g:.4f} not within {slack:g} of JAX's {w:.4f}")

    for world, row in want["frontend_quality"].items():
        for frontend, w in row.items():
            g = got["frontend_quality"][world][frontend]
            for metric in ("repeatability", "inlier_rate"):
                hold(f"frontend {world}/{frontend} {metric}", g[metric], w[metric], FQ_RATE_SLACK[frontend])
            hold(f"frontend {world}/{frontend} n_matches", g["n_matches"], w["n_matches"],
                 FQ_MATCHES_RTOL * w["n_matches"])
    g, w = got["nocs"], want["nocs"]
    for metric in ("5deg5cm", "IoU25"):
        hold(f"nocs {metric}", g[metric], w[metric], NOCS_SLACK, below_only=True)
    lines.append(f"nocs n_fail: port {g['n_fail']}, JAX {w['n_fail']}; mean errors port {g['rot_err_deg_mean']} deg, "
                 f"{g['trans_err_cm_mean']} cm, JAX {w['rot_err_deg_mean']} deg, {w['trans_err_cm_mean']} cm")
    if g["n_fail"] > w["n_fail"]:
        missed.append(f"nocs: {g['n_fail']} FAIL frames > JAX's {w['n_fail']}")
    for clip, w in want["vos"].items():
        if clip == "width":
            continue
        g = got["vos"][clip]
        hold(f"vos {clip} mean IoU", g["mean_iou"], w["mean_iou"], VOS_MEAN_SLACK)
        hold(f"vos {clip} min IoU", g["min_iou"], w["min_iou"], VOS_MIN_SLACK)
        lines.append(f"vos {clip} tail10 mean IoU: port {g['tail10_mean']:.4f}, JAX {w['tail10_mean']:.4f}")
    return missed, lines
