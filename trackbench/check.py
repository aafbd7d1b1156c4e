"""What decides `correct`: the program against the plain reference.

On the sampled fleet frames of the window (drawn from the seed) the
harness keeps, by reference, the program's state before the step, its
generators' states, the observation, and what the step produced: the
frontend's features, the BA matcher's inputs and rows, the Gauss-Newton
solve's inputs and poses, the output poses and the state after the step.
Once the window has closed, the program's state is freed and the
reference (trackbench/reference/, which imports nothing of the program)
works each of them out again:

- `keypoints_differ`: the share of keypoints, program's and reference's
  together, that have no partner within 0.5 px in the other set, when the
  reference runs the preprocess and the frontend on the same observation;
- `descriptor_gap`: the largest |d_program - d_reference| / |d_reference|
  over the keypoints that have a partner;
- `matches_differ`: the share of the matcher's rows (pair, keypoint) whose
  mutual flag or, where mutual, partner differs, the reference's plain
  matcher run on the program's own BA table;
- `gn_gap_mm`: the largest displacement of a cube corner between the
  program's solved BA poses and the reference solve of the program's own
  GraphInputs;
- `pose_gap_mm`: the same between the output poses of the program's step
  and of the reference step from the program's state before it, with the
  same generators' states (so the same RANSAC phases);
- `state_gap_mm`: the same for the poses the state after the step carries
  forward (the previous pose and the constant-velocity prediction).

The reference follows the program step by step from the program's own
state: the check covers each sampled frame, and the window's state between
them is the program's.  Every pose of the window is also held to the
renderer's ground truth (`gt_err_mm`, reported, see PERF.md).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from trackbench import arith

PORT = "bundletrack_tpu_torch"
REF = "trackbench.reference"
NUMBERS = ("keypoints_differ", "descriptor_gap", "matches_differ", "gn_gap_mm", "pose_gap_mm",
           "state_gap_mm")
MATCHER_PAIRS_PER_BLOCK = 120


def to_reference(x):
    """A program NamedTuple (recursively) as the reference's type of the same
    name; tensors and other values pass through."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        mod = type(x).__module__
        if mod.startswith(PORT):
            cls = getattr(importlib.import_module(REF + mod[len(PORT):]), type(x).__name__)
            return cls(*(to_reference(v) for v in x))
        return type(x)(*(to_reference(v) for v in x))
    return x


def _gen(device, state):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def _np(t):
    return t.detach().float().cpu().numpy()


def move(tree, device):
    """Every tensor of a nest of tuples, lists and dicts moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(move(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(move(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: move(v, device) for k, v in tree.items()}
    return tree


class Sample:
    """What the window kept of one sampled fleet frame.  Moved to the host
    between frames (`move`), so that holding it takes no device memory and
    the peak read is the program's own."""

    pre = rng_states = obs = truth = post = out = feats = matcher = gn = None
    KEPT = ("pre", "post", "out", "feats", "matcher", "gn")

    def move(self, device):
        for name in self.KEPT:
            setattr(self, name, move(getattr(self, name), device))


class Reference:
    """The reference tracker for a cell's configuration, on `device`."""

    def __init__(self, cell, device, weights_path=None):
        from trackbench.capture import Hooks
        from trackbench.reference.config import load_config
        from trackbench.reference.tracker.bundler import make_batched_track_frame

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.cfg = load_config(cell.config["tracker"])
        self.H, self.W = int(cell.config["image"]["H"]), int(cell.config["image"]["W"])
        lfnet = None
        if self.cfg.frontend.kind == "lfnet":
            from trackbench.reference.frontend.lfnet import load_params_npz, make_lfnet_apply

            _, params = load_params_npz(weights_path, self.cfg.frontend)
            lfnet = make_lfnet_apply(self.cfg.frontend, params).to(self.device)
        self.lfnet = lfnet
        self.step = make_batched_track_frame(self.cfg, self.H, self.W, lfnet)
        self.hooks = Hooks(package=REF, wrapped=(("tracker.bundler", "extract_frame_features", "frontend",
                                                  "feats"),))

    def observation(self, obs):
        from trackbench.reference.tracker.state import FrameObservation

        gray, depth, mask, K = obs
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return FrameObservation(gray=up(gray), depth=up(depth.astype(np.int32)), mask=up(mask),
                                K=up(np.asarray(K, np.float32)))

    def step_from(self, sample: Sample, init_pose):
        """(state after, outputs, features) of the reference step from the
        sample's state before the program's step."""
        pre = to_reference(sample.pre)
        pre = pre._replace(rng=tuple(_gen(self.device, s) for s in sample.rng_states))
        self.hooks.calls.clear()
        self.hooks.armed = True
        self.hooks.install()
        try:
            with torch.no_grad():
                post, out = self.step(pre, self.observation(sample.obs), init_pose)
        finally:
            self.hooks.remove()
            self.hooks.armed = False
        feats = self.hooks.calls["feats"][-1][2]
        return post, out, feats

    def matcher(self, args, kwargs):
        """The plain matcher on the program's own table, MATCHER_PAIRS_PER_BLOCK pairs at a time."""
        from trackbench.reference.kernels.matching import fused_mutual_match_pairs

        desc, world, wnrm, valid, pair_i, pair_j = args
        outs = []
        for lo in range(0, pair_i.shape[0], MATCHER_PAIRS_PER_BLOCK):
            sl = slice(lo, lo + MATCHER_PAIRS_PER_BLOCK)
            outs.append(fused_mutual_match_pairs(desc, world, wnrm, valid, pair_i[sl], pair_j[sl], **kwargs))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def gn(self, args, kwargs):
        """The reference solve of the program's own GraphInputs."""
        from trackbench.reference.solver.gauss_newton import optimize_pose_graph_verified

        inputs = to_reference(args[0])
        with torch.no_grad():
            return optimize_pose_graph_verified(inputs, self.cfg.bundle, p2p=self.cfg.p2p)


def control_candidate(sample: Sample, ref: Reference, init_pose) -> dict:
    """What the control, the reference one precision below the stated one
    (reference/precision.py), produces in the program's place on the sample."""
    from trackbench.reference import precision

    precision.set_control(True)
    try:
        post, out, feats = ref.step_from(sample, init_pose)
        return {"post": post, "out": out, "feats": feats, "matcher": ref.matcher(*sample.matcher[:2]),
                "gn": ref.gn(*sample.gn[:2])}
    finally:
        precision.set_control(False)


def keypoint_numbers(prog, ref) -> tuple:
    """(share of keypoints with no partner, largest relative descriptor gap)."""
    unmatched, total, gap = 0, 0, 0.0
    uv_p, uv_r, d_p, d_r = _np(prog.uv), _np(ref.uv), _np(prog.desc), _np(ref.desc)
    v_p, v_r = prog.valid.cpu().numpy(), ref.valid.cpu().numpy()
    for s in range(uv_p.shape[0]):
        a, b = uv_p[s][v_p[s]], uv_r[s][v_r[s]]
        total += len(a) + len(b)
        if len(a) == 0 or len(b) == 0:
            unmatched += len(a) + len(b)
            continue
        dist = np.max(np.abs(a[:, None, :] - b[None, :, :]), axis=-1)
        nearest_b, nearest_a = dist.argmin(1), dist.argmin(0)
        ok_a = dist[np.arange(len(a)), nearest_b] <= 0.5
        ok_b = dist[nearest_a, np.arange(len(b))] <= 0.5
        unmatched += int((~ok_a).sum() + (~ok_b).sum())
        da, db = d_p[s][v_p[s]][ok_a], d_r[s][v_r[s]][nearest_b[ok_a]]
        if len(da):
            rel = np.linalg.norm(da - db, axis=-1) / np.maximum(np.linalg.norm(db, axis=-1), 1e-6)
            gap = max(gap, float(rel.max()))
    return unmatched / max(total, 1), gap


def matcher_share(prog_out, ref_out) -> float:
    """Share of rows whose mutual flag, or partner where mutual, differs."""
    best_p, _, mut_p = prog_out
    best_r, _, mut_r = ref_out
    differ = (mut_p != mut_r) | (mut_p & mut_r & (best_p.long() != best_r.long()))
    return float(differ.float().mean())


def _ob_in_cam(pose_in_model):
    return np.linalg.inv(np.asarray(pose_in_model, np.float64))


def compare(sample: Sample, ref: Reference, init_pose, corners, candidate=None) -> dict:
    """The numbers of one sample.  `candidate` (the control) stands in the
    program's place: a dict with "post", "out", "feats", "matcher", "gn"."""
    r_post, r_out, r_feats = ref.step_from(sample, init_pose)
    c = candidate or {"post": sample.post, "out": sample.out, "feats": sample.feats,
                      "matcher": sample.matcher[2], "gn": sample.gn[2]}
    kp, desc = keypoint_numbers(c["feats"], r_feats)
    m_args, m_kwargs, _ = sample.matcher
    matches = matcher_share(c["matcher"], ref.matcher(m_args, m_kwargs))
    g_args, g_kwargs, _ = sample.gn
    r_gn = ref.gn(g_args, g_kwargs)
    valid = _np(g_args[0].frame_valid).astype(bool)
    gn_gap = arith.corner_gap_mm(_ob_in_cam(_np(c["gn"][0])[valid]), _ob_in_cam(_np(r_gn[0])[valid]), corners)
    pose_gap = arith.corner_gap_mm(_np(c["out"].ob_in_cam), _np(r_out.ob_in_cam), corners)
    state_gap = max(arith.corner_gap_mm(_ob_in_cam(_np(getattr(c["post"], k))), _ob_in_cam(_np(getattr(r_post, k))),
                                        corners) for k in ("prev_pose", "pred_pose"))
    return {"keypoints_differ": kp, "descriptor_gap": desc, "matches_differ": matches, "gn_gap_mm": gn_gap,
            "pose_gap_mm": pose_gap, "state_gap_mm": state_gap,
            "gt_err_mm": arith.corner_gap_mm(_np(c["out"].ob_in_cam), sample.truth, corners)}


def worst(rows) -> dict:
    """The largest of each number over the samples (NaN counts as worst)."""
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        out[k] = float("inf") if any(not np.isfinite(v) for v in vals) else max(vals)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
