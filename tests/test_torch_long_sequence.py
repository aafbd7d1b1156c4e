"""The port on long sequences, the FAIL path and the verification reject path.

Mirrors tests/test_long_sequence.py (a full 400-degree orbit with a small
keyframe pool, LF-Net on the shipped weights, an occlusion dropout: pool
eviction, FAIL only around the occlusion, recovery, bounded drift; the port
runs the JAX test's RANSAC draws) and
tests/test_verification_e2e.py (`bundle.use_verification`: a trigger-happy
threshold rejects every BA solve and reverts cleanly, the default one never
rejects, a corrupted-depth episode is flagged and recovered from), with the
JAX tests' own configurations and bars.  And holds the FAIL path to the
JAX tracker: a dropout tracked by both packages, the port given the JAX
tracker's RANSAC phases, gives the same statuses and the same poses within
1e-5 m and 1e-3 deg.  On the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jax_draws import jax_phases, phases_from_key
from bundletrack_tpu.config import (
    BundleConfig as JBundleConfig,
    FeatureCorresConfig as JFeatureCorresConfig,
    FrontendConfig as JFrontendConfig,
    KeyframeConfig as JKeyframeConfig,
    RansacConfig as JRansacConfig,
    ShapeConfig as JShapeConfig,
    TrackerConfig as JTrackerConfig,
)
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.apps.run_tracking import LFNET_CKPT
from bundletrack_tpu_torch.config import (
    BundleConfig,
    DepthProcessingConfig,
    ErodeConfig,
    FrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig,
    load_config,
)
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.eval import adds_auc, pose_errors
from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply
from bundletrack_tpu_torch.tracker.driver import Tracker
from bundletrack_tpu_torch.tracker.state import STATUS_FAIL, STATUS_NO_BA, STATUS_OK

torch.set_num_threads(2)


# ---- tests/test_long_sequence.py ---------------------------------------------

N_FRAMES = 100  # a 400-degree orbit at 4 deg/frame
OCCLUDED = (45, 46, 47)  # the corner-on viewpoint, ~180 deg


def long_run_cfg() -> TrackerConfig:
    """tests/test_long_sequence.py's configuration."""
    fcfg = FrontendConfig(kind="lfnet", input_size=192, top_k=256)
    return TrackerConfig(
        # erode.diff scaled to 120x160, as the JAX test explains
        depth_processing=DepthProcessingConfig(erode=ErodeConfig(diff=0.004)),
        bundle=BundleConfig(max_ba_frames=8),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=fcfg,
        ransac=RansacConfig(max_iter=512),
        shapes=ShapeConfig(max_matches=128, image_h=120, image_w=160),
    )


def occluded_orbit():
    """tests/test_long_sequence.py's sequence: the object vanishes for a few frames."""
    seq = render_synthetic_sequence(num_frames=N_FRAMES, H=120, W=160, orbit_deg_per_frame=4.0)
    for f in OCCLUDED:
        seq.mask[f] = False
        seq.depth[f] = 0.0
    return seq


def long_run_bars(seq, poses, statuses) -> dict:
    """tests/test_long_sequence.py's bars on one run: FAIL only around the
    occlusion, the tail's rotation error, the drift over the orbit."""
    fails = set(np.nonzero(statuses == STATUS_FAIL)[0])
    ok = statuses != STATUS_FAIL
    model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
    auc = adds_auc([poses[f] for f in range(N_FRAMES) if ok[f]],
                   [seq.ob_in_cam[f] for f in range(N_FRAMES) if ok[f]], model_pts)
    rot_deg, trans = pose_errors(poses[-1], seq.ob_in_cam[-1])
    tail_rot = np.mean([pose_errors(poses[f], seq.ob_in_cam[f])[0] for f in range(N_FRAMES - 20, N_FRAMES)])
    return {
        "fails_only_there": set(OCCLUDED) <= fails <= set(range(OCCLUDED[0], OCCLUDED[-1] + 18)),
        "recovers": bool(tail_rot < 3.0),
        "drift_bounded": bool(auc > 90.0 and rot_deg < 3.0 and trans < 0.015),
    }


@pytest.fixture(scope="module")
def long_run():
    """The JAX test's run, the port given the JAX tracker's RANSAC draws.
    Re-acquiring after the occlusion is chaotic in the draws: the constant-
    velocity prediction carries the last frame's delta through the dropout,
    and a noisy last delta can leave every later frame without neighbour
    matches: some seeds of the JAX tracker's own draws never re-acquire,
    and neither does the port's generator at seed 0.  So the mirror runs
    the JAX test's draws."""
    cfg = long_run_cfg()
    _, params = load_params_npz(LFNET_CKPT, cfg.frontend)
    seq = occluded_orbit()
    trk = Tracker(cfg, 120, 160, lfnet_apply=make_lfnet_apply(cfg.frontend, params), device="cpu")
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    outs = [trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=ph)
            for f, ph in enumerate(jax_phases(cfg, N_FRAMES))]
    poses = np.stack([o.ob_in_cam.numpy() for o in outs])
    return cfg, seq, poses, np.asarray([int(o.status) for o in outs]), trk


class TestLongSequence:
    def test_pool_saturated_and_evicting(self, long_run):
        cfg, _, _, _, trk = long_run
        kf_ids = trk.state.kf_frame_id.numpy()
        assert (kf_ids >= 0).all(), "pool should be full after 100 frames"
        # eviction happened: some keyframes are from late in the run
        assert kf_ids.max() > cfg.keyframe.pool_size * 4

    def test_occlusion_fails_only_there(self, long_run):
        """FAILs cover the occlusion plus at most a short reinit window."""
        _, _, _, statuses, _ = long_run
        fails = set(np.nonzero(statuses == STATUS_FAIL)[0])
        assert set(OCCLUDED) <= fails
        assert fails <= set(range(OCCLUDED[0], OCCLUDED[-1] + 18)), fails

    def test_recovers_after_occlusion(self, long_run):
        _, seq, poses, _, _ = long_run
        tail_rot = [pose_errors(poses[f], seq.ob_in_cam[f])[0] for f in range(N_FRAMES - 20, N_FRAMES)]
        assert np.mean(tail_rot) < 3.0, f"tail rot {np.mean(tail_rot)} deg"

    def test_drift_bounded_over_full_orbit(self, long_run):
        _, seq, poses, statuses, _ = long_run
        ok = statuses != STATUS_FAIL
        model_pts = (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2
        auc = adds_auc([poses[f] for f in range(N_FRAMES) if ok[f]],
                       [seq.ob_in_cam[f] for f in range(N_FRAMES) if ok[f]], model_pts)
        assert auc > 90.0, f"ADD-S AUC {auc}"
        rot_deg, trans = pose_errors(poses[-1], seq.ob_in_cam[-1])
        assert rot_deg < 3.0, f"terminal rot drift {rot_deg} deg"
        assert trans < 0.015, f"terminal trans drift {trans} m"


# ---- the seed study: re-acquisition over the trackers' own draws --------------

STUDY_SEEDS = range(8)


def seed_study_run(seed: int, package: str) -> tuple:
    """tests/test_long_sequence.py's run with the tracker seeded `seed`:
    the JAX tracker on its own key ("jax"), the port on its own
    torch.Generator ("port"), or the port on the draws of the JAX tracker
    seeded `seed` ("port on jax draws"); returns (the test's bars on it,
    the poses)."""
    cfg = long_run_cfg()
    seq = occluded_orbit()
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    if package == "jax":
        from bundletrack_tpu.config import load_config as jload_config
        from bundletrack_tpu.frontend import load_params_npz as jload_params_npz
        from bundletrack_tpu.frontend import make_lfnet_apply as jmake_lfnet_apply

        jcfg = jload_config(dataclasses.asdict(cfg))
        _, params = jload_params_npz(LFNET_CKPT, jcfg.frontend)
        trk = JaxTracker(jcfg, 120, 160, jmake_lfnet_apply(jcfg.frontend, params), seed=seed)
        outs = [trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose) for f in range(N_FRAMES)]
        poses = np.stack([np.asarray(o.ob_in_cam) for o in outs])
    else:
        _, params = load_params_npz(LFNET_CKPT, cfg.frontend)
        trk = Tracker(cfg, 120, 160, lfnet_apply=make_lfnet_apply(cfg.frontend, params), device="cpu", seed=seed)
        draws = jax_phases(cfg, N_FRAMES, seed) if package == "port on jax draws" else [None] * N_FRAMES
        outs = [trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=ph)
                for f, ph in enumerate(draws)]
        poses = np.stack([o.ob_in_cam.numpy() for o in outs])
    return long_run_bars(seq, poses, np.asarray([int(o.status) for o in outs])), poses


# two runs on the same draws part at the first frame whose poses differ by
# more than the tracker's pose bar (tests/test_tracker_synthetic.py)
PART_ROT_DEG, PART_TRANS_M = 1.0, 0.005


def where_runs_part(poses_a, poses_b) -> tuple:
    """(rotation difference at frame 1 in degrees, the first frame where the
    two runs differ by more than PART_*, or None)."""
    from bundletrack_tpu_torch.eval.metrics import pose_errors

    diffs = [pose_errors(a, b) for a, b in zip(poses_a, poses_b)]
    parted = [f for f, (rot, trans) in enumerate(diffs) if rot > PART_ROT_DEG or trans > PART_TRANS_M]
    return diffs[1][0], (parted[0] if parted else None)


@pytest.mark.slow
def test_seed_study_reacquire_rates():
    """Re-acquisition after the occlusion is chaotic in the RANSAC draws.
    Over seeds 0-7, each package on its own generator: a seed re-acquires
    when the run meets every bar of tests/test_long_sequence.py.  The port's
    rate may fall below JAX's by at most one seed in eight.  The port on
    the JAX tracker's draws of the same seeds is printed beside them: it
    tells a tracker that re-acquires less from draws that happened to."""
    rates, poses = {}, {}
    for package in ("jax", "port", "port on jax draws"):
        runs = {s: seed_study_run(s, package) for s in STUDY_SEEDS}
        poses[package] = {s: p for s, (_, p) in runs.items()}
        runs = {s: bars for s, (bars, _) in runs.items()}
        rates[package] = [s for s, bars in runs.items() if all(bars.values())]
        print(f"seed study: {package} re-acquires on seeds {rates[package]} of {list(STUDY_SEEDS)}; {runs}")
    for s in STUDY_SEEDS:
        rot1, parted = where_runs_part(poses["jax"][s], poses["port on jax draws"][s])
        print(f"seed study: seed {s}, JAX and the port on its draws: {rot1:.4f} deg apart at frame 1, "
              f"part at frame {parted} (first frame beyond {PART_ROT_DEG} deg or {PART_TRANS_M} m)")
    assert len(rates["port"]) >= len(rates["jax"]) - 1, rates


# ---- tests/test_verification_e2e.py ------------------------------------------

H, W = 120, 160


@pytest.fixture(scope="module")
def seq12():
    return render_synthetic_sequence(num_frames=12, H=H, W=W, orbit_deg_per_frame=4.0)


def _verify_cfg(verify_dist_thresh: float) -> TrackerConfig:
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=8, use_verification=True, verify_dist_thresh=verify_dist_thresh,
                            dense_src_capacity=512),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=FrontendConfig(top_k=128),
        ransac=RansacConfig(max_iter=256),
        shapes=ShapeConfig(max_matches=64, image_h=H, image_w=W),
    )


def _run(cfg, seq, corrupt_frames=(), depth_scale=1.0):
    tracker = Tracker(cfg, H, W, device="cpu")
    init = np.linalg.inv(seq.ob_in_cam[0])
    statuses, errs = [], []
    for f in range(seq.gray.shape[0]):
        depth = seq.depth[f] * depth_scale if f in corrupt_frames else seq.depth[f]
        out = tracker.process_frame(seq.gray[f], depth, seq.mask[f], seq.K, init_pose=init)
        statuses.append(int(out.status))
        T = out.ob_in_cam.numpy()
        errs.append(float(np.linalg.norm(T[:3, 3] - seq.ob_in_cam[f][:3, 3])))
    return np.asarray(statuses), np.asarray(errs)


class TestVerificationRejectE2E:
    def test_reject_fires_and_reverts_cleanly(self, seq12):
        """A 5 mm threshold, below the keypoint noise floor, rejects every BA
        solve: every frame after the first reports NO_BA, none FAIL, and the
        reverted trajectory stays accurate."""
        statuses, errs = _run(_verify_cfg(verify_dist_thresh=0.005), seq12)
        assert (statuses[1:] == STATUS_NO_BA).all(), statuses.tolist()
        assert STATUS_FAIL not in statuses
        assert errs.max() < 0.01, errs.tolist()

    def test_default_threshold_not_trigger_happy(self, seq12):
        statuses, errs = _run(_verify_cfg(verify_dist_thresh=0.02), seq12)
        assert (statuses == STATUS_OK).all(), statuses.tolist()
        assert errs.max() < 0.01

    def test_corruption_flagged_then_recovers(self, seq12):
        statuses, errs = _run(_verify_cfg(verify_dist_thresh=0.02), seq12, corrupt_frames=(6, 7),
                              depth_scale=1.08)
        assert (statuses[6:8] != STATUS_OK).all(), statuses.tolist()
        assert (statuses[-3:] == STATUS_OK).all(), statuses.tolist()
        assert errs[-1] < 0.01, errs.tolist()
        assert (statuses[:6] == STATUS_OK).all()


# ---- the FAIL path against the JAX tracker -----------------------------------

TRAJ_TRANS_TOL, TRAJ_ROT_TOL = 1e-5, 1e-3  # m, deg: f32 summation order only
DROPPED = (4, 5)


def test_fail_path_matches_jax():
    """10 frames at 96x128 with a 2-frame dropout: the FAIL frames, the
    reinit gate and the recovery give JAX's statuses, and poses within
    1e-5 m and 1e-3 deg of JAX's."""
    h, w = 96, 128
    cfg = JTrackerConfig(
        bundle=JBundleConfig(max_ba_frames=4),
        keyframe=JKeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=JFrontendConfig(top_k=128),
        ransac=JRansacConfig(max_iter=256),
        feature_corres=JFeatureCorresConfig(backend="pallas_interpret"),
        shapes=JShapeConfig(max_matches=128, image_h=h, image_w=w),
    )
    seq = render_synthetic_sequence(num_frames=10, H=h, W=w, orbit_deg_per_frame=4.0)
    for f in DROPPED:
        seq.mask[f] = False
        seq.depth[f] = 0.0
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    jtrk = JaxTracker(cfg, h, w)
    ttrk = Tracker(load_config(dataclasses.asdict(cfg)), h, w, device="cpu")
    j_st, t_st = [], []
    for f in range(len(seq.gray)):
        phases = phases_from_key(jtrk.state.rng_key, cfg)
        jo = jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        to = ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases)
        j_st.append(int(jo.status))
        t_st.append(int(to.status))
        rot, trans = pose_errors(to.ob_in_cam.numpy(), np.asarray(jo.ob_in_cam))
        assert rot < TRAJ_ROT_TOL and trans < TRAJ_TRANS_TOL, (f, rot, trans)
    assert t_st == j_st
    assert set(DROPPED) <= {f for f, s in enumerate(t_st) if s == STATUS_FAIL}, t_st
    assert t_st[-1] == STATUS_OK, t_st
