"""LF-Net in the fleet: the per-stream ROI ops, the batched forward, and the
LF-Net fleet step against the JAX fleet; and the PCG backend in a fleet.

The JAX fleet vmaps its whole tracker step, LF-Net included, over the
streams (its BA matcher in Pallas interpret mode, so its gate is the
port's exact-f32 gate).  The port crops every stream's ROI in one batched
resample and runs one LF-Net forward on the [S, side, side, 1] stack.  The
port takes the RANSAC phases that jax.random draws from each stream's key.
One JAX compile per fleet configuration, shared by the file through module
fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import (
    BundleConfig,
    FeatureCorresConfig,
    FrontendConfig as JaxFrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig,
)
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.frontend.lfnet import load_params_npz as jax_load_params_npz
from bundletrack_tpu.frontend.lfnet import make_lfnet_apply as jax_make_lfnet_apply
from bundletrack_tpu.ops import masks as jmasks
from bundletrack_tpu.ops import resize as jresize
from bundletrack_tpu.parallel import init_fleet_state as j_init_fleet_state
from bundletrack_tpu.parallel import make_fleet_step as j_make_fleet_step
from bundletrack_tpu.tracker.state import FrameObservation as JaxObservation
from bundletrack_tpu_torch.config import FrontendConfig, load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.frontend import lfnet
from bundletrack_tpu_torch.ops import masks, resize
from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
from bundletrack_tpu_torch.tracker.driver import Tracker
from jax_draws import phases_from_key

torch.set_num_threads(2)

CKPT = "checkpoints/lfnet_params.npz"
S, H, W, F = 3, 120, 160, 4
OPS_TOL = 1e-5  # the resample's f32 products, batched against one at a time and against JAX
# batched f32 forward against one forward per crop: the convolutions and
# GroupNorm sums block differently with the batch, and the soft NMS's
# exp(100 * logit gap) turns ~1e-7 logit differences into ~1e-5 relative
# score differences (measured 1.3e-5 here); the f32 bars of
# tests/test_torch_lfnet.py, which hold the forward to JAX's
FWD_KPT_TOL, FWD_DESC_TOL, FWD_SCORE_TOL = 1e-3, 1e-4, 5e-4
# the LF-Net fleet against the JAX LF-Net fleet, per stream and frame: the
# bars of tests/test_torch_apps.py::test_lfnet_trajectory_matches_jax
SEQ_TRANS_TOL, SEQ_ROT_TOL = 1e-4, 0.05  # m, deg
COUNT_TOL = 2  # inlier / edge counts: a residual at a threshold may flip
# LF-Net on a 96-px crop of a 120x160 frame tracks to 1.5 deg and 0.7 mm at
# worst (tests/test_torch_apps.py); the same bars against the truth
GT_TRANS_TOL, GT_ROT_TOL = 0.005, 2.0
# a fleet stream against a single-stream Tracker on the same frames and
# phases: the batched forward and products may sum in another order
STREAM_VS_SINGLE_TOL = 1e-5  # max |pose entry difference|


def jax_cfg(**bundle):
    """tests/test_torch_apps.py's LF-Net tracker configuration: shipped
    weights at input_size 96, top_k 128, f32; the matcher in interpret mode."""
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4, **bundle),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=JaxFrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False),
        ransac=RansacConfig(max_iter=256),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )


def frame_arrays(seqs, f):
    return (np.stack([s.gray[f] for s in seqs]), np.stack([s.depth[f] for s in seqs]),
            np.stack([s.mask[f] for s in seqs]), np.stack([s.K for s in seqs]))


def init_poses(seqs):
    return np.stack([np.linalg.inv(s.ob_in_cam[0]) for s in seqs]).astype(np.float32)


def run_jax_fleet(cfg, seqs, lfnet_apply=None):
    """The JAX fleet over the streams: the phases each frame draws and the
    outputs, as numpy."""
    h, w = seqs[0].gray.shape[1:]
    step = j_make_fleet_step(cfg, h, w, lfnet_apply=lfnet_apply)
    state = j_init_fleet_state(cfg, h, w, len(seqs))
    ip = jnp.asarray(init_poses(seqs))
    phases, outs = [], []
    for f in range(F):
        per_stream = [phases_from_key(k, cfg) for k in np.asarray(state.rng_key)]
        phases.append(tuple(torch.from_numpy(np.stack(p)) for p in zip(*per_stream)))
        obs = JaxObservation(*(jnp.asarray(a) for a in frame_arrays(seqs, f)))
        state, out = step(state, obs, ip)
        outs.append(jax.tree.map(np.array, out))
    return phases, outs


def run_port_fleet(cfg, seqs, phases, lfnet_apply=None):
    h, w = seqs[0].gray.shape[1:]
    step = make_fleet_step(cfg, h, w, lfnet_apply=lfnet_apply)
    state = init_fleet_state(cfg, h, w, len(seqs), device="cpu")
    ip = torch.from_numpy(init_poses(seqs))
    outs = []
    for f in range(F):
        state, out = step(state, fleet_observation(*frame_arrays(seqs, f), "cpu"), ip, phases[f])
        outs.append(out)
    return outs


def assert_fleets_agree(seqs, port, ref, rot_tol, trans_tol):
    for f in range(F):
        np.testing.assert_array_equal(port[f].status.numpy(), ref[f].status)
        assert not ref[f].status.any(), (f, ref[f].status)
        for s in range(len(seqs)):
            rot, trans = pose_errors(port[f].ob_in_cam[s].numpy(), ref[f].ob_in_cam[s])
            assert rot < rot_tol and trans < trans_tol, (f, s, rot, trans)
            assert abs(int(port[f].num_matches[s]) - int(ref[f].num_matches[s])) <= COUNT_TOL
            assert abs(int(port[f].num_ba_edges[s]) - int(ref[f].num_ba_edges[s])) <= COUNT_TOL
            rot, trans = pose_errors(port[f].ob_in_cam[s].numpy(), seqs[s].ob_in_cam[f])
            assert rot < GT_ROT_TOL and trans < GT_TRANS_TOL, (f, s, rot, trans)


@pytest.fixture(scope="module")
def sequences():
    return [render_synthetic_sequence(num_frames=F, H=H, W=W, seed=s, orbit_deg_per_frame=4.0) for s in range(S)]


# ---- per-stream ROI ops ----------------------------------------------------


@pytest.fixture(scope="module")
def stream_masks(sequences):
    """The streams' frame-1 masks and images, plus one empty mask (its ROI
    is the whole image)."""
    m = np.stack([s.mask[1] for s in sequences] + [np.zeros((H, W), bool)])
    g = np.stack([s.gray[1] for s in sequences] + [sequences[0].gray[1]]).astype(np.float32) / 255.0
    return m, g


def test_mask_roi_per_stream(stream_masks):
    m, _ = stream_masks
    got = masks.mask_roi(torch.from_numpy(m))
    assert all(t.shape == (len(m),) for t in got)
    for s in range(len(m)):
        one = masks.mask_roi(torch.from_numpy(m[s]))
        ref = jmasks.mask_roi(jnp.asarray(m[s]))
        for g, o, r in zip(got, one, ref):
            assert o.dim() == 0 and o.dtype == g.dtype
            assert g[s].item() == o.item() == r.item(), s
    assert got[4][-1].item() is False and (got[0][-1].item(), got[1][-1].item()) == (0, W - 1)


def test_crop_resize_square_per_stream(stream_masks):
    """One batched crop equals the single-image crops stream by stream, and
    JAX's, on each stream's own box."""
    m, g = stream_masks
    mt, gt = torch.from_numpy(m), torch.from_numpy(g)
    img = torch.where(mt, gt, torch.zeros_like(gt))
    roi = masks.mask_roi(mt)[:4]
    out, scale, ou, ov = resize.crop_resize_square(img, roi, 96)
    assert out.shape == (len(m), 96, 96) and scale.shape == (len(m),)
    for s in range(len(m)):
        o1, s1, u1, v1 = resize.crop_resize_square(img[s], tuple(r[s] for r in roi), 96)
        np.testing.assert_allclose(out[s].numpy(), o1.numpy(), atol=OPS_TOL)
        assert (scale[s].item(), ou[s].item(), ov[s].item()) == (s1.item(), u1.item(), v1.item())
        jroi = jmasks.mask_roi(jnp.asarray(m[s]))[:4]
        jo, js, _, _ = jresize.crop_resize_square(jnp.where(jnp.asarray(m[s]), jnp.asarray(g[s]), 0.0), jroi, 96)
        np.testing.assert_allclose(out[s].numpy(), np.asarray(jo), atol=OPS_TOL)
        np.testing.assert_allclose(scale[s].item(), float(js), rtol=1e-6)


def test_keypoints_to_original_per_stream(stream_masks):
    m, _ = stream_masks
    _, scale, ou, ov = resize.crop_resize_square(torch.zeros(len(m), H, W), masks.mask_roi(torch.from_numpy(m))[:4], 96)
    kp = torch.from_numpy((np.random.RandomState(0).rand(len(m), 10, 2) * 96).astype(np.float32))
    got = resize.keypoints_to_original(kp, scale, ou, ov)
    for s in range(len(m)):
        np.testing.assert_array_equal(got[s].numpy(), resize.keypoints_to_original(kp[s], scale[s], ou[s], ov[s]).numpy())
        ref = jresize.keypoints_to_original(jnp.asarray(kp[s].numpy()), float(scale[s]), float(ou[s]), float(ov[s]))
        np.testing.assert_allclose(got[s].numpy(), np.asarray(ref), atol=OPS_TOL)


def test_lfnet_forward_batched_equals_single_crops(stream_masks):
    """LFNetApply on [S, side, side, 1]: one forward, each stream's output
    equal to a forward on its crop alone (seeded weights, f32)."""
    m, g = stream_masks
    fcfg = FrontendConfig(kind="lfnet", input_size=64, top_k=32, desc_dim=64, bf16=False)
    _, params = lfnet.init_lfnet(fcfg, seed=1)
    apply = lfnet.make_lfnet_apply(fcfg, params)
    mt, gt = torch.from_numpy(m), torch.from_numpy(g)
    crops = resize.crop_resize_square(torch.where(mt, gt, torch.zeros_like(gt)), masks.mask_roi(mt)[:4], 64)[0]
    batched = apply(crops[..., None])
    assert batched.desc.shape == (len(m), 32, 64) and batched.kpts_uv.shape == (len(m), 32, 2)
    for s in range(len(m)):
        one = apply(crops[s, ..., None])
        np.testing.assert_array_equal(batched.valid[s].numpy(), one.valid.numpy())
        np.testing.assert_allclose(batched.kpts_uv[s].numpy(), one.kpts_uv.numpy(), atol=FWD_KPT_TOL)
        np.testing.assert_allclose(batched.desc[s].numpy(), one.desc.numpy(), atol=FWD_DESC_TOL)
        np.testing.assert_allclose(batched.scores[s].numpy(), one.scores.numpy(), atol=FWD_SCORE_TOL)


# ---- the LF-Net fleet step -----------------------------------------------------


def port_lfnet():
    pcfg = load_config(dataclasses.asdict(jax_cfg()))
    _, params = lfnet.load_params_npz(CKPT, pcfg.frontend)
    return pcfg, lfnet.make_lfnet_apply(pcfg.frontend, params)


@pytest.fixture(scope="module")
def jax_lfnet_fleet(sequences):
    cfg = jax_cfg()
    _, jparams = jax_load_params_npz(CKPT, cfg.frontend)
    return run_jax_fleet(cfg, sequences, jax_make_lfnet_apply(cfg.frontend, jparams))


@pytest.fixture(scope="module")
def port_lfnet_fleet(sequences, jax_lfnet_fleet):
    pcfg, apply = port_lfnet()
    return run_port_fleet(pcfg, sequences, jax_lfnet_fleet[0], apply)


def test_lfnet_fleet_matches_the_jax_fleet(sequences, jax_lfnet_fleet, port_lfnet_fleet):
    assert_fleets_agree(sequences, port_lfnet_fleet, jax_lfnet_fleet[1], SEQ_ROT_TOL, SEQ_TRANS_TOL)


def test_lfnet_fleet_streams_equal_single_stream_trackers(sequences, jax_lfnet_fleet, port_lfnet_fleet):
    """Stream s of the LF-Net fleet against an LF-Net Tracker on sequence s
    with the same phases."""
    phases = jax_lfnet_fleet[0]
    pcfg, apply = port_lfnet()
    for s in range(S):
        trk = Tracker(pcfg, H, W, lfnet_apply=apply, device="cpu")
        seq = sequences[s]
        for f in range(F):
            out = trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_poses([seq])[0],
                                    phases=tuple(p[s] for p in phases[f]))
            assert int(out.status) == int(port_lfnet_fleet[f].status[s])
            diff = float((out.ob_in_cam - port_lfnet_fleet[f].ob_in_cam[s]).abs().max())
            assert diff <= STREAM_VS_SINGLE_TOL, (s, f, diff)


# ---- PCG in the fleet ----------------------------------------------------------


def test_pcg_fleet_matches_the_jax_fleet():
    """Two classical streams with solver_backend="pcg" at 96x128 (the
    configuration of tests/test_torch_fleet.py) against the JAX fleet."""
    cfg = TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4, num_iter_outer=3, solver_backend="pcg"),
        keyframe=KeyframeConfig(pool_size=4, min_rot=5.0),
        frontend=JaxFrontendConfig(top_k=64),
        ransac=RansacConfig(max_iter=128),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=64, image_h=96, image_w=128),
    )
    seqs = [render_synthetic_sequence(num_frames=F, H=96, W=128, seed=s, orbit_deg_per_frame=3.0) for s in range(2)]
    phases, ref = run_jax_fleet(cfg, seqs)
    port = run_port_fleet(load_config(dataclasses.asdict(cfg)), seqs, phases)
    assert_fleets_agree(seqs, port, ref, 0.01, 1e-4)  # tests/test_torch_fleet.py's bars
