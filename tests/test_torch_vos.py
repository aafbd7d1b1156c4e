"""The port's VOS mask propagation against the JAX package, on the CPU.

Same numpy inputs (fixed seeds) through bundletrack_tpu/models/vos.py and
bundletrack_tpu_torch/models/vos.py: the VOSNet forward on the shipped
width-96 weights, the attention, the reference selection and the ring, the
whole propagator over 8 frames; then the quality bars of
tests/test_vos_quality.py on the port alone, its run_vos CLI, and the
run_vos -> run_tracking -> eval_ycbineoat chain.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bundletrack_tpu.config import SegmentationConfig as JaxSegmentationConfig
from bundletrack_tpu.models import vos as jvos
from bundletrack_tpu_torch.apps import run_vos
from bundletrack_tpu_torch.apps.eval_ycbineoat import evaluate, load_model_points
from bundletrack_tpu_torch.apps.run_tracking import main as run_tracking
from bundletrack_tpu_torch.config import SegmentationConfig
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
from bundletrack_tpu_torch.data.native_io import read_png, write_png
from bundletrack_tpu_torch.eval.vos_eval import evaluate_vos, mask_iou
from bundletrack_tpu_torch.models import vos

torch.set_num_threads(2)

CKPT = "checkpoints/vos_params.npz"
FEAT_TOL = 1e-4  # VOSNet features: unit vectors from f32 convs summed in another order (measured 5e-7)
SOFT_TOL_BF16 = 1e-5  # soft labels when the features are bf16-representable: the products are exact
SOFT_TOL = 1e-3  # general unit features: bf16 rounding of the operands agrees, f32 sums do not
SAME_PIXELS_MIN = 0.995  # propagator masks identical on at least this share of pixels, every frame


@pytest.fixture(scope="module")
def shipped():
    jm, jp = jvos.load_vos_npz(CKPT)
    tm, _ = vos.load_vos_npz(CKPT)
    return jm, jp, tm


def _hwc(t):
    return t.permute(1, 2, 0).numpy()


def test_vosnet_forward_matches_jax(shipped):
    jm, jp, tm = shipped
    assert (tm.width, tm.out_dim) == (96, 256)  # read from the file, as load_vos_npz does
    img = np.random.RandomState(0).rand(1, 64, 80, 3).astype(np.float32)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        got = tm(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 8, 10, 256)
    np.testing.assert_allclose(got, want, atol=FEAT_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_state_dict_carry_over_of_random_flax_params():
    """A freshly initialised Flax VOSNet (another width, odd image size)
    carried over with vos_state_dict_from_flax gives the same features."""
    jm = jvos.VOSNet(out_dim=16, width=8)
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 36, 44, 3)))["params"]
    tm = vos.VOSNet(out_dim=16, width=8)
    tm.load_state_dict(vos.vos_state_dict_from_flax(_flatten(jp)))
    img = np.random.RandomState(1).rand(2, 36, 44, 3).astype(np.float32)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        got = tm(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_TOL)


def _flatten(tree, prefix=""):
    """Flax params -> {"a/b/kernel": numpy array}, the npz's naming."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("fault", ["wrong_key", "wrong_shape", "extra_key"])
def test_npz_loader_checks_names_and_shapes(tmp_path, fault):
    with np.load(CKPT) as d:
        data = {k: d[k] for k in d.files}
    if fault == "wrong_key":
        data["ResNetBlock_2/Conv_9/kernel"] = data.pop("ResNetBlock_2/Conv_0/kernel")
        err = KeyError
    elif fault == "wrong_shape":
        data["ResNetBlock_3/GroupNorm_1/scale"] = data["ResNetBlock_3/GroupNorm_1/scale"][:-8]
        err = ValueError
    else:
        data["Dense_0/kernel"] = np.zeros((3, 3), np.float16)
        err = ValueError
    path = str(tmp_path / "bad.npz")
    np.savez(path, **data)
    with pytest.raises(err, match="Conv_9|ResNetBlock_2/Conv_0|GroupNorm_1/scale|Dense_0"):
        vos.load_vos_npz(path)


def test_spatial_weight_diag_is_one_and_equals_jax():
    w = vos.spatial_weight(4, 5, sigma=3.0).numpy()
    np.testing.assert_allclose(np.diag(w), 1.0)
    assert w.shape == (20, 20) and (w <= 1.0 + 1e-6).all()
    np.testing.assert_array_equal(vos.spatial_weight(6, 8, 8.0).numpy(), np.asarray(jvos.spatial_weight(6, 8, 8.0)))


def _attention_inputs(seed, R=5, h=6, w=8, C=32, L=2, bf16=False):
    rng = np.random.RandomState(seed)

    def unit(shape):
        f = rng.randn(*shape).astype(np.float32)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        if bf16:  # round to bf16 so the product is exact on both sides
            f = np.asarray(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32))
        return f

    feats = unit((R, h, w, C))
    tgt = unit((h, w, C))
    labels = rng.dirichlet(np.ones(L), size=(R, h, w)).astype(np.float32)
    valid = np.array([True, True, False, True, True][:R])
    recent = np.array([True, True, True, False, False][:R])
    return feats, labels, valid, recent, tgt


def _both_propagate(feats, labels, valid, recent, tgt, temperature=0.05):
    h, w = tgt.shape[:2]
    want = np.asarray(jvos.propagate_labels(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(recent), jnp.asarray(tgt),
        jvos.spatial_weight(h, w, 1.5), jvos.spatial_weight(h, w, 3.0), temperature))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = vos.propagate_labels(
        t(feats.transpose(0, 3, 1, 2)), t(labels.transpose(0, 3, 1, 2)), t(valid), t(recent),
        t(tgt.transpose(2, 0, 1)), vos.spatial_weight(h, w, 1.5), vos.spatial_weight(h, w, 3.0), temperature)
    return _hwc(got), want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagate_labels_on_bf16_features(seed):
    got, want = _both_propagate(*_attention_inputs(seed, bf16=True))
    np.testing.assert_allclose(got, want, atol=SOFT_TOL_BF16)


@pytest.mark.parametrize("seed", [3, 4])
def test_propagate_labels_on_unit_features(seed):
    got, want = _both_propagate(*_attention_inputs(seed, C=64))
    np.testing.assert_allclose(got, want, atol=SOFT_TOL)
    # the argmax agrees except where the two labels are a near tie
    a, b = got.argmax(-1), want.argmax(-1)
    near_tie = np.abs(want[..., 0] - want[..., 1]) < 2 * SOFT_TOL
    assert np.all((a == b) | near_tie)


def test_identical_features_copy_labels():
    h, w, C, L, R = 6, 8, 16, 2, 3
    rng = np.random.RandomState(0)
    feat = rng.randn(C, h, w).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=0, keepdims=True)
    label = np.zeros((L, h, w), np.float32)
    label[0] = 1.0
    label[0, 2:4, 3:6] = 0.0
    label[1, 2:4, 3:6] = 1.0
    out = vos.propagate_labels(
        torch.from_numpy(np.stack([feat] * R)), torch.from_numpy(np.stack([label] * R)),
        torch.ones(R, dtype=torch.bool), torch.tensor([True, True, False]), torch.from_numpy(feat),
        vos.spatial_weight(h, w, 8.0), vos.spatial_weight(h, w, 21.0), temperature=0.01)
    np.testing.assert_array_equal(out.argmax(0).numpy(), label.argmax(0))


def _filled_rings(n, cap):
    j = jvos.init_vos_state(cap, 2, 2, 4, 2)
    t = vos.init_vos_state(cap, 2, 2, 4, 2, device="cpu")
    for i in range(n):
        j = jvos.vos_push(j, jnp.full((2, 2, 4), float(i)), jnp.zeros((2, 2, 2)), i)
        t = vos.vos_push(t, torch.full((4, 2, 2), float(i)), torch.zeros(2, 2, 2), i)
    return j, t


def test_dense_plus_sparse_selection():
    j, t = _filled_rings(12, 16)
    slots, valid, is_recent = vos.select_references(t, ref_num=9, dense_num=4, range_=40)
    js, jv, jr = jvos.select_references(j, ref_num=9, dense_num=4, range_=40)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(is_recent.numpy(), np.asarray(jr))
    assert bool(valid.all())
    ids = t.frame_ids.numpy()[slots.numpy()]
    np.testing.assert_array_equal(np.sort(ids[:4]), [8, 9, 10, 11])  # the four most recent frames
    assert is_recent[:4].all() and not is_recent[4:].any()
    assert t.count == 12 and isinstance(t.count, int)  # the count stays on the host
    np.testing.assert_array_equal(t.feats[:, 0, 0, 0].numpy(), np.asarray(j.feats[:, 0, 0, 0]))


@pytest.mark.parametrize("n,cap", [(3, 16), (20, 16), (61, 48)])
def test_ring_wraps_like_jax(n, cap):
    j, t = _filled_rings(n, cap)
    np.testing.assert_array_equal(t.frame_ids.numpy(), np.asarray(j.frame_ids))
    for ref in ((9, 4, 40), (5, 4, 20), (12, 4, 33)):
        s, v, r = vos.select_references(t, *ref)
        js, jv, jr = jvos.select_references(j, ref[0], dense_num=ref[1], range_=ref[2])
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_long_range_widens_sparse_window():
    cfg = SegmentationConfig().long_range(110)
    assert cfg == SegmentationConfig(**vars(JaxSegmentationConfig().long_range(110)))
    assert cfg.range_ == 100 and cfg.history_cap >= cfg.range_
    state = vos.init_vos_state(cfg.history_cap, 2, 2, 4, 2, device="cpu")
    for i in range(110):
        state = vos.vos_push(state, torch.zeros(4, 2, 2), torch.zeros(2, 2, 2), i)
    slots, valid, _ = vos.select_references(state, ref_num=cfg.ref_num, dense_num=4, range_=cfg.range_)
    assert bool(valid.all())
    ages = 110 - state.frame_ids.numpy()[slots.numpy()]
    assert ages.max() >= 95, ages  # the oldest sparse ref sits at the far end of the widened window
    short = SegmentationConfig().long_range(30)
    assert short.range_ == SegmentationConfig().range_ and short.history_cap == SegmentationConfig().history_cap


def test_propagator_reads_cap_from_config():
    cfg = SegmentationConfig().long_range(110)
    model, _ = vos.init_vos(out_dim=8, width=8)
    prop = vos.VOSPropagator(model, cfg, 32, 32, device="cpu")
    assert prop.state.feats.shape[0] == cfg.history_cap


def test_online_mask_tracking_with_the_jax_initial_weights():
    """tests/test_vos.py's moving square, with the JAX package's random
    initial weights carried over: the same bars, and the same masks."""
    cfg = dict(downscale=8, ref_num=5, sigma1=1.2, sigma2=2.5, temperature=0.05)
    H = W = 64
    jm = jvos.VOSNet(out_dim=32, width=8)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    tm = vos.VOSNet(out_dim=32, width=8)
    tm.load_state_dict(vos.vos_state_dict_from_flax(_flatten(jp)))
    rng = np.random.RandomState(0)

    def frame(cx):
        img = np.zeros((H, W, 3), np.float32) + 0.1
        img[24:40, cx:cx + 16] = 0.9
        img += 0.02 * rng.randn(H, W, 3).astype(np.float32)
        mask = np.zeros((H, W), bool)
        mask[24:40, cx:cx + 16] = True
        return img, mask

    jprop = jvos.VOSPropagator(jp, jm, JaxSegmentationConfig(**cfg), H, W)
    prop = vos.VOSPropagator(tm, SegmentationConfig(**cfg), H, W, device="cpu")
    img0, mask0 = frame(8)
    jprop.first_frame(img0, mask0)
    prop.first_frame(img0, mask0)
    ious = []
    for cx in (10, 12):
        img, gt = frame(cx)
        pred = prop.propagate(img)
        np.testing.assert_array_equal(pred, jprop.propagate(img))
        ious.append(mask_iou(pred, gt))
    assert ious[0] > 0.4 and ious[1] > 0.2, ious


def test_propagator_matches_jax_on_the_shipped_weights(shipped):
    """8 frames at 96x128: masks identical on >= 99.5 % of pixels in every
    frame (measured: all of them; soft labels within 1e-5)."""
    jm, jp, tm = shipped
    H, W = 96, 128
    seq = render_synthetic_sequence(num_frames=8, H=H, W=W, orbit_deg_per_frame=3.0)
    rgb = lambda f: np.repeat(seq.gray[f][..., None], 3, axis=-1)  # noqa: E731
    jprop = jvos.VOSPropagator(jp, jm, JaxSegmentationConfig(), H, W)
    prop = vos.VOSPropagator(tm, SegmentationConfig(), H, W, device="cpu")
    jprop.first_frame(rgb(0), seq.mask[0])
    prop.first_frame(rgb(0), seq.mask[0])
    np.testing.assert_array_equal(_hwc(prop._anchor_label), np.asarray(jprop._anchor_label))
    np.testing.assert_allclose(_hwc(prop._anchor_feat), np.asarray(jprop._anchor_feat), atol=FEAT_TOL)
    for f in range(1, 8):
        got, want = prop.propagate(rgb(f)), jprop.propagate(rgb(f))
        assert got.shape == (H, W) and got.dtype == bool
        same = float((got == want).mean())
        assert same >= SAME_PIXELS_MIN, (f, same)
        np.testing.assert_allclose(_hwc(prop.state.labels[f]), np.asarray(jprop.state.labels[f]), atol=SOFT_TOL)


def test_nearest_downsampling_uses_the_jax_index_rule():
    """jax.image.resize 'nearest' reads floor((i + 0.5) * in / out):
    rows 4 and 12 of 16 for 2 outputs, where F.interpolate reads 0 and 8."""
    np.testing.assert_array_equal(vos._nearest_index(16, 2), [4, 12])
    x = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (5, 3), "nearest"))
    np.testing.assert_array_equal(x[vos._nearest_index(37, 5)], want)


def test_evaluate_vos_seeds_and_scores_with_mask_gt():
    model, _ = vos.init_vos(out_dim=16, width=8)
    seq = render_synthetic_sequence(num_frames=3, H=32, W=32)

    class Hard:  # a degraded mask beside the exact silhouette, as the hard renderer gives
        gray = seq.gray
        mask = np.zeros_like(seq.mask)
        mask_gt = seq.mask

    r = evaluate_vos(model, SegmentationConfig(), Hard, device="cpu")
    prop = vos.VOSPropagator(model, SegmentationConfig(), 32, 32, device="cpu")
    rgb = lambda f: np.repeat(seq.gray[f][..., None], 3, axis=-1)  # noqa: E731
    prop.first_frame(rgb(0), seq.mask[0])
    want = [mask_iou(prop.propagate(rgb(f)), seq.mask[f]) for f in (1, 2)]
    assert r["per_frame"] == want and r["min_iou"] == min(want)
    with pytest.raises(ValueError, match=">= 2 frames"):
        evaluate_vos(model, SegmentationConfig(), seq, num_frames=1, device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    model, _ = vos.init_vos(out_dim=8, width=8)
    if torch.cuda.is_available():
        assert vos.VOSPropagator(model, SegmentationConfig(), 32, 32).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vos.VOSPropagator(model, SegmentationConfig(), 32, 32)
    img_dir, init = _write_frames(tmp_path, render_synthetic_sequence(num_frames=2, H=32, W=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_vos.main(["--img_dir", img_dir, "--init_mask_file", init, "--mask_save_dir", str(tmp_path / "m")])


# ---- the quality bars of tests/test_vos_quality.py, on the port alone --------


@pytest.fixture(scope="module")
def shipped_port(shipped):
    return shipped[2]


def test_propagation_iou(shipped_port):
    seq = render_synthetic_sequence(num_frames=32, H=96, W=96, seed=999, orbit_deg_per_frame=4.0)
    r = evaluate_vos(shipped_port, SegmentationConfig(), seq, device="cpu")
    assert r["mean_iou"] >= 0.8 and r["min_iou"] >= 0.6, r


def test_long_horizon_hard_world(shipped_port):
    from bundletrack_tpu.data import render_hard_sequence  # the input generator only

    seq = render_hard_sequence("lshape", num_frames=110, H=96, W=96, seed=777, orbit_deg_per_frame=3.0,
                               depth_noise=0.0, depth_quant=0.0, hole_fraction=0.0, mask_errors=False,
                               background=True)
    r = evaluate_vos(shipped_port, SegmentationConfig(), seq, device="cpu")
    assert len(r["per_frame"]) == 109
    assert r["mean_iou"] >= 0.75 and r["min_iou"] >= 0.55, r


def test_occluder_clip_no_bleed(shipped_port):
    from bundletrack_tpu.data import render_hard_sequence

    seq = render_hard_sequence("cube", num_frames=48, H=96, W=96, seed=778, orbit_deg_per_frame=3.0,
                               depth_noise=0.0, depth_quant=0.0, hole_fraction=0.0, mask_errors=False,
                               background=True, occluder=True)
    r = evaluate_vos(shipped_port, SegmentationConfig(), seq, device="cpu")
    assert r["mean_iou"] >= 0.7, r
    assert np.mean(r["per_frame"][-10:]) >= 0.75, r


# ---- the run_vos CLI and the run_vos -> run_tracking chain -------------------


def _write_frames(root, seq):
    img_dir = os.path.join(str(root), "rgb")
    os.makedirs(img_dir)
    for i in range(len(seq.gray)):
        write_png(os.path.join(img_dir, f"{i:04d}.png"), (np.stack([seq.gray[i]] * 3, -1) * 255).astype(np.uint8))
    init = os.path.join(str(root), "init.png")
    write_png(init, seq.mask[0].astype(np.uint8) * 255)
    return img_dir, init


@pytest.mark.parametrize("weights", ["shipped", "untrained"])
def test_run_vos_cli(tmp_path, monkeypatch, capsys, weights):
    seq = render_synthetic_sequence(num_frames=3, H=64, W=64, orbit_deg_per_frame=2.0)
    img_dir, init = _write_frames(tmp_path, seq)
    if weights == "untrained":
        monkeypatch.setattr(run_vos, "VOS_CKPT", str(tmp_path / "absent.npz"))
    out_dir = tmp_path / "masks"
    prop = run_vos.main(["--img_dir", img_dir, "--init_mask_file", init, "--mask_save_dir", str(out_dir),
                         "--device", "cpu"])
    err = capsys.readouterr().err
    assert ("width=96" in err) if weights == "shipped" else ("untrained weights" in err)
    assert prop.model.width == (96 if weights == "shipped" else 32)
    assert sorted(os.listdir(out_dir)) == ["0000.png", "0001.png", "0002.png"]
    np.testing.assert_array_equal(read_png(str(out_dir / "0000.png")) > 0, seq.mask[0])  # written unchanged
    for name in ("0001.png", "0002.png"):
        m = read_png(str(out_dir / name))
        assert m.shape == (64, 64) and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255}


def test_run_vos_refuses_an_orbax_directory(tmp_path):
    seq = render_synthetic_sequence(num_frames=2, H=32, W=32)
    img_dir, init = _write_frames(tmp_path, seq)
    ckpt_dir = tmp_path / "params"
    ckpt_dir.mkdir()
    # a directory without the port's state.npz (an orbax one) cannot be read here
    with pytest.raises(ValueError, match="orbax checkpoint .* is unreadable here"):
        run_vos.main(["--img_dir", img_dir, "--init_mask_file", init, "--mask_save_dir", str(tmp_path / "m"),
                      "--checkpoint", str(ckpt_dir), "--device", "cpu"])


def test_vos_masks_drive_tracker(tmp_path):
    """run_vos masks (from one init mask) feed run_tracking; the pose holds
    (tests/test_vos_quality.py::test_vos_masks_drive_tracker's bars, on the
    reduced tracker configuration of tests/test_e2e_parity.py)."""
    seq = render_synthetic_sequence(num_frames=12, H=96, W=128, orbit_deg_per_frame=3.0, seed=77)
    data_dir = export_ycbineoat_sequence(seq, str(tmp_path / "seq"))
    vos_mask_dir = str(tmp_path / "vos_masks")
    run_vos.main(["--img_dir", os.path.join(data_dir, "rgb"),
                  "--init_mask_file", os.path.join(data_dir, "masks", "00000.png"),
                  "--mask_save_dir", vos_mask_dir, "--checkpoint", CKPT, "--device", "cpu"])
    assert len(os.listdir(vos_mask_dir)) == 12
    ious = [mask_iou(read_png(os.path.join(vos_mask_dir, f"{f:05d}.png")) > 0, seq.mask[f]) for f in range(12)]
    assert min(ious) > 0.7, ious

    out_dir = str(tmp_path / "out")
    cfg_yaml = str(tmp_path / "config.yml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump({"data_dir": data_dir, "mask_dir": vos_mask_dir, "debug_dir": out_dir, "LOG": 0,
                        "bundle": {"max_BA_frames": 8, "dense_src_capacity": 512}, "keyframe": {"pool_size": 8},
                        "frontend": {"top_k": 256}, "ransac": {"max_iter": 512}, "shapes": {"max_matches": 128}}, f)
    run_tracking([cfg_yaml, "--dataset", "ycbineoat", "--device", "cpu"])
    res = evaluate(os.path.join(out_dir, "poses"), os.path.join(data_dir, "annotated_poses"),
                   load_model_points(os.path.join(data_dir, "model", "points.xyz")))
    assert res["missing"] == 0
    assert res["ADDS_AUC"] > 85.0, res
