"""The port's LF-Net frontend against the JAX package's, on the CPU.

The same numpy inputs go through each JAX function and its port; arrays are
passed NHWC to JAX and NCHW to the port.  The LF-Net forward runs on the
shipped checkpoint at input_size=96, top_k=64, on masked ROI crops of a
rendered sequence.  In bf16 the JAX side runs jitted, as every JAX path
runs it (the tracker step, the frontend evaluation): XLA moves the Flax
module's rounding points and sums the norms' statistics in its own order,
and the port computes that function (frontend/lfnet.py).
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import FrontendConfig as JaxFrontendConfig
from bundletrack_tpu.frontend import detector_ops as jops
from bundletrack_tpu.frontend.lfnet import SimpleDesc as JaxSimpleDesc
from bundletrack_tpu.frontend.lfnet import load_params_npz as jax_load_params_npz
from bundletrack_tpu.ops import masks as jmasks
from bundletrack_tpu.ops import resize as jresize
from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.frontend import detector_ops as ops
from bundletrack_tpu_torch.frontend import lfnet
from bundletrack_tpu_torch.ops import resize

torch.set_num_threads(2)

CKPT = "checkpoints/lfnet_params.npz"
OPS_TOL = 1e-5  # detector ops and resizes: f32, same arithmetic, other summation order
F32_DESC_TOL = 1e-4
# f32 forward scores: exp(100 * logit gap) turns the logits' ~1e-6 f32
# differences into ~1e-4 relative (measured 1.0e-4 on the crops below)
F32_SCORE_TOL = 5e-4
# bf16 forward against the jitted JAX forward, measured on the 8 crops
# below: 160 of 161 keypoints identical (99.4 %), per-keypoint descriptor
# max |diff| 0.0013, median 1.5e-8; at input 192 on 6 crops 739 of 745
# (99.2 %), median 2.5e-4.  What is left: the convolutions' f32 sums in
# another order (a bf16 rounding flips now and then) and XLA's approximate
# rsqrt.
BF16_MIN_SAME_KPTS = 0.97
BF16_DESC_MAX, BF16_DESC_MEDIAN = 0.05, 2e-3

rng = np.random.RandomState(0)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---- detector ops -----------------------------------------------------------


def test_instance_norm():
    x = rng.rand(2, 12, 10, 3).astype(np.float32) * 5 + 3
    np.testing.assert_allclose(nhwc(ops.instance_norm(nchw(x))), np.asarray(jops.instance_norm(x)), atol=OPS_TOL)


@pytest.mark.parametrize("ksize,com", [(5, 1.0), (15, 100.0)])
def test_soft_nms_3d(ksize, com):
    x = (rng.randn(2, 20, 24, 5) * 0.5).astype(np.float32)
    got = nhwc(ops.soft_nms_3d(nchw(x), ksize, com))
    np.testing.assert_allclose(got, np.asarray(jops.soft_nms_3d(jnp.asarray(x), ksize, com)), atol=OPS_TOL)


def test_soft_max_and_argmax_1d():
    x = rng.rand(2, 9, 11, 5).astype(np.float32)
    values = np.exp(np.linspace(np.log(2.0), np.log(0.5), 5)).astype(np.float32)
    jm, ja = jops.soft_max_and_argmax_1d(jnp.asarray(x), jnp.asarray(values), com1=100.0, com2=100.0)
    tm, ta = ops.soft_max_and_argmax_1d(nchw(x), torch.from_numpy(values), dim=1, com1=100.0, com2=100.0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=OPS_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=OPS_TOL)


def _plateau_map(H=16, W=20):
    """Scores with plateaus (equal neighbours), exact zeros and negatives."""
    x = np.round(rng.rand(2, H, W, 1) * 4).astype(np.float32) / 4 - 0.25
    x[0, 2:5, 3:6, 0] = 2.0  # a 3x3 plateau: every pixel of it is a local max
    x[1, H // 2, 1:4, 0] = 1.5
    return x


@pytest.mark.parametrize("thresh,ksize", [(0.0, 5), (0.3, 5), (0.0, 3)])
def test_nms_mask_passes_plateaus(thresh, ksize):
    x = _plateau_map()
    got = nhwc(ops.non_max_suppression_mask(nchw(x), thresh, ksize))
    want = np.asarray(jops.non_max_suppression_mask(jnp.asarray(x), thresh, ksize))
    np.testing.assert_array_equal(got, want)
    assert got[0, 2:5, 3:6, 0].all()


@pytest.mark.parametrize("H,W,radius", [(16, 20, 3), (9, 7, 0), (12, 12, 6)])
def test_end_of_frame_mask(H, W, radius):
    got = nhwc(ops.end_of_frame_mask(H, W, radius))
    np.testing.assert_array_equal(got, np.asarray(jops.end_of_frame_mask(H, W, radius)))


@pytest.mark.parametrize("H,W,k", [(16, 20, 8), (16, 20, 20), (10, 14, 12), (8, 8, 5)],
                         ids=["bucketed", "bucketed-all-cells", "unbucketed-shape", "unbucketed-k"])
def test_top_k_keypoints_tie_order(H, W, k):
    """Plateaus tie inside a cell (first pixel wins) and across cells (lower
    cell first); the zeros past the last positive score tie too."""
    x = np.clip(_plateau_map(H, W), 0.0, None)
    jk, js, jv = (np.asarray(a) for a in jops.top_k_keypoints(jnp.asarray(x), k))
    tk, ts, tv = ops.top_k_keypoints(nchw(x), k)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("do_softmax,com", [(True, 10.0), (True, 1.0), (False, 1.0)])
def test_soft_argmax_2d(do_softmax, com):
    x = rng.randn(6, 9, 9, 1).astype(np.float32)
    if not do_softmax:
        x = np.abs(x) / np.abs(x).sum(axis=(1, 2), keepdims=True)
    got = ops.soft_argmax_2d(nchw(x), do_softmax, com).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.soft_argmax_2d(jnp.asarray(x), do_softmax, com)), atol=OPS_TOL)


@pytest.mark.parametrize("with_scale,with_ori", [(False, False), (True, False), (True, True)])
def test_transformer_crop(with_scale, with_ori):
    images = rng.rand(2, 20, 24, 3).astype(np.float32)
    # keypoints inside, on the border and outside the image
    kpts = np.array([[5, 5], [0, 0], [23, 19], [12.3, 7.7], [-3, 10], [30, 25], [11, 18.5]], np.float32)
    batch = np.array([0, 1, 0, 1, 0, 1, 1], np.int32)
    scale = rng.uniform(0.5, 2.0, len(kpts)).astype(np.float32) if with_scale else None
    ori = None
    if with_ori:
        a = rng.uniform(-np.pi, np.pi, len(kpts))
        ori = np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)
    want = jops.transformer_crop(jnp.asarray(images), 8, jnp.asarray(batch), jnp.asarray(kpts),
                                 None if scale is None else jnp.asarray(scale),
                                 None if ori is None else jnp.asarray(ori))
    got = ops.transformer_crop(nchw(images), 8, torch.from_numpy(batch), torch.from_numpy(kpts),
                               None if scale is None else torch.from_numpy(scale),
                               None if ori is None else torch.from_numpy(ori))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=OPS_TOL)


# ---- resizes ----------------------------------------------------------------


@pytest.mark.parametrize("in_hw,out_hw", [
    ((40, 30), (96, 96)),  # upscale
    ((96, 96), (48, 48)),  # downscale by 2, antialiased
    ((136, 136), (96, 96)),  # downscale by a non-integer factor
    ((60, 90), (30, 120)),  # one axis down, one up
    ((20, 24), (40, 24)),  # one axis unchanged
])
def test_resize_bilinear(in_hw, out_hw):
    x = rng.rand(*in_hw, 3).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw))
    got = resize.resize_bilinear(torch.from_numpy(x).permute(2, 0, 1), out_hw).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=OPS_TOL)


@pytest.mark.parametrize("roi,out_size", [
    ((10, 70, 5, 50), 96),  # upscale
    ((0, 159, 0, 119), 40),  # downscale, antialiased
    ((30, 40, 60, 100), 40),  # tall ROI, padded to square
    ((3, 150, 7, 9), 96),  # wide ROI reaching past the image bottom once squared
])
def test_crop_resize_square(roi, out_size):
    img = rng.rand(120, 160).astype(np.float32)
    jout, jscale, jou, jov = jresize.crop_resize_square(jnp.asarray(img), tuple(jnp.int32(v) for v in roi), out_size)
    tout, tscale, tou, tov = resize.crop_resize_square(
        torch.from_numpy(img), tuple(torch.tensor(v, dtype=torch.int32) for v in roi), out_size)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=OPS_TOL)
    np.testing.assert_allclose(float(tscale), float(jscale), rtol=1e-6)
    assert (float(tou), float(tov)) == (float(jou), float(jov))
    kp = (rng.rand(10, 2) * out_size).astype(np.float32)
    np.testing.assert_allclose(
        resize.keypoints_to_original(torch.from_numpy(kp), tscale, tou, tov).numpy(),
        np.asarray(jresize.keypoints_to_original(jnp.asarray(kp), jscale, jou, jov)), atol=OPS_TOL)


# ---- parameters and layers ---------------------------------------------------


def _jax_flat_params(cfg=JaxFrontendConfig(kind="lfnet")):
    _, params = jax_load_params_npz(CKPT, cfg)
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}


def test_npz_loader_carries_every_shipped_param():
    flat = _jax_flat_params()
    model, sd = lfnet.load_params_npz(CKPT, FrontendConfig(kind="lfnet"))
    assert len(sd) == len(flat) == 58
    got = model.state_dict()
    np.testing.assert_array_equal(got["detector.init_conv.weight"].numpy(),
                                  flat["detector/init_conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["descriptor.fc2.weight"].numpy(), flat["descriptor/fc2/kernel"].T)
    np.testing.assert_array_equal(got["detector.block_2.mid_norm.scale"].numpy(),
                                  flat["detector/block_2/mid_norm/scale"])


@pytest.mark.parametrize("reorder", [True, False], ids=["carry-over", "naive-nchw-flatten"])
def test_descriptor_fc1_flatten_order(reorder):
    """Flax flattens the descriptor's [4, 4, 256] maps in (h, w, c) order;
    the carry-over reorders fc1's rows for torch's (c, h, w).  Without the
    reordering the descriptors are plausible unit vectors, but wrong."""
    flat = _jax_flat_params()
    desc_params = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("descriptor/")}
    tree = flax.traverse_util.unflatten_dict(desc_params, sep="/")
    patches = rng.randn(5, 32, 32, 1).astype(np.float32)
    want = np.asarray(JaxSimpleDesc().apply({"params": tree}, jnp.asarray(patches)))
    sd = lfnet.lfnet_state_dict_from_flax(flat)
    if not reorder:
        sd["descriptor.fc1.weight"] = torch.from_numpy(np.ascontiguousarray(flat["descriptor/fc1/kernel"].T))
    net = lfnet.LFNet(FrontendConfig(kind="lfnet", bf16=False))
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net.descriptor(nchw(patches)).numpy()
    err = np.abs(got - want).max()
    assert err < F32_DESC_TOL if reorder else err > 0.1, err


@pytest.mark.parametrize("change", ["missing", "unknown", "shape"])
def test_npz_loader_rejects_a_mismatched_file(change, tmp_path):
    with np.load(CKPT) as data:
        arrays = {k: data[k] for k in data.files}
    if change == "missing":
        arrays.pop("detector/ori_conv/bias")
    elif change == "unknown":
        arrays["detector/extra/bias"] = arrays["detector/ori_conv/bias"]
    else:
        arrays["descriptor/fc2/bias"] = arrays["descriptor/fc2/bias"][:-1]
    path = str(tmp_path / "bad.npz")
    np.savez(path, **arrays)
    with pytest.raises(KeyError if change == "missing" else ValueError):
        lfnet.load_params_npz(path, FrontendConfig(kind="lfnet"))


@pytest.mark.parametrize("size,stride,cin", [(32, 2, 1), (33, 2, 4), (16, 1, 4)])
def test_same_padded_conv(size, stride, cin):
    """Flax pads "SAME": a stride-2 3x3 conv on an even size pads nothing
    before and one pixel after."""
    x = rng.randn(2, size, size, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, 8) * 0.3).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    want = np.asarray(fnn.Conv(8, (3, 3), strides=(stride, stride)).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x)))
    conv = lfnet.Conv(cin, 8, 3, stride=stride)
    conv.load_state_dict({"weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = nhwc(conv(nchw(x)))
    np.testing.assert_allclose(got, want, atol=OPS_TOL)


# ---- the whole forward on the shipped weights ----------------------------------


def _crops(size: int, frames: int):
    """Masked ROI crops at size x size of rendered 120x160 frames, as the
    pipeline feeds the net."""
    seq = render_synthetic_sequence(num_frames=frames, H=120, W=160, orbit_deg_per_frame=7.0)
    out = []
    for f in range(frames):
        m = jnp.asarray(seq.mask[f])
        g = jnp.where(m, jnp.asarray(seq.gray[f]), 0.0)
        out.append(np.array(jresize.crop_resize_square(g, jmasks.mask_roi(m)[:4], size)[0]))
    return out


@pytest.fixture(scope="module")
def crops():
    return _crops(96, 8)


def _forwards(crops, bf16, size=96, top_k=64):
    """(JAX, port) outputs per crop; the JAX forward jitted, as its paths
    run it."""
    jcfg = JaxFrontendConfig(kind="lfnet", input_size=size, top_k=top_k, bf16=bf16)
    jmodel, jparams = jax_load_params_npz(CKPT, jcfg)
    japply = jax.jit(lambda x: jmodel.apply({"params": jparams}, x))
    tnet, _ = lfnet.load_params_npz(CKPT, FrontendConfig(kind="lfnet", input_size=size, top_k=top_k, bf16=bf16))
    for crop in crops:
        j = japply(jnp.asarray(crop)[None, :, :, None])
        with torch.no_grad():
            t = tnet(torch.from_numpy(crop)[None, None])
        yield ({k: np.asarray(v[0]) for k, v in j._asdict().items()},
               {k: v[0].numpy() for k, v in t._asdict().items()})


def test_lfnet_forward_f32_matches_jax(crops):
    for j, t in _forwards(crops, bf16=False):
        np.testing.assert_array_equal(t["valid"], j["valid"])
        np.testing.assert_allclose(t["kpts_uv"], j["kpts_uv"], atol=1e-3)
        np.testing.assert_allclose(t["desc"], j["desc"], atol=F32_DESC_TOL)
        np.testing.assert_allclose(t["scores"], j["scores"], atol=F32_SCORE_TOL)


def _bf16_agreement(pairs):
    """(keypoints of JAX's found by the port, JAX's keypoints, per-keypoint
    max |descriptor difference| of the found ones)."""
    found = total = 0
    desc_err = []
    for j, t in pairs:
        jk, tk = j["kpts_uv"][j["valid"]], t["kpts_uv"][t["valid"]]
        d = np.linalg.norm(jk[:, None] - tk[None], axis=-1)
        same = d.min(axis=1) < 0.05
        found += int(same.sum())
        total += len(jk)
        desc_err.append(np.abs(j["desc"][j["valid"]][same] - t["desc"][t["valid"]][d.argmin(axis=1)[same]]).max(axis=1))
    return found, total, np.concatenate(desc_err)


def test_lfnet_forward_bf16_matches_jax(crops):
    found, total, desc_err = _bf16_agreement(_forwards(crops, bf16=True))
    assert found >= BF16_MIN_SAME_KPTS * total, (found, total)
    assert desc_err.max() < BF16_DESC_MAX and np.median(desc_err) < BF16_DESC_MEDIAN, desc_err


def test_lfnet_forward_bf16_matches_jax_at_192():
    """Input 192 (the long-sequence tests' size), top_k 256, 6 crops: the
    keypoint share and the median descriptor difference (one keypoint whose
    orientation flips moves its descriptor by more than BF16_DESC_MAX)."""
    found, total, desc_err = _bf16_agreement(_forwards(_crops(192, 6), bf16=True, size=192, top_k=256))
    assert found >= BF16_MIN_SAME_KPTS * total, (found, total)
    assert np.median(desc_err) < BF16_DESC_MEDIAN, desc_err


# ---- frontend quality on the shipped weights -----------------------------------------


def test_lfnet_evaluate_frontend_matches_jax():
    """bench.py's frontend-quality measure with the LF-Net frontend (bf16, on
    the shipped weights) at a small size: 3 rendered 120x160 frames, input
    96.  Repeatability and inlier rate within the card run's LF-Net bar of
    the jitted JAX evaluation's (eval/replay.FQ_RATE_SLACK)."""
    from bundletrack_tpu.eval.frontend_eval import evaluate_frontend as jevaluate_frontend
    from bundletrack_tpu.frontend.lfnet import make_lfnet_apply as jmake_lfnet_apply
    from bundletrack_tpu_torch.eval.frontend_eval import evaluate_frontend
    from bundletrack_tpu_torch.eval.replay import FQ_RATE_SLACK

    seq = render_synthetic_sequence(num_frames=3, H=120, W=160, orbit_deg_per_frame=4.0, seed=123)
    jcfg = JaxFrontendConfig(kind="lfnet", input_size=96, top_k=64)
    cfg = FrontendConfig(kind="lfnet", input_size=96, top_k=64)
    want = jevaluate_frontend(seq, jcfg, lfnet_apply=jmake_lfnet_apply(jcfg, jax_load_params_npz(CKPT, jcfg)[1]))
    got = evaluate_frontend(seq, cfg, lfnet_apply=lfnet.make_lfnet_apply(cfg, lfnet.load_params_npz(CKPT, cfg)[1]),
                            device="cpu")
    for metric in ("repeatability", "inlier_rate"):
        assert abs(got[metric] - want[metric]) <= FQ_RATE_SLACK["lfnet"], (metric, got, want)
