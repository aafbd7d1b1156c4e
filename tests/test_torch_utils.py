"""The port's utilities against the JAX package's, on the CPU: npz
checkpoints of tracker, fleet and optimiser state (mirrors of
tests/test_apps_utils.py::TestCheckpoint), profiling and viz
(TestTimingAndViz; the port has no stage timer, tests/test_torch_profiling.py
holds its spans and counters), TF1 weight porting (tests/test_port_tf1.py), and
parameter files the port writes read back by the JAX package.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import FrontendConfig as JaxFrontendConfig
from bundletrack_tpu.frontend import lfnet as jlfnet
from bundletrack_tpu.frontend import port_tf1 as jport
from bundletrack_tpu.models import vos as jvos
from bundletrack_tpu_torch.config import FrontendConfig, KeyframeConfig, ShapeConfig, TrackerConfig
from bundletrack_tpu_torch.frontend import lfnet
from bundletrack_tpu_torch.frontend.lfnet import FrozenBN, LFNet
from bundletrack_tpu_torch.frontend.port_tf1 import PortError, check_ported_params, port_lfnet_params
from bundletrack_tpu_torch.models import make_adam, vos
from bundletrack_tpu_torch.parallel import init_fleet_state
from bundletrack_tpu_torch.tracker.state import init_tracker_state
from bundletrack_tpu_torch.utils.checkpoint import STATE_FILE, restore_tracker_state, save_tracker_state
from bundletrack_tpu_torch.utils.flax_layers import flax_param_shapes

torch.set_num_threads(2)

FWD_TOL = 1e-4  # f32 forwards of the same weights, summed in other orders


def _cfg():
    return TrackerConfig(keyframe=KeyframeConfig(pool_size=4), frontend=FrontendConfig(top_k=32),
                         shapes=ShapeConfig(max_landmarks=64))


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b and type(a) is type(b)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        """TestCheckpoint's round trip, with a bf16 kf_tchan that is not zero
        and the generator advanced."""
        state = init_tracker_state(_cfg(), 32, 40, "cpu", seed=3)
        state.kf_tchan.copy_(torch.randn(state.kf_tchan.shape).to(torch.bfloat16))
        state.kf_frame_id.copy_(torch.arange(4, dtype=torch.int32))
        torch.rand(5, generator=state.rng)
        state = state._replace(frame_count=7)
        save_tracker_state(str(tmp_path / "ckpt"), state)
        restored = restore_tracker_state(str(tmp_path / "ckpt"), init_tracker_state(_cfg(), 32, 40, "cpu"))
        assert restored.frame_count == 7
        _assert_tree_equal(restored, state)
        # the bf16 table went through numpy as its int16 bits
        with np.load(tmp_path / "ckpt" / STATE_FILE) as data:
            assert data["kf_tchan"].dtype == np.int16
        assert torch.equal(torch.rand(3, generator=restored.rng), torch.rand(3, generator=state.rng))

    def test_fleet_state_roundtrip(self, tmp_path):
        fleet = init_fleet_state(_cfg(), 32, 40, 3, device="cpu", seed=1)
        fleet.prev_pose.add_(torch.randn(fleet.prev_pose.shape))
        save_tracker_state(str(tmp_path / "f"), fleet._replace(frame_count=(2, 0, 5)))
        back = restore_tracker_state(str(tmp_path / "f"), init_fleet_state(_cfg(), 32, 40, 3, device="cpu"))
        assert isinstance(back.rng, tuple) and len(back.rng) == 3
        assert back.frame_count == (2, 0, 5)  # each stream's own count
        _assert_tree_equal(back, fleet._replace(frame_count=(2, 0, 5)))

    def test_adam_state_roundtrip_resumes_the_same_steps(self, tmp_path):
        """An optimiser state dict after two steps restores into a fresh
        optimiser's, and the next step matches the uninterrupted one."""
        torch.manual_seed(0)
        model = torch.nn.Linear(5, 3)
        opt = make_adam(model.parameters(), 1e-2)
        x = torch.randn(8, 5)
        for _ in range(2):
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.step()
        save_tracker_state(str(tmp_path / "p"), model.state_dict())
        save_tracker_state(str(tmp_path / "o"), opt.state_dict())
        model2 = torch.nn.Linear(5, 3)
        opt2 = make_adam(model2.parameters(), 1e-2)
        model2.load_state_dict(restore_tracker_state(str(tmp_path / "p"), model2.state_dict()))
        opt2.load_state_dict(restore_tracker_state(str(tmp_path / "o"), opt2.state_dict()))
        for m, o in ((model, opt), (model2, opt2)):
            o.zero_grad()
            m(x).square().sum().backward()
            o.step()
        for a, b in zip(model.parameters(), model2.parameters()):
            assert torch.equal(a, b)
        assert float(opt2.state_dict()["state"][0]["step"]) == 3.0

    def test_restore_checks_names_shapes_and_dtypes(self, tmp_path):
        save_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [torch.ones(2, dtype=torch.int32), 4]})
        with pytest.raises(ValueError, match="expected torch.float32"):
            restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(4), "b": [torch.ones(2, dtype=torch.int32), 0]})
        with pytest.raises(ValueError, match="b/0"):
            restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [torch.ones(2), 0]})
        with pytest.raises(KeyError, match="no entry c"):
            restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [torch.ones(2, dtype=torch.int32), 0],
                                                        "c": torch.zeros(1)})
        with pytest.raises(KeyError, match="template lacks"):
            restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="expected float"):
            restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [torch.ones(2, dtype=torch.int32), 0.5]})
        back = restore_tracker_state(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [torch.ones(2, dtype=torch.int32), 0]})
        assert back["b"][1] == 4 and back["a"].dtype == torch.float32


class TestTimingAndViz:
    def test_profiler_trace(self, tmp_path):
        from bundletrack_tpu_torch.utils.profiling import TRACE_FILE, annotate, trace

        with trace(str(tmp_path / "t")) as prof:
            with annotate("stage_x"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        assert (tmp_path / "t" / TRACE_FILE).exists()
        assert "stage_x" in {e.key for e in prof.key_averages()}

    def test_viz_outputs(self, tmp_path):
        from bundletrack_tpu_torch.data.native_io import read_png
        from bundletrack_tpu_torch.utils.viz import draw_keypoints, draw_matches, draw_reprojection

        gray = np.random.RandomState(0).rand(32, 40).astype(np.float32)
        kpts = np.array([[5.0, 6.0], [20.0, 15.0]])
        draw_keypoints(gray, kpts, [True, True], str(tmp_path / "kp.png"))
        draw_matches(gray, kpts, gray, kpts, [0, 1], [1, 0], [True, True], str(tmp_path / "m.png"))
        K = np.array([[100.0, 0, 20], [0, 100, 16], [0, 0, 1]])
        draw_reprojection(gray, np.random.rand(50, 3) * 0.1, np.eye(4), K, str(tmp_path / "r.png"))
        for f in ["kp.png", "m.png", "r.png"]:
            assert (tmp_path / f).exists()
        kp = read_png(str(tmp_path / "kp.png"))
        assert kp.shape == (32, 40, 3) and tuple(kp[6, 5]) == (0, 255, 0)  # the keypoint's disk
        assert read_png(str(tmp_path / "m.png")).shape == (32, 80, 3)


# ---- TF1 porting -------------------------------------------------------------

CFG = dict(kind="lfnet", input_size=32, top_k=16, desc_dim=32, net_channel=8, net_num_scales=3, sm_ksize=5,
           desc_net_channel=16, norm="bn", bf16=False)


def _tf_name(flax_name: str, bn_style: str) -> str:
    """The reference's TF1 variable name of a flat Flax parameter name
    (tests/test_port_tf1.py's mapping)."""
    parts = flax_name.split("/")

    def bn(scope):
        m = ({"mean": "moving_mean", "var": "moving_variance", "scale": "gamma", "bias": "beta"} if bn_style == "layers"
             else {"mean": "moments/Squeeze/ExponentialMovingAverage",
                   "var": "moments/Squeeze_1/ExponentialMovingAverage", "scale": "gamma", "bias": "beta"})
        return f"{scope}/{m[parts[-1]]}"

    def wb(scope):
        return f"{scope}/" + ("weights" if parts[-1] == "kernel" else "biases")

    if parts[0] == "detector":
        s = "ConvOnlyResNet"
        if parts[1] in ("init_conv", "ori_conv") or parts[1].startswith("score_conv"):
            name = wb(f"{s}/{parts[1]}")
        elif parts[1] == "final_norm":
            name = bn(f"{s}/fin-bn")
        else:
            i = parts[1].split("_")[1]
            name = (wb(f"{s}/block-{i}/{parts[2]}") if parts[2] in ("conv1", "conv2")
                    else bn(f"{s}/block-{i}/{'pre-bn' if parts[2] == 'pre_norm' else 'mid-bn'}"))
    else:
        s = "SimpleDesc"
        if parts[1].startswith("conv") or parts[1] in ("fc1", "fc2"):
            name = wb(f"{s}/{parts[1]}")
        elif parts[1] == "fc1_norm":
            name = bn(f"{s}/fc1/bn")
        else:
            name = bn(f"{s}/conv{parts[1][-1]}/bn")
    return name + ":0"


def _fake_tf_vars(bn_style="layers", seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in flax_param_shapes(LFNet(FrontendConfig(**CFG))).items():
        val = rng.randn(*shape).astype(np.float32)
        if name.endswith("/var"):
            val = np.abs(val) + 0.5
        out[_tf_name(name, bn_style)] = val
    return out


class TestPortTF1:
    @pytest.mark.parametrize("bn_style", ["layers", "ema"])
    def test_port_shapes_and_forward_match_jax(self, bn_style):
        tf_vars = _fake_tf_vars(bn_style)
        sd = port_lfnet_params(tf_vars, FrontendConfig(**CFG))
        check_ported_params(sd, FrontendConfig(**CFG))
        net = LFNet(FrontendConfig(**CFG))
        net.load_state_dict(sd)
        jparams = jport.port_lfnet_params(tf_vars, JaxFrontendConfig(**CFG))
        img = np.random.RandomState(1).rand(2, 64, 64, 1).astype(np.float32)
        want = jlfnet.LFNet(JaxFrontendConfig(**CFG)).apply({"params": jparams}, jnp.asarray(img))
        with torch.no_grad():
            got = net(torch.from_numpy(img).permute(0, 3, 1, 2))
        assert got.desc.shape == (2, CFG["top_k"], CFG["desc_dim"])
        assert np.all(np.isfinite(got.desc.numpy()))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.kpts_uv.numpy(), np.asarray(want.kpts_uv), atol=1e-3)
        np.testing.assert_allclose(got.desc.numpy(), np.asarray(want.desc), atol=FWD_TOL)

    def test_missing_variable_raises(self):
        tf_vars = _fake_tf_vars()
        del tf_vars["ConvOnlyResNet/ori_conv/weights:0"]
        with pytest.raises(PortError, match="ori_conv"):
            port_lfnet_params(tf_vars, FrontendConfig(**CFG))

    def test_gn_config_rejected(self):
        with pytest.raises(PortError, match="bn"):
            port_lfnet_params({}, FrontendConfig(kind="lfnet", norm="gn"))

    def test_check_ported_params_names_mismatches(self):
        sd = port_lfnet_params(_fake_tf_vars(), FrontendConfig(**CFG))
        sd["descriptor.fc2.weight"] = sd["descriptor.fc2.weight"][:5]
        del sd["detector.ori_conv.bias"]
        sd["extra.weight"] = torch.zeros(1)
        with pytest.raises(PortError, match="missing param detector.ori_conv.bias.*shape mismatch descriptor.fc2.weight"
                           ".*unexpected param extra.weight"):
            check_ported_params(sd, FrontendConfig(**CFG))

    def test_frozen_bn_matches_tf_formula(self):
        """FrozenBN == tf.nn.batch_normalization(x, mean, var, beta, gamma, 1e-3)."""
        rng = np.random.RandomState(1)
        x = rng.randn(2, 3, 4, 4).astype(np.float32)
        bn = FrozenBN(3)
        vals = {k: rng.randn(3).astype(np.float32) for k in ("mean", "scale", "bias")}
        vals["var"] = (np.abs(rng.randn(3)) + 0.5).astype(np.float32)
        with torch.no_grad():
            for k, v in vals.items():
                getattr(bn, k).copy_(torch.from_numpy(v))
            got = bn(torch.from_numpy(x)).numpy()
        c = (1, 3, 1, 1)
        want = ((x - vals["mean"].reshape(c)) / np.sqrt(vals["var"].reshape(c) + 1e-3) * vals["scale"].reshape(c)
                + vals["bias"].reshape(c))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_affine_only_bn_gets_identity_stats(self):
        tf_vars = _fake_tf_vars()
        drop = [k for k in tf_vars if "fin-bn/moving" in k]
        assert drop
        for k in drop:
            del tf_vars[k]
        sd = port_lfnet_params(tf_vars, FrontendConfig(**CFG))
        assert torch.equal(sd["detector.final_norm.mean"], torch.zeros(8))
        assert torch.equal(sd["detector.final_norm.var"], torch.ones(8))


# ---- parameter files written by the port, read by the JAX package ------------


def test_lfnet_npz_written_by_the_port_loads_in_jax(tmp_path):
    cfg = dict(kind="lfnet", input_size=64, top_k=16, desc_dim=32, net_channel=8, net_num_scales=3, sm_ksize=5,
               desc_net_channel=16, bf16=False)
    _, sd = lfnet.init_lfnet(FrontendConfig(**cfg), seed=4)
    path = str(tmp_path / "lf.npz")
    lfnet.save_params_npz(path, sd)
    jm, jp = jlfnet.load_params_npz(path, JaxFrontendConfig(**cfg))  # the JAX loader checks every name and shape
    net, _ = lfnet.load_params_npz(path, FrontendConfig(**cfg))  # the same f16-rounded weights
    for k, v in sd.items():  # float16 on disk
        np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4)
    img = np.random.RandomState(2).rand(1, 64, 64, 1).astype(np.float32)
    want = jm.apply({"params": jp}, jnp.asarray(img))
    with torch.no_grad():
        got = net(torch.from_numpy(img).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(want.desc), atol=FWD_TOL)


def test_vos_npz_written_by_the_port_loads_in_jax(tmp_path):
    _, sd = vos.init_vos(out_dim=32, width=16, seed=4)
    path = str(tmp_path / "vos.npz")
    vos.save_vos_npz(path, sd)
    jm, jp = jvos.load_vos_npz(path)
    assert (jm.width, jm.out_dim) == (16, 32)
    net, _ = vos.load_vos_npz(path)
    img = np.random.RandomState(3).rand(1, 48, 40, 3).astype(np.float32)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        got = net(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)
