"""The port's LF-Net training against the JAX package's, on the CPU.

The same numpy batch and the same weights (the JAX parameters carried over
with `lfnet_state_dict_from_flax`) go through `jax.value_and_grad` of the
JAX `lfnet_loss` and through the port's loss and backward, at the small
configuration of tests/test_train_apps.py.  Also: Adam and the cosine
schedule against optax, `transformer_crop`'s gradient at integer sample
positions, `data/pairs` and `build_batches` against the JAX package's, and
the trainer CLI with checkpoints and resume.
"""

import json
import shutil

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bundletrack_tpu.apps import train_lfnet as jax_train_lfnet
from bundletrack_tpu.config import FrontendConfig as JaxFrontendConfig
from bundletrack_tpu.data import pairs as jpairs
from bundletrack_tpu.data import render_hard_sequence as jax_render_hard_sequence
from bundletrack_tpu.data import render_synthetic_sequence as jax_render_synthetic_sequence
from bundletrack_tpu.frontend import detector_ops as jops
from bundletrack_tpu.frontend.lfnet import FrozenBN as JaxFrozenBN
from bundletrack_tpu.frontend.lfnet import init_lfnet as jax_init_lfnet
from bundletrack_tpu.models.lfnet_train import LFNetTrainBatch as JaxBatch
from bundletrack_tpu.models.lfnet_train import lfnet_loss as jax_lfnet_loss
from bundletrack_tpu_torch.apps import train_lfnet
from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.data import pairs, render_hard_sequence, render_synthetic_sequence
from bundletrack_tpu_torch.frontend import detector_ops as ops
from bundletrack_tpu_torch.frontend.lfnet import FrozenBN, LFNet, lfnet_state_dict_from_flax
from bundletrack_tpu_torch.models import LFNetTrainBatch, cosine_lr, cosine_schedule, lfnet_loss, make_adam
from bundletrack_tpu_torch.parallel import make_mesh
from bundletrack_tpu_torch.utils.flax_layers import GroupNorm

torch.set_num_threads(2)

SMALL = dict(kind="lfnet", input_size=32, top_k=16, desc_dim=32, net_channel=8, net_num_scales=3,
             desc_net_channel=16, sm_ksize=5, bf16=False)  # tests/test_train_apps.py's CLI widths
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # each tensor's max |diff| relative to its max |g|
# a tensor whose JAX gradient is below this share of the largest |g| holds
# rounding noise (the score convs' biases: the instance norm after each
# score map removes them, so their gradient is 0 in exact arithmetic); there
# the port's gradient must be as small
GRAD_FLOOR = 1e-6
# Both forwards agree to ~1e-6 (an ulp of a keypoint coordinate), but a
# ReLU input that lies within that noise of 0 can take the other branch in
# one package, and the gradient of a piecewise-linear network jumps there:
# where the test finds such a flip it holds every parameter up to the
# flipped layer (in forward order) to this cosine instead of GRAD_TOL.
FLIP_GRAD_COS_MIN = 0.999
ADAM_ATOL = 1e-5
SCHEDULE_ATOL = 1e-7  # on the factor; f32's half ulp at 1 is 6e-8


def _jax_model():
    model, params = jax_init_lfnet(JaxFrontendConfig(**SMALL))
    return model, params


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _identity_batch():
    """tests/test_lfnet.py's identity-warp batch: img2 == img1, the warp the
    identity, every pixel valid."""
    rng = np.random.RandomState(0)
    B, H, W = 2, 64, 64
    img = rng.rand(B, H, W, 1).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    warp = np.broadcast_to(np.stack([gx, gy], -1)[None], (B, H, W, 2)).copy()
    return {"img1": img, "img2": img.copy(), "warp12": warp, "warp_valid": np.ones((B, H, W), bool)}


def _hard_batch():
    """A batch of serving-faithful ROI pairs from two hard worlds (the
    trainer's pool), 64x64: at 32x32 the 16-px crop radius leaves no valid
    keypoint, and the descriptor term is 0."""
    return train_lfnet.build_batches(64, 2, 1, seed=0, num_batches=1)[0]


def _jax_loss_grads_and_acts(model, params, batch):
    """(loss, aux, flat grads, pre-ReLU norm outputs in call order) of the JAX loss."""
    jb = JaxBatch(*(jnp.asarray(batch[k]) for k in JaxBatch._fields))
    (loss, aux), grads = jax.jit(jax.value_and_grad(lambda p: jax_lfnet_loss(p, model, jb), has_aux=True))(params)

    def forward(p):
        acts = []

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, (fnn.GroupNorm, JaxFrozenBN)) and context.method_name == "__call__":
                acts.append(out)
            return out

        with fnn.intercept_methods(grab):
            jax_lfnet_loss(p, model, jb)
        return acts

    acts = [np.asarray(a) for a in jax.jit(forward)(params)]
    return float(loss), {k: float(v) for k, v in aux.items()}, _flat(grads), acts


def _port_loss_grads_and_acts(net, batch):
    acts = []
    hooks = [m.register_forward_hook(lambda mod, inp, out, name=name: acts.append((name, out.detach())))
             for name, m in net.named_modules() if isinstance(m, (GroupNorm, FrozenBN))]
    loss, aux = lfnet_loss(net, LFNetTrainBatch(*(torch.from_numpy(batch[k]) for k in LFNetTrainBatch._fields)))
    loss.backward()
    for h in hooks:
        h.remove()
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, acts


def _flipped_modules(jax_acts, port_acts):
    """Names of the norms whose following ReLU takes another branch in the
    port than in JAX on some element (the calls matched in order)."""
    assert len(jax_acts) == len(port_acts)
    flipped = set()
    for ja, (name, pa) in zip(jax_acts, port_acts):
        pa = pa.numpy()
        if pa.ndim == 4:
            pa = pa.transpose(0, 2, 3, 1)  # NCHW -> NHWC
        assert ja.shape == pa.shape, name
        if np.any((ja > 0) != (pa > 0)):
            flipped.add(name)
    return flipped


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


@pytest.mark.parametrize("make_batch", [_identity_batch, _hard_batch], ids=["identity-warp", "hard-world-roi"])
def test_lfnet_loss_and_gradients_match_jax(jax_model, make_batch):
    model, params = jax_model
    batch = make_batch()
    j_loss, j_aux, j_grads, j_acts = _jax_loss_grads_and_acts(model, params, batch)
    net = LFNet(FrontendConfig(**SMALL))
    net.load_state_dict(lfnet_state_dict_from_flax(_flat(params)))
    loss, aux, p_acts = _port_loss_grads_and_acts(net, batch)

    assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss), (loss, j_loss)
    for k in ("det_loss", "desc_loss"):
        assert abs(aux[k] - j_aux[k]) <= LOSS_RTOL * max(abs(j_aux[k]), 1e-12), (k, aux[k], j_aux[k])
    assert j_aux["desc_loss"] > 0 and j_aux["det_loss"] >= 0  # both terms present

    ref = lfnet_state_dict_from_flax(j_grads)  # gradients map like the weights they are of
    names = [n for n, _ in net.named_parameters()]
    assert set(ref) == set(names)
    flipped = _flipped_modules(j_acts, p_acts)
    print("ReLU branches that differ from JAX's after:", sorted(flipped))
    # parameters up to the last flipped layer, in forward (registration) order
    last = max((i for i, n in enumerate(names) if n.rsplit(".", 1)[0] in flipped), default=-1)
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for i, (n, p) in enumerate(net.named_parameters()):
        want = ref[n].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        if float(np.abs(want).max()) < GRAD_FLOOR * gmax:  # zero in exact arithmetic: noise in both
            assert float(np.abs(got).max()) < GRAD_FLOOR * gmax, n
        elif i <= last:
            cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
            assert cos >= FLIP_GRAD_COS_MIN, (n, cos, flipped)
        else:
            assert float(np.abs(got - want).max()) <= GRAD_TOL * float(np.abs(want).max()), (
                n, float(np.abs(got - want).max()), float(np.abs(want).max()))


def test_three_adam_steps_match_optax():
    """The same gradient sequence into optax.adam(cosine_decay_schedule)
    and the port's make_adam + cosine_schedule."""
    rng = np.random.RandomState(1)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    tx = optax.adam(optax.cosine_decay_schedule(1e-2, 3, alpha=0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_adam(tp.values(), 1e-2)
    sched = cosine_schedule(opt, 3)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=ADAM_ATOL, rtol=0)


def test_cosine_schedule_matches_optax():
    """The factor of the base rate, past the decay too; optax evaluates it
    in f32, the port in f64."""
    sched = optax.cosine_decay_schedule(1.0, 200, alpha=0.1)
    steps = np.arange(0, 260, 7)
    want = np.array([float(sched(s)) for s in steps])
    got = np.array([cosine_lr(int(s), 200) for s in steps])
    np.testing.assert_allclose(got, want, atol=SCHEDULE_ATOL, rtol=0)


def test_transformer_crop_gradient_splits_ties_as_jax():
    """Samples on integer pixels (fraction exactly 0) and on the last column
    (fraction exactly 1): jnp.clip gives half the gradient there."""
    rng = np.random.RandomState(2)
    img = rng.rand(2, 12, 14, 1).astype(np.float32)
    xy = np.array([[5.0, 6.0], [13.0, 4.0], [7.0, 11.0]], np.float32)  # integers; x = W - 1; y = H - 1
    sc = np.array([1.0, 1.0, 1.0], np.float32)
    ori = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    bi = np.array([0, 1, 0])
    ct = rng.randn(3, 5, 5, 1).astype(np.float32)  # out 5: the centre column samples x itself

    def jf(im, x, s, o):
        return jnp.sum(jops.transformer_crop(im, 5, jnp.asarray(bi), x, s, o) * ct)

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (img, xy, sc, ori)))
    ts = [torch.tensor(a, requires_grad=True) for a in (img.transpose(0, 3, 1, 2).copy(), xy, sc, ori)]
    out = ops.transformer_crop(ts[0], 5, torch.from_numpy(bi), ts[1], ts[2], ts[3])
    (out * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    for name, w, t in zip(("image", "xy", "scale", "ori"), want, ts):
        got = t.grad.numpy()
        if name == "image":
            got = got.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


def _assert_same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pair_and_clip_batches_equal_jax():
    seq = render_synthetic_sequence(num_frames=4, H=64, W=64)
    jseq = jax_render_synthetic_sequence(num_frames=4, H=64, W=64)
    _assert_same_arrays(pairs.lfnet_pair_batch(seq, [(0, 1), (1, 3)]), jpairs.lfnet_pair_batch(jseq, [(0, 1), (1, 3)]))
    _assert_same_arrays(pairs.vos_clip_batch(seq, [0, 1], 3, stride=2), jpairs.vos_clip_batch(jseq, [0, 1], 3, stride=2))
    hard = render_hard_sequence("lshape", num_frames=3, H=48, W=64)
    jhard = jax_render_hard_sequence("lshape", num_frames=3, H=48, W=64)
    for photometric in (False, True):
        _assert_same_arrays(
            pairs.lfnet_roi_pair_batch(hard, [(0, 2)], 32, rng=np.random.RandomState(3), photometric=photometric),
            jpairs.lfnet_roi_pair_batch(jhard, [(0, 2)], 32, rng=np.random.RandomState(3), photometric=photometric))
    assert pairs._roi_square(hard.mask[0]) == jpairs._roi_square(jhard.mask[0])
    assert pairs._roi_square(np.zeros((5, 7), bool)) == jpairs._roi_square(np.zeros((5, 7), bool)) == (0, 0, 7)
    np.testing.assert_array_equal(pairs._crop_resize_np(hard.gray[1], 3, 5, 20, 16),
                                  jpairs._crop_resize_np(jhard.gray[1], 3, 5, 20, 16))


@pytest.mark.parametrize("world", ["hard", "easy"])
def test_build_batches_equal_jax(world):
    got = train_lfnet.build_batches(32, 2, 2, seed=1, world=world, num_batches=3)
    want = jax_train_lfnet.build_batches(32, 2, 2, seed=1, world=world, num_batches=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_arrays(g, w)


CLI_ARGS = ["--size", "32", "--batch", "2", "--top-k", "16", "--desc-dim", "32", "--num-seqs", "1",
            "--net-channel", "8", "--num-scales", "3", "--desc-channel", "16", "--sm-ksize", "5",
            "--mesh", "none", "--device", "cpu"]


def test_train_lfnet_cli_smoke(tmp_path, capsys):
    """tests/test_train_apps.py::test_train_lfnet_cli_smoke on the port:
    steps run, the loss trends down, a checkpoint is written."""
    train_lfnet.main(["--steps", "6", "--log-every", "1", "--lr", "1e-3", "--ckpt-dir", str(tmp_path / "ck"),
                      "--ckpt-every", "6"] + CLI_ARGS)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines() if line.startswith("{")]
    losses = [line["loss"] for line in lines]
    assert len(losses) == 6
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) <= np.mean(losses[:3]) + 1e-3
    assert (tmp_path / "ck" / "meta.json").exists()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["meta.json", "opt_state", "params"]


def test_train_lfnet_resume(tmp_path):
    """tests/test_train_apps.py::test_train_lfnet_resume on the port; and a
    run resumed at step 2 ends where an uninterrupted run of the same
    schedule does (bit for bit on the CPU)."""
    args = ["--log-every", "2", "--ckpt-every", "2"] + CLI_ARGS
    train_lfnet.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "ck")] + args)
    train_lfnet.main(["--steps", "4", "--resume", "--ckpt-dir", str(tmp_path / "ck")] + args)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["step"] == 4

    # one schedule (--steps 4): a copy of the step-2 checkpoint resumed to 4
    save = train_lfnet.save_checkpoint

    def save_and_copy(ckpt_dir, step, *rest):
        save(ckpt_dir, step, *rest)
        if step == 2:
            shutil.copytree(ckpt_dir, tmp_path / "b")

    train_lfnet.save_checkpoint = save_and_copy
    try:
        train_lfnet.main(["--steps", "4", "--lr-decay", "cosine", "--ckpt-dir", str(tmp_path / "a")] + args)
    finally:
        train_lfnet.save_checkpoint = save
    train_lfnet.main(["--steps", "4", "--resume", "--ckpt-dir", str(tmp_path / "b")] + args)
    a = np.load(tmp_path / "a" / "params" / "state.npz")
    b = np.load(tmp_path / "b" / "params" / "state.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_lfnet_mesh_in_one_process_trains_on_one_device():
    """As the JAX app with one device: a --mesh in a world of one rank
    trains on that device; a mesh whose size is not the world's raises
    (tests/test_torch_train_sharded.py runs the CLI over ranks)."""
    metrics = train_lfnet.main(["--steps", "1"] + CLI_ARGS[:-4] + ["--mesh", "4,2", "--device", "cpu"])
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(ValueError, match="has 8 ranks, the world 1"):
        make_mesh({"data": 4, "model": 2})


def test_train_lfnet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lfnet.main(["--steps", "1"] + CLI_ARGS[:-2])
