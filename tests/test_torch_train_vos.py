"""The port's VOS training against the JAX package's, on the CPU.

The same clips, labels and weights (a Flax VOSNet carried over with
`vos_state_dict_from_flax`) go through `jax.value_and_grad` of the JAX
`vos_loss` and `vos_rollout_loss` and through the port's losses and
backward (width 8, 32x32, B 2, T 3).  Also: the bf16 similarity's
backward against `jax.grad`, the serving attention unchanged beside the
training one, the trainer CLI, and run_vos on the trainer's checkpoint.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.models import vos as jvos
from bundletrack_tpu.models import vos_train as jvos_train
from bundletrack_tpu_torch.apps import run_vos, train_vos
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.data.native_io import read_png, write_png
from bundletrack_tpu_torch.models import VOSTrainBatch, vos, vos_loss, vos_rollout_loss
from bundletrack_tpu_torch.ops.numerics import flush_denormals
from bundletrack_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # each tensor's max |diff| relative to its max |g|
# a tensor whose JAX gradient is below this share of the largest |g| holds
# rounding noise: at width 8 each GroupNorm(8) group is one channel, so the
# stem conv's bias is normalised away and its gradient is 0 in exact
# arithmetic; there the port's gradient must be as small
GRAD_FLOOR = 1e-6
SIM_GRAD_TOL = 1e-6  # the similarity's gradient: the same f32 products, rounded to bf16 alike


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _batch(seed=0, B=2, T=3, H=32, W=32):
    """Clips of a rendered cube with their masks, and noise on top so that
    the two classes are not trivially separable."""
    seq = render_synthetic_sequence(num_frames=B * T, H=H, W=W, seed=seed, orbit_deg_per_frame=6.0)
    rng = np.random.RandomState(seed)
    clips = np.repeat(seq.gray[..., None], 3, axis=-1).reshape(B, T, H, W, 3)
    clips = np.clip(clips + 0.1 * rng.rand(*clips.shape), 0, 1).astype(np.float32)
    return clips, seq.mask.reshape(B, T, H, W).astype(np.int32)


@pytest.fixture(scope="module")
def flax_vosnet():
    model = jvos.VOSNet(out_dim=16, width=8)
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))["params"]
    return model, params


@pytest.mark.parametrize("rollout", [False, True], ids=["vos_loss", "vos_rollout_loss"])
def test_vos_losses_and_gradients_match_jax(flax_vosnet, rollout):
    jm, jp = flax_vosnet
    clips, labels = _batch()
    h = w = 32 // 8
    w1, w2 = jvos.spatial_weight(h, w, 8.0), jvos.spatial_weight(h, w, 21.0)
    jloss = jvos_train.vos_rollout_loss if rollout else jvos_train.vos_loss
    jb = jvos_train.VOSTrainBatch(jnp.asarray(clips), jnp.asarray(labels))
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jm, jb, w1, w2, 2), has_aux=True))(jp)

    net = vos.VOSNet(out_dim=16, width=8)
    net.load_state_dict(vos.vos_state_dict_from_flax(_flat(jp)))
    t1 = flush_denormals(vos.spatial_weight(h, w, 8.0))
    t2 = flush_denormals(vos.spatial_weight(h, w, 21.0))
    loss_fn = vos_rollout_loss if rollout else vos_loss
    loss, aux = loss_fn(net, VOSTrainBatch(torch.from_numpy(clips), torch.from_numpy(labels)), t1, t2, 2)
    loss.backward()

    assert float(j_loss) > 1e-3  # a loss with something to learn
    loss = float(loss.detach())
    assert abs(loss - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss)), (loss, float(j_loss))
    assert set(aux) == set(j_aux) == ({"ce", "bal_ce", "iou", "iou_last"} if rollout else {"ce", "bal_ce", "acc", "iou"})
    for k in aux:
        assert abs(float(aux[k].detach()) - float(j_aux[k])) <= LOSS_RTOL * max(abs(float(j_aux[k])), 1e-6), k
    ref = vos.vos_state_dict_from_flax(_flat(j_grads))
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for n, p in net.named_parameters():
        want = ref[n].numpy()
        got = p.grad.numpy()
        if float(np.abs(want).max()) < GRAD_FLOOR * gmax:  # zero in exact arithmetic: noise in both
            assert float(np.abs(got).max()) < GRAD_FLOOR * gmax, n
        else:
            assert float(np.abs(got - want).max()) <= GRAD_TOL * float(np.abs(want).max()), (
                n, float(np.abs(got - want).max()), float(np.abs(want).max()))


def test_similarity_backward_matches_jax():
    """Bf16DotF32 against jax.grad of the JAX similarity's product
    (bf16 operands, f32 result), both operands' gradients."""
    rng = np.random.RandomState(3)
    a = rng.randn(12, 16).astype(np.float32)
    b = rng.randn(16, 20).astype(np.float32)
    g = rng.randn(12, 20).astype(np.float32)

    def jsim(x, y):
        return jax.lax.dot_general(x.astype(jnp.bfloat16), y.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    out, vjp = jax.vjp(jsim, jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(g))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    tout = vos.Bf16DotF32.apply(ta, tb)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=SIM_GRAD_TOL, rtol=0)  # sum order
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=SIM_GRAD_TOL, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=SIM_GRAD_TOL, rtol=0)


def test_propagate_labels_gradient_matches_jax():
    """The training attention (out of place) through propagate_labels: the
    soft labels and the gradient with respect to the features."""
    rng = np.random.RandomState(4)
    R, C, h, w = 3, 8, 4, 5
    fr = rng.randn(R, h, w, C).astype(np.float32)
    ft = rng.randn(h, w, C).astype(np.float32)
    lab = rng.rand(R, h, w, 2).astype(np.float32)
    valid, recent = np.array([True, True, False]), np.array([True, False, False])
    ct = rng.randn(h, w, 2).astype(np.float32)
    w1, w2 = jvos.spatial_weight(h, w, 8.0), jvos.spatial_weight(h, w, 21.0)

    def jf(a, b):
        out = jvos.propagate_labels(a, jnp.asarray(lab), jnp.asarray(valid), jnp.asarray(recent), b, w1, w2, 0.05)
        return jnp.sum(out * ct), out

    (_, jout), (gfr, gft) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(fr), jnp.asarray(ft))
    tfr = torch.tensor(fr.transpose(0, 3, 1, 2).copy(), requires_grad=True)
    tft = torch.tensor(ft.transpose(2, 0, 1).copy(), requires_grad=True)
    tw1, tw2 = (flush_denormals(vos.spatial_weight(h, w, s)) for s in (8.0, 21.0))
    out = vos.propagate_labels(tfr, torch.from_numpy(lab.transpose(0, 3, 1, 2).copy()), torch.from_numpy(valid),
                               torch.from_numpy(recent), tft, tw1, tw2, 0.05)
    (out * torch.from_numpy(ct.transpose(2, 0, 1).copy())).sum().backward()
    np.testing.assert_allclose(out.detach().permute(1, 2, 0).numpy(), np.asarray(jout), atol=1e-5)
    for got, want in ((tfr.grad.permute(0, 2, 3, 1), gfr), (tft.grad.permute(1, 2, 0), gft)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_TOL * float(np.abs(want).max())


def test_serving_attention_is_unchanged_by_the_training_one():
    """The in-place serving attention and the out-of-place training one give
    the same values bit for bit, and propagate_labels without a gradient
    takes the serving one (the masks of VOSPropagator are held to JAX's in
    tests/test_torch_vos.py)."""
    rng = np.random.RandomState(5)
    R, N = 3, 20
    sim = torch.from_numpy(rng.randn(N, R * N).astype(np.float32))
    valid, recent = torch.tensor([True, False, True]), torch.tensor([True, True, False])
    w1, w2 = (torch.from_numpy(rng.rand(N, N).astype(np.float32)) for _ in range(2))
    a = vos.attention(sim.clone(), valid, recent, w1, w2, 0.05)
    b = vos.attention_train(sim.clone().requires_grad_(), valid, recent, w1, w2, 0.05)
    assert torch.equal(a, b.detach())
    feats = torch.from_numpy(rng.randn(R, 8, 4, 5).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(8, 4, 5).astype(np.float32))
    labels = torch.from_numpy(rng.rand(R, 2, 4, 5).astype(np.float32))
    w1, w2 = (flush_denormals(vos.spatial_weight(4, 5, s)) for s in (8.0, 21.0))
    with torch.no_grad():
        served = vos.propagate_labels(feats, labels, valid, recent, tgt, w1, w2, 0.05)
    trained = vos.propagate_labels(feats.requires_grad_(), labels, valid, recent, tgt, w1, w2, 0.05)
    assert trained.requires_grad and torch.equal(served, trained.detach())


def test_train_vos_cli(capsys):
    """tests/test_train_apps.py::test_train_vos_cli on the port."""
    metrics = train_vos.main(["--steps", "4", "--size", "48", "--batch", "2", "--clip-len", "3", "--num-seqs", "1",
                              "--log-every", "2", "--mesh", "none", "--device", "cpu"])
    assert np.isfinite(float(metrics["loss"]))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [line["step"] for line in lines] == [2, 4]


def test_train_vos_rollout_warm_start_and_mesh(capsys):
    """--rollout with --init-npz (the shipped width 96) and a hard world;
    a width that differs from the npz's raises; a --mesh in a world of one
    rank trains on one device, and a mesh whose size is not the world's
    raises."""
    metrics = train_vos.main(["--steps", "2", "--size", "32", "--batch", "2", "--clip-len", "3", "--num-seqs", "2",
                              "--log-every", "1", "--rollout", "--world", "hard", "--init-npz",
                              "checkpoints/vos_params.npz", "--width", "96", "--device", "cpu"])
    assert set(metrics) == {"ce", "bal_ce", "iou", "iou_last", "loss"}
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(ValueError, match="width 96"):
        train_vos.main(["--steps", "1", "--size", "32", "--init-npz", "checkpoints/vos_params.npz", "--device", "cpu"])
    metrics = train_vos.main(["--steps", "1", "--size", "32", "--mesh", "4", "--device", "cpu"])
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(ValueError, match="has 4 ranks, the world 1"):
        make_mesh({"data": 4})


def test_run_vos_reads_the_trainers_checkpoint(tmp_path):
    """train_vos writes <ckpt>/params; run_vos --checkpoint <ckpt>/params
    loads a VOSNet of the width it holds and writes a mask per frame."""
    ckpt = tmp_path / "ck"
    train_vos.main(["--steps", "2", "--size", "32", "--batch", "2", "--clip-len", "3", "--num-seqs", "1",
                    "--width", "16", "--ckpt-dir", str(ckpt), "--ckpt-every", "1", "--device", "cpu"])
    assert json.loads((ckpt / "meta.json").read_text())["step"] == 2
    seq = render_synthetic_sequence(num_frames=3, H=32, W=32)
    img_dir = tmp_path / "rgb"
    img_dir.mkdir()
    for i in range(3):
        write_png(str(img_dir / f"{i:04d}.png"), (np.stack([seq.gray[i]] * 3, -1) * 255).astype(np.uint8))
    write_png(str(tmp_path / "init.png"), seq.mask[0].astype(np.uint8) * 255)
    prop = run_vos.main(["--img_dir", str(img_dir), "--init_mask_file", str(tmp_path / "init.png"),
                         "--mask_save_dir", str(tmp_path / "m"), "--checkpoint", str(ckpt / "params"),
                         "--device", "cpu"])
    assert prop.model.width == 16
    trained = vos.VOSNet(width=16)
    from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state

    trained.load_state_dict(restore_tracker_state(str(ckpt / "params"), trained.state_dict()))
    for k, v in trained.state_dict().items():
        assert torch.equal(prop.model.state_dict()[k], v), k
    assert sorted(os.listdir(tmp_path / "m")) == ["0000.png", "0001.png", "0002.png"]
    assert read_png(str(tmp_path / "m" / "0002.png")).shape == (32, 32)
