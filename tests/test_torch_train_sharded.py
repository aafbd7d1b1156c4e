"""The port's sharded training steps against the JAX package's, on gloo ranks.

The port side runs as gloo ranks spawned on the CPU (bodies in
tests/torch_mesh_ranks.py), the JAX side on the virtual 8-device mesh of
tests/conftest.py.  JAX's `make_sharded_lfnet_train_step` and
`make_sharded_vos_train_step` take any optax transformation: here one
whose state becomes the gradient, so one step hands back the gradients of
the global loss that the sharded JAX step computes.  The port's ranks
carry the same weights over (`lfnet_state_dict_from_flax`,
`vos_state_dict_from_flax`), take the same global batch, each its block,
and their summed gradients (fc1 / fc2 gathered over "model") are held to
JAX's at tests/test_torch_train_lfnet.py's and tests/test_torch_train_vos.py's
one-device tolerances.  Also: the trainer CLIs under two ranks
(`train_lfnet --mesh 1,2`, `train_vos --mesh 2`) and rank 0's checkpoint
resumed on one device.  One world-4 and one world-2 spawn serve the file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from bundletrack_tpu.models import vos as jvos
from bundletrack_tpu.models.lfnet_train import LFNetTrainBatch as JaxLFNetBatch
from bundletrack_tpu.models.vos_train import VOSTrainBatch as JaxVOSBatch
from bundletrack_tpu.parallel import make_mesh as j_make_mesh
from bundletrack_tpu.parallel import make_sharded_lfnet_train_step as j_sharded_lfnet
from bundletrack_tpu.parallel import make_sharded_vos_train_step as j_sharded_vos
from bundletrack_tpu_torch.apps import train_lfnet
from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.frontend.lfnet import LFNet, lfnet_state_dict_from_flax
from bundletrack_tpu_torch.models import vos
from bundletrack_tpu_torch.parallel import distributed
from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state
from test_torch_train_lfnet import (
    CLI_ARGS,
    FLIP_GRAD_COS_MIN,
    GRAD_FLOOR,
    GRAD_TOL,
    LOSS_RTOL,
    SMALL,
    _flat,
    _flipped_modules,
    _hard_batch,
    _identity_batch,
    _jax_loss_grads_and_acts,
    _jax_model,
    _port_loss_grads_and_acts,
)
from test_torch_train_vos import _batch as _vos_batch

torch.set_num_threads(2)

RANK_TIMEOUT_S, JOIN_S = 120.0, 480.0  # a collective's wait; the spawn's whole budget
LFNET_MESH = {"data": 2, "model": 2}
VOS_WIDTH, VOS_OUT_DIM, VOS_HW = 8, 16, (32, 32)
BATCHES = {"identity-warp": _identity_batch, "hard-world-roi": _hard_batch}


def _capture_gradients():
    """An optax transformation whose new state is the gradient it is given
    and whose update is zero."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_ranks"))
    res = {}
    model, params = _jax_model()
    sd = _numpy(lfnet_state_dict_from_flax(_flat(params)))
    jobs4 = []
    for name, make in BATCHES.items():
        batch = make()
        step, p, opt = j_sharded_lfnet(model, _capture_gradients(), params, j_make_mesh(LFNET_MESH))
        _, grads, metrics = step(p, opt, JaxLFNetBatch(*(jnp.asarray(batch[k]) for k in JaxLFNetBatch._fields)))
        res[name] = (float(metrics["loss"]), {k: float(v) for k, v in metrics.items()}, _flat(grads), batch)
        jobs4.append(("lfnet_train_rank", (FrontendConfig(**SMALL), sd, batch, LFNET_MESH, name)))

    jm = jvos.VOSNet(out_dim=VOS_OUT_DIM, width=VOS_WIDTH)
    jp = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, *VOS_HW, 3)))["params"]
    vsd = _numpy(vos.vos_state_dict_from_flax(_flat(jp)))
    clips, labels = _vos_batch()
    jobs2 = []
    for rollout in (False, True):
        step, p, opt = j_sharded_vos(jm, _capture_gradients(), jp, j_make_mesh({"data": 2}), VOS_HW,
                                     rollout=rollout)
        _, grads, metrics = step(p, opt, JaxVOSBatch(jnp.asarray(clips), jnp.asarray(labels)))
        res[f"vos_{rollout}"] = ({k: float(v) for k, v in metrics.items()}, _flat(grads))
        jobs2.append(("vos_train_rank", (vsd, {"clips": clips, "labels": labels}, rollout, VOS_WIDTH,
                                         VOS_OUT_DIM)))

    lf_ckpt, vos_ckpt = f"{out}/lfnet_ckpt", f"{out}/vos_ckpt"
    small = CLI_ARGS[:-4]  # the small widths, without --mesh none --device cpu
    jobs2.append(("cli_rank", ("train_lfnet", ["--steps", "2", "--ckpt-dir", lf_ckpt, "--ckpt-every", "2",
                                               "--mesh", "1,2", "--device", "cpu"] + small)))
    jobs2.append(("cli_rank", ("train_vos", ["--steps", "2", "--size", "32", "--batch", "2", "--clip-len", "3",
                                             "--num-seqs", "1", "--width", str(VOS_WIDTH), "--ckpt-dir",
                                             vos_ckpt, "--mesh", "2", "--device", "cpu"])))
    for world, jobs in ((4, jobs4), (2, jobs2)):
        distributed.spawn_ranks(ranks.run_jobs, world, (out, jobs), backend="gloo", device="cpu",
                                timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
    return out, res, (model, params), (lf_ckpt, vos_ckpt)


def _assert_no_jax(results):
    for r, res in enumerate(results):
        assert res["forbidden_modules"] == [], (r, res["forbidden_modules"])


@pytest.mark.parametrize("name", list(BATCHES))
def test_dp_tp_lfnet_step_matches_jax(runs, name):
    out, res, (model, params), _ = runs
    j_loss, j_metrics, j_grads, batch = res[name]
    got = ranks.load(out, f"lfnet_train_{name}", 4, job="lfnet_train_rank")
    _assert_no_jax(got)
    # fc1 / fc2 really split over "model": a half of each on every rank, Adam's state alike
    for r in got:
        assert r["shapes"]["descriptor.fc1.weight"][0] == 256 and r["shapes"]["descriptor.fc2.weight"][1] == 256
        assert r["shapes"]["descriptor.fc1_norm.scale"] == (256,)
        assert r["adam_shapes"] == r["shapes"]
    for r in got[1:]:  # every rank reports the global loss and the same summed gradients
        assert r["metrics"] == got[0]["metrics"]
        for k, g in r["grads"].items():
            assert torch.equal(g, got[0]["grads"][k]), k
    m = got[0]["metrics"]
    assert abs(m["loss"] - j_loss) <= LOSS_RTOL * abs(j_loss), (m["loss"], j_loss)
    for k in ("det_loss", "desc_loss"):
        assert abs(m[k] - j_metrics[k]) <= LOSS_RTOL * max(abs(j_metrics[k]), 1e-12), (k, m[k], j_metrics[k])

    # tests/test_torch_train_lfnet.py's gradient bars, the ReLU flips found
    # from the one-device forwards of both packages on this batch
    _, _, _, j_acts = _jax_loss_grads_and_acts(model, params, batch)
    net = LFNet(FrontendConfig(**SMALL))
    net.load_state_dict(lfnet_state_dict_from_flax(_flat(params)))
    _, _, p_acts = _port_loss_grads_and_acts(net, batch)
    flipped = _flipped_modules(j_acts, p_acts)
    ref = lfnet_state_dict_from_flax(j_grads)
    names = [n for n, _ in net.named_parameters()]
    assert set(ref) == set(names) == set(got[0]["grads"])
    last = max((i for i, n in enumerate(names) if n.rsplit(".", 1)[0] in flipped), default=-1)
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for i, n in enumerate(names):
        want, g = ref[n].numpy(), got[0]["grads"][n].numpy()
        if float(np.abs(want).max()) < GRAD_FLOOR * gmax:
            assert float(np.abs(g).max()) < GRAD_FLOOR * gmax, n
        elif i <= last:
            cos = float((g * want).sum() / (np.linalg.norm(g) * np.linalg.norm(want)))
            assert cos >= FLIP_GRAD_COS_MIN, (n, cos, flipped)
        else:
            assert float(np.abs(g - want).max()) <= GRAD_TOL * float(np.abs(want).max()), (
                n, float(np.abs(g - want).max()), float(np.abs(want).max()))


@pytest.mark.parametrize("rollout", [False, True], ids=["vos_loss", "vos_rollout_loss"])
def test_dp_vos_step_matches_jax(runs, rollout):
    from test_torch_train_vos import GRAD_FLOOR as V_FLOOR
    from test_torch_train_vos import GRAD_TOL as V_TOL
    from test_torch_train_vos import LOSS_RTOL as V_LOSS_RTOL

    out, res, _, _ = runs
    j_metrics, j_grads = res[f"vos_{rollout}"]
    got = ranks.load(out, f"vos_train_{rollout}", 2, job="vos_train_rank")
    _assert_no_jax(got)
    assert got[0]["metrics"] == got[1]["metrics"]
    for k in j_metrics:  # the loss, ce, bal_ce and the IoUs of the whole batch
        assert abs(got[0]["metrics"][k] - j_metrics[k]) <= V_LOSS_RTOL * max(abs(j_metrics[k]), 1e-6), (
            k, got[0]["metrics"][k], j_metrics[k])
    ref = vos.vos_state_dict_from_flax(j_grads)
    assert set(ref) == set(got[0]["grads"])
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for n, want in ref.items():
        want, g = want.numpy(), got[0]["grads"][n].numpy()
        np.testing.assert_array_equal(g, got[1]["grads"][n].numpy())
        if float(np.abs(want).max()) < V_FLOOR * gmax:
            assert float(np.abs(g).max()) < V_FLOOR * gmax, n
        else:
            assert float(np.abs(g - want).max()) <= V_TOL * float(np.abs(want).max()), n


def test_trainer_clis_over_two_ranks_and_the_checkpoints_resume_on_one_device(runs, capsys):
    out, _, _, (lf_ckpt, vos_ckpt) = runs
    for tool in ("train_lfnet", "train_vos"):
        got = ranks.load(out, tool, 2, job="cli_rank")
        _assert_no_jax(got)
        assert got[0]["metrics"] == got[1]["metrics"] and np.isfinite(got[0]["metrics"]["loss"]), tool
    # the sharded run wrote whole tensors: one device resumes from them
    assert json.load(open(f"{lf_ckpt}/meta.json"))["step"] == 2
    metrics = train_lfnet.main(["--steps", "3", "--resume", "--ckpt-dir", lf_ckpt] + CLI_ARGS)
    assert np.isfinite(float(metrics["loss"]))
    assert json.load(open(f"{lf_ckpt}/meta.json"))["step"] == 3
    model = vos.VOSNet(width=VOS_WIDTH)
    sd = restore_tracker_state(f"{vos_ckpt}/params", model.state_dict())
    model.load_state_dict(sd)
    assert all(bool(torch.isfinite(v).all()) for v in sd.values())
