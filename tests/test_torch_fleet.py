"""The port's fleet step against the JAX fleet step, and GN early stopping.

Three streams of differently seeded rendered sequences go through the JAX
package's `make_fleet_step` (no mesh: a plain vmap of the tracker step, its
BA matcher in Pallas interpret mode so its gate is the port's exact-f32
gate) and through the port's `make_fleet_step`, which is handed the RANSAC
phases that jax.random draws from each stream's key.  One JAX compile is
shared by the file through a module fixture.
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
    FrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig,
)
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.geometry.se3 import se3_exp as j_se3_exp
from bundletrack_tpu.parallel import init_fleet_state as j_init_fleet_state
from bundletrack_tpu.parallel import make_fleet_step as j_make_fleet_step
from bundletrack_tpu.solver import gauss_newton as jgn
from bundletrack_tpu.solver import residuals as jres
from bundletrack_tpu.tracker.state import FrameObservation as JaxObservation
from bundletrack_tpu_torch import config as tcfg
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step, make_mesh
from bundletrack_tpu_torch.solver import gauss_newton as tgn
from bundletrack_tpu_torch.solver import residuals as tres
from bundletrack_tpu_torch.tracker.driver import Tracker
from bundletrack_tpu_torch.tracker.state import (
    fleet_state_from_numpy,
    fleet_state_to_numpy,
    set_streams,
)
from jax_draws import phases_from_key

torch.set_num_threads(2)

S, H, W, F = 3, 96, 128, 4
# fleet trajectory against the JAX fleet, per stream and frame: f32
# summation order only (the single-stream tracker test measures <= 6e-7 m
# and 1e-5 deg); the bars of tests/test_torch_tracker.py
SEQ_TRANS_TOL = 1e-4  # m
SEQ_ROT_TOL = 0.01  # deg
STEP_TRANS_TOL = 1e-3  # one step from the same state
STEP_ROT_TOL = 0.1
COUNT_TOL = 2  # inlier / edge counts: a residual at a threshold may flip
# a fleet's stream against a single-stream Tracker on the same frames and
# phases: batched products and reductions may sum in another order (on
# this CPU build they do not: the difference measured 0)
STREAM_VS_SINGLE_TOL = 1e-5  # max |pose entry difference|
POSE_ATOL = 1e-4  # GN early stop against JAX: f32 solves, summation order differs


def jax_cfg():
    """tests/test_fleet.py::tiny_cfg with the Pallas matcher in interpret mode."""
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4, num_iter_outer=3),
        keyframe=KeyframeConfig(pool_size=4, min_rot=5.0),
        frontend=FrontendConfig(top_k=64),
        ransac=RansacConfig(max_iter=128),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=64, image_h=H, image_w=W),
    )


def port_cfg():
    return load_config(dataclasses.asdict(jax_cfg()))


def fleet_phases(rng_keys, cfg):
    per_stream = [phases_from_key(k, cfg) for k in rng_keys]
    return tuple(torch.from_numpy(np.stack(p)) for p in zip(*per_stream))


def frame_arrays(seqs, f):
    return (np.stack([s.gray[f] for s in seqs]), np.stack([s.depth[f] for s in seqs]),
            np.stack([s.mask[f] for s in seqs]), np.stack([s.K for s in seqs]))


def init_poses(seqs):
    return np.stack([np.linalg.inv(s.ob_in_cam[0]) for s in seqs]).astype(np.float32)


def run_port_fleet(seqs, phases, state=None, frames=range(F)):
    step = make_fleet_step(port_cfg(), H, W)
    if state is None:
        state = init_fleet_state(port_cfg(), H, W, len(seqs), device="cpu")
    ip = torch.from_numpy(init_poses(seqs))
    outs = []
    for f in frames:
        state, out = step(state, fleet_observation(*frame_arrays(seqs, f), "cpu"), ip, phases[f])
        outs.append(out)
    return state, outs


@pytest.fixture(scope="module")
def sequences():
    return [render_synthetic_sequence(num_frames=F, H=H, W=W, seed=s, orbit_deg_per_frame=3.0)
            for s in range(S)]


@pytest.fixture(scope="module")
def jax_step():
    """The JAX fleet step, compiled once for the file."""
    return j_make_fleet_step(jax_cfg(), H, W)


def run_jax_fleet(step, sequences, reset=None):
    """The JAX fleet over the S streams: its state before each frame (numpy),
    the phases each frame draws, and its outputs.  `reset` = (frame, stream):
    before that frame the stream's leaves are set to a fresh fleet state's
    (the JAX user's reset) and its init pose to its truth at that frame."""
    cfg = jax_cfg()
    state = j_init_fleet_state(cfg, H, W, S)
    ip = init_poses(sequences)
    states, phases, outs = [], [], []
    for f in range(F):
        if reset is not None and f == reset[0]:
            fresh = j_init_fleet_state(cfg, H, W, S)
            state = jax.tree.map(lambda a, b: a.at[reset[1]].set(b[reset[1]]), state, fresh)
            ip = join_poses(sequences, reset[1], f)
        states.append(jax.tree.map(np.array, state))
        phases.append(fleet_phases(states[-1].rng_key, cfg))
        obs = JaxObservation(*(jnp.asarray(a) for a in frame_arrays(sequences, f)))
        state, out = step(state, obs, jnp.asarray(ip))
        outs.append(jax.tree.map(np.array, out))
    return states, phases, outs


def join_poses(sequences, stream, f):
    """The init poses with `stream`'s set to its truth at frame f."""
    ip = init_poses(sequences)
    ip[stream] = np.linalg.inv(sequences[stream].ob_in_cam[f])
    return ip


@pytest.fixture(scope="module")
def jax_fleet(sequences, jax_step):
    return run_jax_fleet(jax_step, sequences)


@pytest.fixture(scope="module")
def port_fleet(sequences, jax_fleet):
    _, phases, _ = jax_fleet
    return run_port_fleet(sequences, phases)[1]


def test_fleet_matches_the_jax_fleet(sequences, jax_fleet, port_fleet):
    _, _, j_out = jax_fleet
    for f in range(F):
        np.testing.assert_array_equal(port_fleet[f].status.numpy(), j_out[f].status)
        for s in range(S):
            rot, trans = pose_errors(port_fleet[f].ob_in_cam[s].numpy(), j_out[f].ob_in_cam[s])
            assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, s, rot, trans)
            assert abs(int(port_fleet[f].num_matches[s]) - int(j_out[f].num_matches[s])) <= COUNT_TOL
            assert abs(int(port_fleet[f].num_ba_edges[s]) - int(j_out[f].num_ba_edges[s])) <= COUNT_TOL
            rot, trans = pose_errors(port_fleet[f].ob_in_cam[s].numpy(), sequences[s].ob_in_cam[f])
            assert rot < 1.0 and trans < 0.005, (f, s, rot, trans)  # the tracker's pose bars


@pytest.mark.parametrize("k", [1, 3])
def test_fleet_step_from_a_jax_fleet_state(sequences, jax_fleet, k):
    j_states, phases, j_out = jax_fleet
    state = fleet_state_from_numpy(j_states[k]._asdict(), "cpu")
    assert state.frame_count == (k,) * S
    state, outs = run_port_fleet(sequences, phases, state=state, frames=[k])
    np.testing.assert_array_equal(outs[0].status.numpy(), j_out[k].status)
    for s in range(S):
        rot, trans = pose_errors(outs[0].pose_in_model[s].numpy(), j_out[k].pose_in_model[s])
        assert rot < STEP_ROT_TOL and trans < STEP_TRANS_TOL, (s, rot, trans)
    back = fleet_state_to_numpy(state)
    assert back["kf_desc"].shape[0] == S
    np.testing.assert_array_equal(back["frame_count"], np.full(S, k + 1, np.int32))


def test_fleet_state_round_trip_and_lockstep(jax_fleet):
    ref = jax_fleet[0][2]._asdict()
    back = fleet_state_to_numpy(fleet_state_from_numpy(ref, "cpu"))
    for name, val in back.items():
        want = ref[name]
        if name == "mappoints":
            np.testing.assert_array_equal(val["obs"], want.obs)
            np.testing.assert_array_equal(val["rev"], want.rev)
        else:
            np.testing.assert_array_equal(np.atleast_1d(val).view(np.uint8), np.atleast_1d(want).view(np.uint8))
    # streams at different frames keep their own counts
    uneven = fleet_state_from_numpy(dict(ref, frame_count=np.asarray([2, 2, 3], np.int32)), "cpu")
    assert uneven.frame_count == (2, 2, 3)
    back = fleet_state_to_numpy(uneven)["frame_count"]
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, [2, 2, 3])


# ---- a stream that joins the running fleet ---------------------------------

JOIN = (2, 1)  # stream 1 starts again at frame 2


@pytest.fixture(scope="module")
def join_runs(sequences, jax_step, monkeypatch_module):
    """The JAX fleet and the port's fleet with stream 1 reset at frame 2
    (JAX: the tree update; port: set_streams), the port given JAX's
    phases; and the matcher calls of each port frame (pair counts)."""
    from bundletrack_tpu_torch.matching import pairwise

    jax_res = run_jax_fleet(jax_step, sequences, reset=JOIN)
    phases = jax_res[1]
    calls = []
    matcher = pairwise.fused_mutual_match_pairs
    monkeypatch_module.setattr(pairwise, "fused_mutual_match_pairs",
                               lambda *a, **k: calls.append(len(a[4])) or matcher(*a, **k))
    cfg = port_cfg()
    step = make_fleet_step(cfg, H, W)
    state = init_fleet_state(cfg, H, W, S, device="cpu")
    ip = init_poses(sequences)
    outs, per_frame, counts = [], [], []
    for f in range(F):
        if f == JOIN[0]:
            state = set_streams(state, [JOIN[1]], init_fleet_state(cfg, H, W, S, device="cpu"))
            ip = join_poses(sequences, JOIN[1], f)
        n = len(calls)
        state, out = step(state, fleet_observation(*frame_arrays(sequences, f), "cpu"), torch.from_numpy(ip),
                          phases[f])
        outs.append(out)
        per_frame.append(calls[n:])
        counts.append(state.frame_count)
    return jax_res, outs, per_frame, counts, state


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_a_joining_stream_matches_the_jax_fleet(sequences, join_runs):
    """Every stream and frame of the mixed fleet against JAX's; the counts
    per stream; one matcher call per frame, on the running streams' pairs."""
    (j_states, _, j_out), outs, per_frame, counts, state = join_runs
    for f in range(F):
        np.testing.assert_array_equal(outs[f].status.numpy(), j_out[f].status)
        for s in range(S):
            rot, trans = pose_errors(outs[f].ob_in_cam[s].numpy(), j_out[f].ob_in_cam[s])
            assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, s, rot, trans)
            assert abs(int(outs[f].num_matches[s]) - int(j_out[f].num_matches[s])) <= COUNT_TOL
            assert abs(int(outs[f].num_ba_edges[s]) - int(j_out[f].num_ba_edges[s])) <= COUNT_TOL
            rot, trans = pose_errors(outs[f].ob_in_cam[s].numpy(), sequences[s].ob_in_cam[f])
            assert rot < 1.0 and trans < 0.005, (f, s, rot, trans)
    # the joining stream's first pose is its init pose, its truth at frame 2
    np.testing.assert_allclose(outs[JOIN[0]].pose_in_model[JOIN[1]].numpy(),
                               join_poses(sequences, *JOIN[::-1])[JOIN[1]], atol=1e-6)
    assert counts == [(1, 1, 1), (2, 2, 2), (3, 1, 3), (4, 2, 4)]
    assert [int(c) for c in j_states[JOIN[0]].frame_count] == [2, 0, 2]
    np.testing.assert_array_equal(fleet_state_to_numpy(state)["frame_count"], [4, 2, 4])
    P = len(np.triu_indices(port_cfg().bundle.max_ba_frames, k=1)[0])
    assert per_frame == [[], [S * P], [(S - 1) * P], [S * P]]


def test_all_new_and_all_running_frames_are_unchanged(join_runs, port_fleet):
    """Before the join the mixed run is the plain fleet's, bit for bit."""
    outs = join_runs[1]
    for f in range(JOIN[0]):
        for a, b in zip(outs[f], port_fleet[f]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_a_new_stream_draws_no_phases():
    """Drawn phases: on the mixed frame the running stream's generator
    advances and the new stream's is left as it was, as a Tracker's first
    frame leaves its own; set_streams takes every field of the other state."""
    seqs = [render_synthetic_sequence(num_frames=3, H=H, W=W, seed=s, orbit_deg_per_frame=3.0) for s in range(2)]
    cfg = port_cfg()
    step = make_fleet_step(cfg, H, W)
    state = init_fleet_state(cfg, H, W, 2, device="cpu")
    ip = torch.from_numpy(init_poses(seqs))
    for f in range(2):
        state, _ = step(state, fleet_observation(*frame_arrays(seqs, f), "cpu"), ip)
    fresh = init_fleet_state(cfg, H, W, 2, device="cpu", seed=7)
    joined = set_streams(state, [1], fresh)
    for name, val in fleet_state_to_numpy(joined).items():
        want, was = fleet_state_to_numpy(fresh)[name], fleet_state_to_numpy(state)[name]
        if name == "mappoints":
            val, want, was = val["obs"], want["obs"], was["obs"]
        np.testing.assert_array_equal(val[1], want[1])
        np.testing.assert_array_equal(val[0], was[0])
    assert joined.frame_count == (2, 0) and joined.rng[1] is fresh.rng[1]
    before = [g.get_state().clone() for g in joined.rng]
    joined, out = step(joined, fleet_observation(*frame_arrays(seqs, 2), "cpu"), ip)
    assert torch.equal(joined.rng[1].get_state(), before[1])
    assert not torch.equal(joined.rng[0].get_state(), before[0])
    assert joined.frame_count == (3, 1) and out.status.tolist() == [0, 0]


def test_fleet_streams_equal_single_stream_trackers(sequences, jax_fleet, port_fleet):
    """Stream s of the fleet against a Tracker on sequence s with the same
    phases; a fleet of one against the Tracker exactly."""
    _, phases, _ = jax_fleet
    for s in range(S):
        trk = Tracker(port_cfg(), H, W, device="cpu")
        seq = sequences[s]
        for f in range(F):
            out = trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_poses([seq])[0],
                                    phases=tuple(p[s] for p in phases[f]))
            assert int(out.status) == int(port_fleet[f].status[s])
            diff = float((out.ob_in_cam - port_fleet[f].ob_in_cam[s]).abs().max())
            assert diff <= STREAM_VS_SINGLE_TOL, (s, f, diff)
            if s == 0:
                single = out
        if s == 0:
            _, one = run_port_fleet([seq], [tuple(p[:1] for p in ph) for ph in phases])
            np.testing.assert_array_equal(one[-1].ob_in_cam[0].numpy(), single.ob_in_cam.numpy())


def test_a_failing_stream_leaves_the_others_alone(sequences, jax_fleet, port_fleet):
    """A blank mask in stream 1 makes that stream FAIL; stream 0's poses do
    not move (tests/test_tracker_synthetic.py::TestFailureHandling's bars for
    the failing stream)."""
    _, phases, _ = jax_fleet
    mask, depth = sequences[1].mask.copy(), sequences[1].depth.copy()
    mask[2] = False
    depth[2] = 0.0
    blank = [sequences[0], sequences[1]._replace(mask=mask, depth=depth)]
    two = [tuple(p[:2] for p in ph) for ph in phases]
    _, outs = run_port_fleet(blank, two)
    assert int(outs[2].status[1]) == 1  # STATUS_FAIL
    np.testing.assert_allclose(outs[2].ob_in_cam[1].numpy(), outs[1].ob_in_cam[1].numpy(), atol=1e-5)
    assert int(outs[3].status[1]) in (0, 2)
    for f in range(F):
        assert int(outs[f].status[0]) == int(port_fleet[f].status[0])
        np.testing.assert_array_equal(outs[f].ob_in_cam[0].numpy(), port_fleet[f].ob_in_cam[0].numpy())


def test_mesh_raises_lfnet_builds_and_the_card_is_the_default(tmp_path):
    """A mesh whose size is not the world's raises; a one-rank mesh builds a
    fleet step that holds every stream (tests/test_torch_parallel.py runs
    the sharded fleets); an LF-Net frontend builds a fleet step
    (tests/test_torch_fleet_lfnet.py runs it); the card is the default."""
    with pytest.raises(ValueError, match="has 2 ranks, the world 1"):
        make_mesh({"stream": 2})
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                                         rank=0)
    try:
        mesh = make_mesh({"stream": 1})
        assert callable(make_fleet_step(port_cfg(), H, W, mesh=mesh))
        assert init_fleet_state(port_cfg(), H, W, 3, device="cpu", mesh=mesh).kf_pose.shape[0] == 3
    finally:
        torch.distributed.destroy_process_group()
    lf_cfg = port_cfg().replace(frontend=dataclasses.replace(port_cfg().frontend, kind="lfnet"))
    assert callable(make_fleet_step(lf_cfg, H, W, lfnet_apply=lambda crops: None))
    if torch.cuda.is_available():
        assert init_fleet_state(port_cfg(), H, W, 2).kf_pose.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_fleet_state(port_cfg(), H, W, 2)


# ---- GN early stopping ------------------------------------------------------


def _pose(seed, rot, trans):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.randn(3) * trans, rng.randn(3) * rot]).astype(np.float32)
    return np.array(j_se3_exp(jnp.asarray(xi)))


def _graph(seed, noise, K=4, M=40):
    """K noisy poses (noise scales the perturbation) and sparse
    correspondences of shared model points."""
    rng = np.random.RandomState(seed)
    gt = np.stack([_pose(seed * 10 + k, 0.2, 0.1) for k in range(K)])
    X = (rng.rand(M, 3) - 0.5) * 0.3
    pi, pj = np.triu_indices(K, k=1)
    cam = lambda T, X: (X - T[:3, 3]) @ T[:3, :3]
    pts_i = np.stack([cam(gt[i], X) for i in pi]).astype(np.float32)
    pts_j = np.stack([cam(gt[j], X) + 0.0005 * rng.randn(M, 3) for j in pj]).astype(np.float32)
    valid = rng.rand(len(pi), M) > 0.2
    noisy = np.stack([gt[0]] + [_pose(seed + 50 + k, noise, noise / 2) @ gt[k] for k in range(1, K)])
    return noisy.astype(np.float32), pts_i, pts_j, valid, pi, pj


def _jax_solve(graph, bcfg):
    """JAX's optimize_pose_graph on one graph (traceable under vmap)."""
    poses, pts_i, pts_j, valid, pi, pj = (jnp.asarray(a) for a in graph)
    K = poses.shape[0]
    inputs = jgn.GraphInputs(poses, jnp.ones(K, bool), jnp.arange(K) > 0,
                             jres.SparseCorres(pi.astype(jnp.int32), pj.astype(jnp.int32), pts_i, pts_j, valid))
    return jgn.optimize_pose_graph(inputs, bcfg)[0]


def _jax_iterations(graph, bcfg):
    """JAX discards its while_loop's count: the iterations it ran are the
    fewest fixed iterations that give its early-stopped poses."""
    stopped = np.asarray(_jax_solve(graph, bcfg))
    for n in range(1, bcfg.num_iter_outer + 1):
        fixed = np.asarray(_jax_solve(graph, dataclasses.replace(bcfg, early_stop_delta=0.0, num_iter_outer=n)))
        if np.abs(fixed - stopped).max() <= 1e-6:
            return n, stopped
    raise AssertionError("no fixed iteration count gives the early-stopped poses")


EARLY_STOP = BundleConfig(max_ba_frames=4, num_iter_outer=7, early_stop_delta=0.005, w_dense_depth=0.0)


@pytest.fixture(scope="module")
def early_stop_graphs():
    """Three graphs that JAX stops after 2, 1 and 4 iterations, with JAX's
    count and poses for each."""
    graphs = [_graph(s, noise) for s, noise in ((1, 0.05), (2, 0.002), (3, 0.5))]
    want = [_jax_iterations(g, EARLY_STOP) for g in graphs]
    assert [n for n, _ in want] == [2, 1, 4]
    return graphs, want


@pytest.mark.parametrize("batched", [False, True], ids=["one_graph", "three_graphs"])
def test_early_stop_matches_jax(early_stop_graphs, batched):
    """One graph alone, then three batched graphs that converge at
    different iterations: the poses and each graph's iteration count equal
    JAX's, alone and under vmap (the JAX fleet's form)."""
    bcfg = EARLY_STOP
    graphs, want = early_stop_graphs
    if not batched:
        graphs, want = graphs[:1], want[:1]
    poses, pts_i, pts_j, valid, pi, pj = (np.stack(a) for a in zip(*graphs))
    B, K = poses.shape[:2]
    inputs = tgn.GraphInputs(torch.from_numpy(poses), torch.ones(B, K, dtype=torch.bool), torch.arange(K) > 0,
                             tres.SparseCorres(torch.from_numpy(pi[0]), torch.from_numpy(pj[0]),
                                               torch.from_numpy(pts_i), torch.from_numpy(pts_j),
                                               torch.from_numpy(valid)))
    if not batched:  # one stream's graph: no leading axis
        inputs = inputs._replace(poses=inputs.poses[0], frame_valid=inputs.frame_valid[0],
                                 corres=inputs.corres._replace(pts_i=inputs.corres.pts_i[0],
                                                               pts_j=inputs.corres.pts_j[0],
                                                               valid=inputs.corres.valid[0]))
    got, info = tgn.optimize_pose_graph(inputs, tcfg.BundleConfig(**dataclasses.asdict(bcfg)))
    assert np.atleast_1d(info["iterations"].numpy()).tolist() == [n for n, _ in want]
    got = got.reshape(B, K, 4, 4)
    for b, (_, ref) in enumerate(want):
        np.testing.assert_allclose(got[b].numpy(), ref, atol=POSE_ATOL)
    if batched:
        stacked = [jnp.asarray(np.stack(a)) for a in zip(*graphs)]
        ref = jax.vmap(lambda *g: _jax_solve(g, bcfg))(*stacked)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE_ATOL)


def test_early_stop_in_the_tracker_step_matches_jax():
    """bench.py's tracking configuration (early_stop_delta 0.005) through
    the port's step from a JAX state, against the JAX step."""
    from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
    from bundletrack_tpu_torch.tracker.bundler import make_track_frame
    from bundletrack_tpu_torch.tracker.state import FrameObservation, state_from_numpy

    cfg = jax_cfg()
    cfg = dataclasses.replace(cfg, bundle=dataclasses.replace(cfg.bundle, early_stop_delta=0.005,
                                                              num_iter_outer=7))
    seq = render_synthetic_sequence(num_frames=3, H=H, W=W, orbit_deg_per_frame=3.0)
    ip = np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32)
    jtrk = JaxTracker(cfg, H, W)
    for f in range(2):
        jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, ip)
    j_state = jax.tree.map(np.array, jtrk.state)
    ref = jtrk.process_frame(seq.gray[2], seq.depth[2], seq.mask[2], seq.K, ip)
    pcfg = load_config(dataclasses.asdict(cfg))
    obs = FrameObservation(*(torch.from_numpy(np.array(a)) for a in (seq.gray[2], seq.depth[2], seq.mask[2], seq.K)))
    phases = tuple(torch.from_numpy(np.array(p)) for p in phases_from_key(j_state.rng_key, cfg))
    _, out = make_track_frame(pcfg, H, W)(state_from_numpy(j_state._asdict(), "cpu"), obs,
                                          torch.from_numpy(ip), phases)
    assert int(out.status) == int(ref.status) == 0
    rot, trans = pose_errors(out.pose_in_model.numpy(), np.asarray(ref.pose_in_model))
    assert rot < STEP_ROT_TOL and trans < STEP_TRANS_TOL, (rot, trans)
