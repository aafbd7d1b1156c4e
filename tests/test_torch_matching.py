"""Parity of the port's matching (pairwise, landmarks, fused matcher) with the JAX package.

The fused matcher's plain PyTorch version is held against the Pallas kernel
run in interpret mode (as tests/test_pallas_kernels.py runs it), on that
file's three cases plus a case built from two rendered frames.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.frontend.classical import harris_keypoints_and_descriptors as j_harris
from bundletrack_tpu.frontend.pipeline import _lift_to_3d as j_lift
from bundletrack_tpu.matching import mappoints as jmp
from bundletrack_tpu.matching import pairwise as jpw
from bundletrack_tpu.ops.depth import process_depth as j_process_depth
from bundletrack_tpu.ops.pointcloud import depth_to_cloud_and_normals as j_cloud
from bundletrack_tpu.config import DepthProcessingConfig
from bundletrack_tpu.pallas_kernels import fused_mutual_match as j_fused
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.kernels import matching as km
from bundletrack_tpu_torch.matching import mappoints as tmp
from bundletrack_tpu_torch.matching import pairwise as tpw
from bundletrack_tpu_torch.ops.scatter import set_last_wins
from bundletrack_tpu_torch.ops.topk import topk_stable

torch.set_num_threads(2)

DIST_ATOL = 1e-4  # bf16-product dot summed in another order: ~1e-6 on O(1) distances
MUTUAL_AGREE = 0.99  # a near-tie in the column minimum may flip a row's mutual flag


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_case(seed, P, N, D, shuffle=True):
    rng = np.random.RandomState(seed)
    desc = rng.randn(P, 2, N, D).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    pts = rng.rand(P, 2, N, 3).astype(np.float32)
    nrm = np.zeros((P, 2, N, 3), np.float32)
    nrm[..., 2] = -1.0
    valid = np.ones((P, 2, N), bool)
    if shuffle:  # side B is a shuffled noisy copy of A, so true matches exist
        for p in range(P):
            perm = rng.permutation(N)
            desc[p, 1] = desc[p, 0][perm] + 0.001 * rng.randn(N, D)
            pts[p, 1] = pts[p, 0][perm]
    return [desc[:, 0], desc[:, 1], pts[:, 0], pts[:, 1], nrm[:, 0], nrm[:, 1], valid[:, 0], valid[:, 1]]


def _frame_features(seq, f, top_k, patch):
    depth = j_process_depth(jnp.asarray(seq.depth[f]), DepthProcessingConfig())
    pts, nrm, val = j_cloud(depth, jnp.asarray(seq.K))
    mask = jnp.asarray(seq.mask[f]) & (depth > 0.1)
    out = j_harris(jnp.asarray(seq.gray[f]), mask, top_k=top_k, patch=patch, sigma=1.0,
                   z_map=pts[..., 2], patch_z0=0.55)
    feats = j_lift(out, pts, nrm, val & mask)
    return [np.array(a) for a in (feats.desc, feats.pts, feats.normals, feats.valid)]


@pytest.fixture(scope="module")
def rendered():
    """Keypoints (top_k=128) of three rendered frames and their true poses."""
    seq = render_synthetic_sequence(num_frames=3, H=120, W=160, orbit_deg_per_frame=4.0)
    feats = {patch: [_frame_features(seq, f, 128, patch) for f in range(3)] for patch in (8, 16)}
    poses = np.linalg.inv(seq.ob_in_cam).astype(np.float32)  # cam -> model
    return feats, poses


def _rendered_kernel_case(rendered):
    feats, poses = rendered
    f8 = feats[8]  # 8x8 patches: D=64
    pairs = [(0, 1), (1, 0), (0, 0)]
    world = [np.einsum("ij,nj->ni", poses[f][:3, :3], f8[f][1]) + poses[f][:3, 3] for f in range(2)]
    wnrm = [np.einsum("ij,nj->ni", poses[f][:3, :3], f8[f][2]) for f in range(2)]
    st = lambda xs: np.stack(xs).astype(xs[0].dtype)
    return [
        st([f8[i][0] for i, _ in pairs]), st([f8[j][0] for _, j in pairs]),
        st([world[i] for i, _ in pairs]).astype(np.float32), st([world[j] for _, j in pairs]).astype(np.float32),
        st([wnrm[i] for i, _ in pairs]).astype(np.float32), st([wnrm[j] for _, j in pairs]).astype(np.float32),
        st([f8[i][3] for i, _ in pairs]), st([f8[j][3] for _, j in pairs]),
    ]


def _kernel_cases(rendered):
    shuffled = _random_case(0, 2, 64, 32)
    gated = _random_case(1, 1, 32, 16, shuffle=False)
    gated[3] = gated[3] + 10.0  # every column out of gate range
    half = _random_case(2, 1, 32, 16, shuffle=False)
    half[1], half[3], half[5] = half[0], half[2], half[4]  # A against itself
    half[6] = half[6].copy()
    half[6][0, 16:] = False
    return {
        "shuffled": (shuffled, 0.05),
        "all_gated": (gated, 0.05),
        "half_invalid": (half, 0.05),
        "rendered_P3_N128_D64": (_rendered_kernel_case(rendered), 0.02),
    }


@pytest.mark.parametrize("case", ["shuffled", "all_gated", "half_invalid", "rendered_P3_N128_D64"])
def test_fused_plain_version_matches_pallas_interpret(rendered, case):
    args, max_dist = _kernel_cases(rendered)[case]
    got = km.fused_mutual_match(*(_t(a) for a in args), max_dist=max_dist, max_normal_deg=45.0)
    ref = j_fused(*(jnp.asarray(a) for a in args), max_dist=max_dist, max_normal_deg=45.0, interpret=True)
    bb, dd, mm = (g.numpy() for g in got)
    rb, rd, rm = (np.asarray(r) for r in ref)
    # the gate is exact f32 on both sides: the same rows have a candidate
    np.testing.assert_array_equal(dd < 1e30, rd < 1e30)
    has = rd < 1e30
    np.testing.assert_allclose(dd[has], rd[has], atol=DIST_ATOL)
    assert (mm == rm).mean() >= MUTUAL_AGREE
    both = mm & rm
    np.testing.assert_array_equal(bb[both], rb[both])  # the emitted matches: exact
    if case == "all_gated":
        assert not mm.any()
    if case == "half_invalid":
        assert mm[0, :16].all() and not mm[0, 16:].any()
    if case.startswith("rendered"):
        assert mm.sum() > 50


def test_fused_wrapper_counts_only_launches():
    before = km.launches
    km.fused_mutual_match(*(_t(a) for a in _random_case(3, 1, 16, 8)), max_dist=0.05, max_normal_deg=45.0)
    assert km.launches == before  # CPU tensors take the plain version


def _match_args(rendered, fa, fb, lib):
    feats, poses = rendered
    a, b = feats[16][fa], feats[16][fb]
    conv = _t if lib == "torch" else jnp.asarray
    return [conv(x) for x in (a[0], a[1], a[2], a[3], poses[fa], b[0], b[1], b[2], b[3], poses[fb])]


@pytest.mark.parametrize("fa,fb", [(1, 0), (2, 0)])
def test_match_pair(rendered, fa, fb):
    kw = dict(max_dist=0.03, max_normal_deg=45.0, max_matches=64)
    got = tpw.match_pair(*_match_args(rendered, fa, fb, "torch"), **kw)
    ref = jpw.match_pair(*_match_args(rendered, fa, fb, "jax"), **kw)
    # same f32 identity-form gate on both sides; matches compared exactly
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx_a.numpy(), np.asarray(ref.idx_a))
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(ref.idx_b))
    assert int(got.valid.sum()) > 10


def test_match_pairs_batched_fused_route(rendered):
    feats, poses = rendered
    f16 = feats[16]
    tables = [np.stack([f[k] for f in f16]) for k in range(4)]
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(3, k=1))
    pv = np.array([True, True, False])
    kw = dict(max_dist=0.02, max_normal_deg=45.0, max_matches=64)
    got = tpw.match_pairs_batched(*(_t(a) for a in (*tables, poses, pi, pj, pv)), **kw)
    ref = jpw.match_pairs_batched(*(jnp.asarray(a) for a in (*tables, poses, pi, pj, pv)),
                                  backend="pallas_interpret", **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.idx_a.numpy()[v], np.asarray(ref.idx_a)[v])
    np.testing.assert_array_equal(got.idx_b.numpy()[v], np.asarray(ref.idx_b)[v])
    assert v[:2].sum() > 20 and not v[2].any()


def _match_result(rng, n, m, num_kpts, dup=True):
    idx_a = rng.randint(0, num_kpts, m).astype(np.int32)
    if not dup:
        idx_a = rng.permutation(num_kpts)[:m].astype(np.int32)
    return (idx_a, rng.randint(0, num_kpts, m).astype(np.int32), rng.rand(m) > 0.3)


@pytest.mark.parametrize("batched", [False, True])
def test_merge_matches_tie_order(batched):
    rng = np.random.RandomState(5)
    N, M = 40, 16
    B = 3 if batched else 1
    fresh = [_match_result(rng, N, M, N, dup=False) for _ in range(B)]
    extra = [_match_result(rng, N, M, N, dup=True) for _ in range(B)]  # repeated idx_a
    st = lambda rs, k: np.stack([r[k] for r in rs]) if batched else rs[0][k]
    fr = [st(fresh, k) for k in range(3)]
    ex = [st(extra, k) for k in range(3)]
    got = tpw.merge_matches(tpw.MatchResult(*map(_t, fr)), tpw.MatchResult(*map(_t, ex)), N, M)
    ref = jpw.merge_matches(jpw.MatchResult(*map(jnp.asarray, fr)), jpw.MatchResult(*map(jnp.asarray, ex)), N, M)
    # every kept row scores 1.0: the order is decided by ties alone, and the
    # stable top-k must reproduce lax.top_k's lower-index-first order exactly
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_topk_stable_tie_order():
    x = np.random.RandomState(6).randint(0, 4, (3, 50)).astype(np.float32)
    x[0, :5] = -np.inf
    v, i = topk_stable(_t(x), 20)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 20)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_set_last_wins_matches_drop_mode():
    rng = np.random.RandomState(7)
    dst = rng.randint(-1, 9, 30).astype(np.int32)
    idx = rng.randint(0, 30, 40)  # many repeats
    vals = rng.randint(0, 100, 40).astype(np.int32)
    keep = rng.rand(40) > 0.3
    got = set_last_wins(_t(dst), _t(idx), _t(vals), _t(keep))
    ref = jnp.asarray(dst).at[jnp.where(jnp.asarray(keep), jnp.asarray(idx), 30)].set(jnp.asarray(vals), mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _random_table(rng, L, K, N):
    obs = np.where(rng.rand(L, K) < 0.4, rng.randint(0, N, (L, K)), -1).astype(np.int32)
    rev = np.where(rng.rand(K, N) < 0.3, rng.randint(0, L, (K, N)), -1).astype(np.int32)
    return obs, rev


@pytest.mark.parametrize("batched", [False, True])
def test_propagate_matches(batched):
    rng = np.random.RandomState(8)
    obs, rev = _random_table(rng, 64, 5, 32)
    si = np.array([0, 1, 3]) if batched else np.array(1)
    sj = np.array([4, 2, 1]) if batched else np.array(3)
    got = tmp.propagate_matches(tmp.MapPointTable(_t(obs), _t(rev)), _t(si), _t(sj), 16)
    jt = jmp.MapPointTable(jnp.asarray(obs), jnp.asarray(rev))
    if batched:
        ref = jax.vmap(lambda a, b: jmp.propagate_matches(jt, a, b, 16))(jnp.asarray(si), jnp.asarray(sj))
    else:
        ref = jmp.propagate_matches(jt, jnp.asarray(si), jnp.asarray(sj), 16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("capacity", [12, 200])  # 12: the table runs out of free rows
def test_update_mappoints_and_forget(capacity):
    rng = np.random.RandomState(9)
    K, N, M = 4, 24, 10
    tt = tmp.init_mappoints(capacity, K, N)
    jt = jmp.init_mappoints(capacity, K, N)
    for step in range(6):
        si, sj = rng.choice(K, 2, replace=False)
        m = (rng.permutation(N)[:M].astype(np.int32), rng.randint(0, N, M).astype(np.int32), rng.rand(M) > 0.2)
        tt = tmp.update_mappoints(tt, torch.tensor(si), torch.tensor(sj), tpw.MatchResult(*map(_t, m)))
        jt = jmp.update_mappoints(jt, jnp.asarray(si), jnp.asarray(sj), jpw.MatchResult(*map(jnp.asarray, m)))
        if step == 3:
            tt = tmp.forget_frame(tt, torch.tensor(1))
            jt = jmp.forget_frame(jt, jnp.asarray(1))
        np.testing.assert_array_equal(tt.obs.numpy(), np.asarray(jt.obs))
        np.testing.assert_array_equal(tt.rev.numpy(), np.asarray(jt.rev))
