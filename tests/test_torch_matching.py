"""Parity of the port's matching (pairwise, landmarks, fused matcher) with the JAX package.

The fused matcher's plain PyTorch versions are held against the Pallas
kernel run in interpret mode (as tests/test_pallas_kernels.py runs it): the
gathered-sides form on that file's three cases plus a case built from two
rendered frames, and the table form on a K=4 frame table (rendered,
random, ragged and exact-tie frames) whose sides are gathered with numpy.
The CUDA kernel itself is held against the plain version on the card by
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


# The table form: a K=4 frame table read through pair indices.  The pairs
# hold a pair in both orders, a frame against itself and a repeated pair.
TABLE_PAIRS = np.array([(0, 1), (1, 0), (0, 0), (2, 3), (3, 1), (0, 1)], np.int32).T


def _rendered_table(rendered, patch):
    """Frames 0-2 as rendered, frame 3 = frame 1 with every other keypoint invalid."""
    feats, poses = rendered
    fs = feats[patch]
    frames = [0, 1, 2, 1]
    desc = np.stack([fs[f][0] for f in frames])
    world = np.stack([np.einsum("ij,nj->ni", poses[f][:3, :3], fs[f][1]) + poses[f][:3, 3] for f in frames])
    wnrm = np.stack([np.einsum("ij,nj->ni", poses[f][:3, :3], fs[f][2]) for f in frames])
    valid = np.stack([fs[f][3] for f in frames])
    valid[3, ::2] = False
    return [desc.astype(np.float32), world.astype(np.float32), wnrm.astype(np.float32), valid], 0.02


def _random_frame_table(seed, N, D):
    """Frame 1 is a shuffled noisy copy of frame 0 (true matches exist);
    frames 2 and 3 are random with a fifth of their keypoints invalid."""
    rng = np.random.RandomState(seed)
    desc = rng.randn(4, N, D).astype(np.float32)
    perm = rng.permutation(N)
    desc[1] = desc[0][perm] + 0.01 * rng.randn(N, D)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    world = rng.rand(4, N, 3).astype(np.float32)
    world[1] = world[0][perm]
    wnrm = rng.randn(4, N, 3).astype(np.float32)
    wnrm /= np.linalg.norm(wnrm, axis=-1, keepdims=True)
    wnrm[1] = wnrm[0][perm]
    valid = np.ones((4, N), bool)
    valid[2:] = rng.rand(2, N) > 0.2
    return [desc, world, wnrm, valid], 0.05


def _tie_frame_table(seed, N, D):
    """Exact ties: descriptors are multiples of 1/64 (every product and
    partial sum is exact in f32, so the dot does not depend on the sum
    order), and keypoint 2m+1 copies keypoint 2m (descriptor, position,
    normal, validity).  Each row then ties between 2m and 2m+1, and the
    first, 2m, must win; duplicated rows tie in the column minimum and are
    both mutual."""
    (desc, world, wnrm, valid), max_dist = _random_frame_table(seed, N, D)
    desc = np.round(desc * 64) / 64
    for t in (desc, world, wnrm, valid):
        t[:, 1::2] = t[:, 0::2]
    return [desc.astype(np.float32), world, wnrm, valid], max_dist


def _table_case(rendered, case):
    if case == "rendered_N128_D64":
        return _rendered_table(rendered, 8)
    if case == "rendered_N128_D256":
        return _rendered_table(rendered, 16)
    if case == "random_N64_D32":
        return _random_frame_table(10, 64, 32)
    if case == "ragged_N50_D30":
        return _random_frame_table(11, 50, 30)
    assert case == "exact_ties_N64_D32"
    return _tie_frame_table(12, 64, 32)


TABLE_CASES = ["rendered_N128_D64", "rendered_N128_D256", "random_N64_D32", "ragged_N50_D30", "exact_ties_N64_D32"]


def _gathered(table):
    """The JAX function's [P, N, ...] sides, gathered with numpy."""
    desc, world, wnrm, valid = table
    pi, pj = TABLE_PAIRS
    return [desc[pi], desc[pj], world[pi], world[pj], wnrm[pi], wnrm[pj], valid[pi], valid[pj]]


@pytest.mark.parametrize("case", TABLE_CASES)
def test_pairs_plain_version_matches_pallas_interpret(rendered, case):
    table, max_dist = _table_case(rendered, case)
    gates = dict(max_dist=max_dist, max_normal_deg=45.0)
    got = km.fused_mutual_match_pairs_reference(*(_t(a) for a in table), *map(_t, TABLE_PAIRS), **gates)
    ref = j_fused(*(jnp.asarray(a) for a in _gathered(table)), interpret=True, **gates)
    bb, dd, mm = (g.numpy() for g in got)
    rb, rd, rm = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(dd < 1e30, rd < 1e30)  # the gate is exact f32 on both sides
    has = rd < 1e30
    np.testing.assert_allclose(dd[has], rd[has], atol=DIST_ATOL)
    assert (mm == rm).mean() >= MUTUAL_AGREE
    both = mm & rm
    np.testing.assert_array_equal(bb[both], rb[both])
    np.testing.assert_array_equal(bb[~has], 0)  # no candidate: index 0, as jnp.argmin
    np.testing.assert_array_equal(rb[~has], 0)
    for r in (bb, dd, mm):  # the repeated pair gives the same rows
        np.testing.assert_array_equal(r[0], r[5])
    if not case.startswith("exact_ties"):
        # a pair and its reverse: a mutual match i -> j of (0, 1) is mutual
        # j -> i in (1, 0), up to near ties that the other sum order may flip
        m01 = np.flatnonzero(mm[0])
        assert (mm[1][bb[0][m01]] & (bb[1][bb[0][m01]] == m01)).mean() >= MUTUAL_AGREE
    assert mm.sum() > 20
    valid = table[3]
    if case.startswith("rendered"):
        # frame 3's invalid keypoints never match, as A (pair 4) or as B (pair 3)
        assert not mm[4][~valid[3]].any()
        assert not np.isin(bb[3][mm[3]], np.flatnonzero(~valid[3])).any()
    if case.startswith("exact_ties"):
        # exact arithmetic on both sides: equal distances, the first of
        # each duplicate wins, and duplicated rows are mutual together
        np.testing.assert_array_equal(dd, rd)
        np.testing.assert_array_equal(mm, rm)
        assert (bb[has] % 2 == 0).all()
        np.testing.assert_array_equal(mm[:, 0::2], mm[:, 1::2])


@pytest.mark.parametrize("case", TABLE_CASES)
def test_pairs_table_form_equals_adapter(rendered, case):
    """The table form and the gathered-sides adapter run the same plain
    arithmetic on the same values on the CPU: equal to the bit."""
    table, max_dist = _table_case(rendered, case)
    gates = dict(max_dist=max_dist, max_normal_deg=45.0)
    got = km.fused_mutual_match_pairs(*(_t(a) for a in table), *map(_t, TABLE_PAIRS), **gates)
    ref = km.fused_mutual_match(*(_t(a) for a in _gathered(table)), **gates)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16])
def test_pairs_take_any_integer_index_type(rendered, dtype):
    table, max_dist = _random_frame_table(13, 32, 16)
    gates = dict(max_dist=max_dist, max_normal_deg=45.0)
    ref = km.fused_mutual_match_pairs(*(_t(a) for a in table), *map(_t, TABLE_PAIRS), **gates)
    got = km.fused_mutual_match_pairs(*(_t(a) for a in table), *(_t(a).to(dtype) for a in TABLE_PAIRS), **gates)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("bad", ["desc_2d", "world_shape", "valid_shape", "pair_length", "float_pairs"])
def test_pairs_reject_bad_arguments(bad):
    desc, world, wnrm, valid = (_t(a) for a in _random_frame_table(14, 16, 8)[0])
    pi, pj = map(_t, TABLE_PAIRS)
    if bad == "desc_2d":
        desc = desc[0]
    elif bad == "world_shape":
        world = world[:, :8]
    elif bad == "valid_shape":
        valid = valid[:3]
    elif bad == "pair_length":
        pj = pj[:-1]
    else:
        pi = pi.float()
    with pytest.raises(ValueError):
        km.fused_mutual_match_pairs(desc, world, wnrm, valid, pi, pj, max_dist=0.05, max_normal_deg=45.0)


def test_pairs_index_outside_the_table_raises():
    table = [_t(a) for a in _random_frame_table(15, 16, 8)[0]]
    pi, pj = map(_t, TABLE_PAIRS)
    pj[2] = 4  # K = 4
    with pytest.raises(IndexError):
        km.fused_mutual_match_pairs(*table, pi, pj, max_dist=0.05, max_normal_deg=45.0)


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
