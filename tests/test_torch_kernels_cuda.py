"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels_cuda.py -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bundletrack_tpu_torch.config import (
    BundleConfig,
    FrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig,
)
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.kernels import matching as km
# every shape the bf16 LF-Net gives the sums kernel, and ragged ones
from bundletrack_tpu_torch.sums_bench import CASES as SUMS_BENCH_CASES
from bundletrack_tpu_torch.tracker.driver import Tracker

DIST_ATOL = 1e-4  # the bf16-product dot summed in another order: ~1e-6 on O(1) distances
MUTUAL_AGREE = 0.99  # a near-tie in a column minimum may flip a row's mutual flag


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _case(seed, P, N, D):
    rng = np.random.RandomState(seed)
    desc_a = rng.randn(P, N, D).astype(np.float32)
    desc_a /= np.linalg.norm(desc_a, axis=-1, keepdims=True)
    perm = rng.permutation(N)
    desc_b = desc_a[:, perm] + 0.02 * rng.randn(P, N, D).astype(np.float32)
    wa = (rng.rand(P, N, 3) * 0.3).astype(np.float32)
    wb = wa[:, perm] + (0.003 * rng.randn(P, N, 3)).astype(np.float32)
    na = rng.randn(P, N, 3).astype(np.float32)
    na /= np.linalg.norm(na, axis=-1, keepdims=True)
    nb = na[:, perm]
    va, vb = rng.rand(P, N) > 0.2, rng.rand(P, N) > 0.2
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (desc_a, desc_b, wa, wb, na, nb, va, vb)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,D", [(4, 200, 256), (2, 64, 64), (3, 100, 30)])  # ragged N and odd D too
def test_fused_kernel_matches_plain_version(P, N, D):
    """The gathered-sides adapter over the same kernel."""
    _need_card()
    args = _case(P * N + D, P, N, D)
    before = km.launches
    bb, dd, mm = (t.cpu() for t in km.fused_mutual_match(*(a.cuda() for a in args), max_dist=0.02, max_normal_deg=45.0))
    assert km.launches == before + 1
    rb, rd, rm = km.fused_mutual_match(*args, max_dist=0.02, max_normal_deg=45.0)
    assert torch.equal(dd < km.BIG, rd < km.BIG)  # the gate is bit-identical
    has = rd < km.BIG
    assert bool(has.any())
    assert float((dd - rd)[has].abs().max()) <= DIST_ATOL
    assert float((mm == rm).float().mean()) >= MUTUAL_AGREE
    both = mm & rm
    assert torch.equal(bb[both], rb[both])


# at most this many rows' `mutual` may differ from the plain version: a
# near tie in a column minimum (a dist difference of ~1e-6) flips it
MUTUAL_MAX_DIFF_ROWS = 8


def _table(seed, K, N, D):
    """Frames that are noisy shuffled copies of frame 0 (so true matches
    exist), a fifth of the keypoints invalid."""
    rng = np.random.RandomState(seed)
    base = rng.randn(N, D).astype(np.float32)
    pos = (rng.rand(N, 3) * 0.3).astype(np.float32)
    nrm = rng.randn(N, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    perms = [np.arange(N)] + [rng.permutation(N) for _ in range(K - 1)]
    desc = np.stack([base[p] + 0.3 * rng.randn(N, D) for p in perms]).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    world = np.stack([pos[p] + 0.003 * rng.randn(N, 3) for p in perms]).astype(np.float32)
    wnrm = np.stack([nrm[p] for p in perms])
    valid = rng.rand(K, N) > 0.2
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (desc, world, wnrm, valid)]


def _pairs(K):
    """Every i < j, plus a reversed pair, a frame against itself and a repeat."""
    pi, pj = np.triu_indices(K, k=1)
    extra = [(1, 0), (0, 0), (0, 1)] if K < 16 else []
    pi = np.concatenate([pi, [a for a, _ in extra]]).astype(np.int32)
    pj = np.concatenate([pj, [b for _, b in extra]]).astype(np.int32)
    return torch.from_numpy(pi), torch.from_numpy(pj)


def _pairs_on_card(table, pairs, max_dist=0.02):
    """(kernel results, plain results) on the CPU, after checking the route."""
    before = km.launches
    got = km.fused_mutual_match_pairs(*(a.cuda() for a in table), *(p.cuda() for p in pairs),
                                      max_dist=max_dist, max_normal_deg=45.0)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    ref = km.fused_mutual_match_pairs_reference(*table, *pairs, max_dist=max_dist, max_normal_deg=45.0)
    return [t.cpu() for t in got], ref


def _assert_agree(got, ref):
    (bb, dd, mm), (rb, rd, rm) = got, ref
    has = rd < km.BIG
    assert torch.equal(dd < km.BIG, has)  # the gate is bit-identical
    assert torch.equal(bb[~has], torch.zeros_like(bb[~has]))  # no candidate: index 0
    if bool(has.any()):
        assert float((dd - rd)[has].abs().max()) <= DIST_ATOL
    both = mm & rm
    assert torch.equal(bb[both], rb[both])
    diff = (mm != rm).nonzero().tolist()
    for p, i in diff:
        print(f"mutual differs at pair {p} row {i}: kernel ({bool(mm[p, i])}, {int(bb[p, i])}, "
              f"{float(dd[p, i]):.7g}) plain ({bool(rm[p, i])}, {int(rb[p, i])}, {float(rd[p, i]):.7g})")
    assert len(diff) <= MUTUAL_MAX_DIFF_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,D", [
    (16, 512, 256),  # the main path: all 120 pairs of the BA table
    (4, 100, 30),  # ragged N and D: padding rows, columns and depth never count
    (4, 200, 256),
    (4, 256, 64),
])
def test_pairs_kernel_matches_plain_version(K, N, D):
    _need_card()
    table = _table(K * N + D, K, N, D)
    got, ref = _pairs_on_card(table, _pairs(K))
    _assert_agree(got, ref)
    assert int(got[2].sum()) > 10 * K


@pytest.mark.cuda
def test_pairs_kernel_all_gated():
    _need_card()
    table = _table(1, 4, 200, 64)
    table[1] = table[1] + 10.0 * torch.arange(4.0)[:, None, None]  # frames 10 m apart
    pi, pj = np.triu_indices(4, k=1)
    got, ref = _pairs_on_card(table, (torch.from_numpy(pi.astype(np.int32)), torch.from_numpy(pj.astype(np.int32))))
    _assert_agree(got, ref)
    bb, dd, mm = got
    assert not bool((dd < km.BIG).any()) and not bool(mm.any())
    assert bool((dd == km.BIG).all())


@pytest.mark.cuda
def test_pairs_kernel_half_invalid():
    _need_card()
    K, N = 4, 256
    table = _table(2, K, N, 64)
    table[3] = table[3].clone()
    table[3][:, N // 2:] = False  # the upper half of every frame, A side and B side
    got, ref = _pairs_on_card(table, _pairs(K))
    _assert_agree(got, ref)
    bb, dd, mm = got
    assert not bool((dd[:, N // 2:] < km.BIG).any())
    assert not bool((bb[dd < km.BIG] >= N // 2).any())
    assert int(mm.sum()) > 10 * K


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(512, 256), (100, 30)])
def test_pairs_kernel_exact_ties(N, D):
    """Descriptors in multiples of 1/64 (the dot is exact in any sum order)
    and keypoint 2m+1 a copy of keypoint 2m: each row ties exactly between
    2m and 2m+1, and the first must win on the tensor cores too."""
    _need_card()
    table = _table(3, 4, N, D)
    table[0] = torch.round(table[0] * 64) / 64
    for t in table:
        t[:, 1::2] = t[:, 0::2]
    got, ref = _pairs_on_card(table, _pairs(4))
    _assert_agree(got, ref)
    (bb, dd, mm), (rb, rd, rm) = got, ref
    assert torch.equal(dd, rd) and torch.equal(bb, rb) and torch.equal(mm, rm)
    assert bool((bb[dd < km.BIG] % 2 == 0).all())
    assert int(mm.sum()) > 10


_OUT_OF_RANGE = r"""
import torch
from bundletrack_tpu_torch.kernels import matching as km
K, N, D = 4, 64, 32
t = [torch.randn(K, N, D).cuda(), torch.rand(K, N, 3).cuda(), torch.randn(K, N, 3).cuda(),
     torch.ones(K, N, dtype=torch.bool).cuda()]
pi = torch.tensor([0, 1], dtype=torch.int32).cuda()
pj = torch.tensor([1, K], dtype=torch.int32).cuda()
km.fused_mutual_match_pairs(*t, pi, pj, max_dist=0.05, max_normal_deg=45.0)
torch.cuda.synchronize()
print("NO ERROR")
"""


@pytest.mark.cuda
def test_pairs_kernel_index_outside_the_table_is_a_cuda_error():
    """The kernel traps on a frame index outside [0, K) instead of reading
    past the table.  A trap leaves the process's CUDA context unusable, so
    it runs in a child process."""
    _need_card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "NO ERROR" not in proc.stdout, proc.stdout + proc.stderr[-2000:]


# the sums kernel's shapes: the detector's norms at input 400 (one crop and
# the fleet's 8), the descriptor's at 512 keypoints, the photo's and the
# score maps' instance norms (windows padded on both sides, shifted), and
# ragged shapes (an odd grid, 48 channels in windows of 32 with "SAME"
# padding, the [B, F] form)
SUMS_CASES = [
    ((1, 16, 400, 400), False, True, False), ((8, 16, 400, 400), False, True, False),
    ((512, 64, 16, 16), False, True, False), ((512, 128, 8, 8), False, True, False),
    ((512, 256, 4, 4), False, True, False), ((512, 512), False, True, False),
    ((1, 1, 400, 400), True, False, False), ((1, 1, 400, 400), True, False, True),
    ((1, 1, 800, 800), True, False, True), ((1, 1, 283, 283), True, False, True),
    ((1, 1, 200, 200), True, False, True), ((1, 1, 68, 68), True, False, True),
    ((2, 16, 96, 96), False, False, False), ((3, 48, 7, 9), False, False, False), ((5, 96), False, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,per_channel,round_bf16,shift", SUMS_CASES, ids=str)
def test_sums_kernel_matches_plain_version_bit_for_bit(shape, per_channel, round_bf16, shift):
    """The sums kernel adds in the plain version's order: equal bits, and
    equal again on a second launch (the ticket counter was reset)."""
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    _need_card()
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen) * 0.7 + 0.3
    G = shape[0] * (shape[1] if per_channel else 1)
    sh = torch.randn(G, generator=gen) if shift else None
    want = ns.xla_order_sums_reference(x, per_channel, round_bf16, sh)
    before = ns.launches
    for _ in range(2):
        got = ns.xla_order_sums(x.cuda(), per_channel, round_bf16, None if sh is None else sh.cuda())
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (shape, a.cpu() - b)
    assert ns.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [c[0] for c in SUMS_CASES if c[2]], ids=str)
def test_sums_kernel_mean_var_match_plain_version_bit_for_bit(shape):
    """GroupNorm's mean and variance, derived in the kernel's last block
    (`xla_order_mean_var`), equal `xla_mean_var` of the plain sums."""
    from bundletrack_tpu_torch.kernels import norm_sums as ns
    from bundletrack_tpu_torch.ops.numerics import xla_mean_var

    _need_card()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape))) * 0.7 + 0.3
    want = xla_mean_var(*ns.xla_order_sums_reference(x, round_bf16=True), x[0].numel())
    got = ns.xla_order_mean_var(x.cuda(), round_bf16=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b), (shape, a.cpu() - b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,per_channel,round_bf16,shift", SUMS_BENCH_CASES, ids=str)
def test_sums_kernel_every_launch_form_on_the_bench_cases(shape, per_channel, round_bf16, shift):
    """Every launch form on every `sums_bench.CASES` shape, bit for bit with
    the plain versions: the sums (twice: the counters were reset), a
    GroupNorm's mean and variance (sample groups, no shift), and the
    instance statistics (per-channel groups, no shift); one launch each."""
    from bundletrack_tpu_torch.kernels import norm_sums as ns
    from bundletrack_tpu_torch.ops.numerics import xla_mean_var

    _need_card()
    gen = torch.Generator().manual_seed(1 + sum(shape))
    x = torch.randn(shape, generator=gen) * 0.7 + 0.3
    G = shape[0] * (shape[1] if per_channel else 1)
    sh = torch.randn(G, generator=gen) if shift else None
    want = ns.xla_order_sums_reference(x, per_channel, round_bf16, sh)
    xc = x.cuda()
    for _ in range(2):
        before = ns.launches
        got = ns.xla_order_sums(xc, per_channel, round_bf16, None if sh is None else sh.cuda())
        torch.cuda.synchronize()
        assert ns.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (shape, a.cpu() - b)
    if not per_channel and not shift:
        got = ns.xla_order_mean_var(xc, round_bf16=round_bf16)
        ref = xla_mean_var(*want, x[0].numel())
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b), (shape, a.cpu() - b)
    if per_channel and not shift:
        got = ns.xla_order_instance_stats([xc])
        ref = ns.xla_order_instance_stats_reference([x])
        for a, b in zip(got, ref):
            assert torch.equal(a[0].cpu(), b[0]), (shape, a[0].cpu() - b[0])


def _score_maps(B, size=400):
    """Maps of the score maps' sizes at `size` (x 0.5 ... 2), B samples each."""
    gen = torch.Generator().manual_seed(B)
    sizes = [int(size * f + 0.5) for f in (0.5, 2 ** -0.5, 1.0, 2 ** 0.5, 2.0)]
    return [torch.randn((B, 1, n, n), generator=gen) * 0.5 - 0.2 for n in sizes]


@pytest.mark.cuda
@pytest.mark.parametrize("maps", [
    "photo", "five score maps", "fleet: 8 x five score maps", "ragged small",
])
def test_instance_stats_kernel_ragged_batches_bit_for_bit(maps):
    """The instance norms' statistics in one launch: the photo, the five
    score maps of a 400x400 forward, the fleet's 8 crops' five, and small
    ragged maps (windows narrower than 32, several channels); bit for bit
    with the plain version, twice (the counters were reset)."""
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    _need_card()
    gen = torch.Generator().manual_seed(3)
    xs = {
        "photo": lambda: [torch.rand((1, 1, 400, 400), generator=gen)],
        "five score maps": lambda: _score_maps(1),
        "fleet: 8 x five score maps": lambda: _score_maps(8),
        "ragged small": lambda: [torch.randn(s, generator=gen) for s in
                                 [(2, 3, 20, 45), (1, 1, 7, 9), (3, 1, 33, 31), (1, 2, 70, 5)]],
    }[maps]()
    want = ns.xla_order_instance_stats_reference(xs)
    xc = [x.cuda() for x in xs]
    for _ in range(2):
        before = ns.launches
        got = ns.xla_order_instance_stats(xc)
        torch.cuda.synchronize()
        assert ns.launches == before + 1
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a.cpu(), b), (maps, a.cpu() - b)


@pytest.mark.cuda
def test_lfnet_bf16_forward_launches_the_sums_kernel_13_times():
    """One 400x400 bf16 forward: 11 GroupNorms (7 detector, 4 descriptor)
    and the photo's and the score maps' instance norms, one launch each."""
    from bundletrack_tpu_torch.cardrun import masked_crop, render_main_sequence
    from bundletrack_tpu_torch.frontend import lfnet
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    _need_card()
    cfg = FrontendConfig(kind="lfnet", input_size=400, top_k=512, bf16=True)
    _, params = lfnet.load_params_npz("checkpoints/lfnet_params.npz", cfg)
    apply = lfnet.make_lfnet_apply(cfg, params).to("cuda")
    crop = masked_crop(render_main_sequence(1), 0, 400)[..., None].cuda()
    apply(crop)
    before = ns.launches
    apply(crop)
    assert ns.launches - before == 13


@pytest.mark.cuda
@pytest.mark.parametrize("size", [192, 400])
def test_lfnet_bf16_forward_on_the_card_matches_the_cpu(size):
    """The bf16 forward on the shipped weights (the jitted JAX forward's
    function) on both devices, on masked crops of rendered 480x640 frames:
    at least 95 % of the CPU's keypoints found on the card (cuDNN's bf16
    products sum in another order, and a bf16 rounding flips now and then),
    and the norms went through the sums kernel."""
    from bundletrack_tpu_torch.cardrun import masked_crop, render_main_sequence
    from bundletrack_tpu_torch.frontend import lfnet
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    _need_card()
    cfg = FrontendConfig(kind="lfnet", input_size=size, top_k=512, bf16=True)
    _, params = lfnet.load_params_npz("checkpoints/lfnet_params.npz", cfg)
    apply = {dev: lfnet.make_lfnet_apply(cfg, params).to(dev) for dev in ("cuda", "cpu")}
    seq = render_main_sequence(3)
    found = total = 0
    for f in range(3):
        crop = masked_crop(seq, f, size)[..., None]
        before = ns.launches
        card = apply["cuda"](crop.cuda())
        assert ns.launches > before
        cpu = apply["cpu"](crop.cpu())
        ck, gk = cpu.kpts_uv[cpu.valid].numpy(), card.kpts_uv[card.valid].cpu().numpy()
        d = np.linalg.norm(ck[:, None] - gk[None], axis=-1)
        found += int((d.min(axis=1) < 0.05).sum())
        total += len(ck)
    assert found >= 0.95 * total, (found, total)


def _normal_blocks_case(case):
    """(K, pair_i, pair_j, [Hii, Hjj, Hij, gi, gj]) of a named case, CPU
    tensors; entries of either sign with magnitude 10^U(-3, 3)."""
    rng = np.random.RandomState(len(case))
    batch = ()
    if case in ("all_pairs_K16", "eight_graphs_K16"):
        K, (i, j) = 16, np.triu_indices(16, k=1)
        batch = (8,) if case == "eight_graphs_K16" else ()
    elif case == "repeated_and_self_pairs":  # the 120 pairs, 7 of them again, two with i == j
        K, (i, j) = 16, np.triu_indices(16, k=1)
        extra = rng.choice(120, 7, replace=False)
        i, j = np.concatenate([i, i[extra], [3, 11]]), np.concatenate([j, j[extra], [3, 11]])
    elif case == "reversed_and_repeated_K6":
        K, i, j = 6, rng.randint(0, 6, 40), rng.randint(0, 6, 40)
    elif case in ("tiled_list_K2", "tiled_list_K2_eight_graphs"):  # hundreds of terms on block (0, 0): a list in parts
        pairs = np.array([(0, 0), (0, 1), (1, 0), (1, 1)])[rng.choice(4, 300, p=[0.4, 0.3, 0.25, 0.05])]
        K, i, j = 2, pairs[:, 0], pairs[:, 1]
        batch = (8,) if case == "tiled_list_K2_eight_graphs" else ()
    elif case == "pairs_beyond_a_tile_K16":  # 1500 pairs with replacement: more than one tile of indices
        K, i, j = 16, rng.randint(0, 16, 1500), rng.randint(0, 16, 1500)
    else:  # one_pair_K2
        K, i, j = 2, np.array([0]), np.array([1])
    P = len(i)

    def draw(shape):
        return torch.from_numpy((rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32))

    blocks = [draw((*batch, P, 6, 6)) for _ in range(3)] + [draw((*batch, P, 6)) for _ in range(2)]
    return K, torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64)), blocks


NORMAL_BLOCKS_CASES = ["all_pairs_K16", "repeated_and_self_pairs", "reversed_and_repeated_K6", "one_pair_K2",
                       "eight_graphs_K16", "tiled_list_K2", "pairs_beyond_a_tile_K16", "tiled_list_K2_eight_graphs"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORMAL_BLOCKS_CASES)
def test_normal_blocks_kernel_matches_plain_version_bit_for_bit(case):
    """One launch per call, and the plain version's bits on CPU copies of
    the same inputs (both add each entry's terms in one order)."""
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    _need_card()
    K, pi, pj, blocks = _normal_blocks_case(case)
    before = nb.launches
    H, g = nb.scatter_blocks(K, pi.cuda(), pj.cuda(), *(b.cuda() for b in blocks))
    torch.cuda.synchronize()
    assert nb.launches == before + 1
    rH, rg = nb.scatter_blocks_reference(K, pi, pj, *blocks)
    assert torch.equal(H.cpu(), rH) and torch.equal(g.cpu(), rg)


@pytest.mark.cuda
def test_normal_blocks_kernel_repeats_its_bits():
    """20 calls on one input (the fleet's 8 graphs) give equal bits."""
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    _need_card()
    K, pi, pj, blocks = _normal_blocks_case("eight_graphs_K16")
    args = (K, pi.cuda(), pj.cuda(), *(b.cuda() for b in blocks))
    first = nb.scatter_blocks(*args)
    for _ in range(19):
        again = nb.scatter_blocks(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _track_five_frames(device):
    """The 5-frame tracker run of the card tests on `device`: every frame's
    pose [5, 4, 4] (numpy) and status."""
    H, W = 120, 160
    cfg = TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4), keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=FrontendConfig(top_k=128), ransac=RansacConfig(max_iter=256),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )
    seq = render_synthetic_sequence(num_frames=5, H=H, W=W, orbit_deg_per_frame=4.0)
    rng = np.random.RandomState(0)
    phases = [(rng.randint(0, 128, (3, 2)), rng.randint(0, 128, (6, 3, 2))) for _ in range(5)]
    trk = Tracker(cfg, H, W, device=device)
    poses, statuses = [], []
    for f in range(5):
        out = trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K,
                                np.linalg.inv(seq.ob_in_cam[0]), phases=phases[f])
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
    return np.stack(poses), statuses


@pytest.mark.cuda
def test_tracker_on_the_card_matches_the_cpu():
    """The same frames and RANSAC phases through the step on both devices."""
    _need_card()
    poses = {}
    for device in ("cuda", "cpu"):
        all_poses, statuses = _track_five_frames(device)
        assert statuses == [0] * 5
        poses[device] = all_poses[-1]
    # f32 on both devices; the card sums the GN blocks' products and the
    # convolutions in cuBLAS's and cuDNN's orders, not the CPU's (the blocks
    # themselves are added in the CPU's order), so 1e-4 m / 1e-4 on rotation
    # entries
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-4)


@pytest.mark.cuda
def test_tracker_on_the_card_repeats_bit_for_bit():
    """The 5-frame card run twice on fresh trackers: equal statuses and
    pose bits (the GN blocks summed in a fixed order), every tracked frame
    through the normal-blocks kernel."""
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    _need_card()
    before = nb.launches
    first = _track_five_frames("cuda")
    assert nb.launches > before
    again = _track_five_frames("cuda")
    assert first[1] == again[1] == [0] * 5
    assert np.array_equal(first[0], again[0])


@pytest.mark.cuda
def test_lfnet_fleet_step_on_the_card_matches_the_cpu():
    """Three streams through the LF-Net fleet step (one batched forward per
    fleet frame, shipped weights at input_size 96, f32) on both devices,
    with the same RANSAC phases."""
    from bundletrack_tpu_torch.frontend import lfnet
    from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step

    _need_card()
    S, H, W, F = 3, 120, 160, 4
    cfg = TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4), keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=FrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False),
        ransac=RansacConfig(max_iter=256), shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )
    _, params = lfnet.load_params_npz("checkpoints/lfnet_params.npz", cfg.frontend)
    seqs = [render_synthetic_sequence(num_frames=F, H=H, W=W, seed=s, orbit_deg_per_frame=4.0) for s in range(S)]
    rng = np.random.RandomState(0)
    phases = [tuple(torch.from_numpy(a) for a in (rng.randint(0, 128, (S, 3, 2)), rng.randint(0, 128, (S, 6, 3, 2))))
              for _ in range(F)]
    init_pose = np.stack([np.linalg.inv(q.ob_in_cam[0]) for q in seqs]).astype(np.float32)
    poses = {}
    for device in ("cuda", "cpu"):
        step = make_fleet_step(cfg, H, W, lfnet_apply=lfnet.make_lfnet_apply(cfg.frontend, params).to(device))
        state = init_fleet_state(cfg, H, W, S, device=device)
        ip = torch.as_tensor(init_pose, device=device)
        before = km.launches
        for f in range(F):
            obs = fleet_observation(*(np.stack([getattr(q, k)[f] for q in seqs]) for k in ("gray", "depth", "mask")),
                                    np.stack([q.K for q in seqs]), device)
            state, out = step(state, obs, ip, tuple(p.to(device) for p in phases[f]))
            assert not bool(out.status.any()), (device, f, out.status)
        if device == "cuda":
            assert km.launches - before == F - 1  # one matcher launch per tracked fleet frame
        poses[device] = out.ob_in_cam.cpu().numpy()
    # f32 on both devices; the card sums the convolutions and the GN blocks'
    # products in cuDNN's and cuBLAS's orders, not the CPU's
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 8], ids=["one_graph", "eight_graphs"])
def test_pcg_solve_on_the_card_matches_the_cpu(batch):
    """Five block-Jacobi PCG steps on random SPD systems of 16 frames (the
    default BA size), on both devices."""
    from bundletrack_tpu_torch.solver.pcg import solve_normal_equations_pcg

    _need_card()
    rng = np.random.RandomState(1)
    n, K = batch or 1, 16
    A = rng.randn(n, K * 6, K * 6).astype(np.float32)
    Hd = A @ A.transpose(0, 2, 1) + 10.0 * np.eye(K * 6, dtype=np.float32)
    H = torch.from_numpy(Hd.reshape(n, K, 6, K, 6).transpose(0, 1, 3, 2, 4).copy())
    g = torch.from_numpy(rng.randn(n, K, 6).astype(np.float32))
    if batch is None:
        H, g = H[0], g[0]
    cpu = solve_normal_equations_pcg(H, g, num_iters=5, lm_lambda=1e-4)
    card = solve_normal_equations_pcg(H.cuda(), g.cuda(), num_iters=5, lm_lambda=1e-4).cpu()
    # f32 with TF32 off on both devices: the einsum's and the dot products'
    # sums run in another order
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), atol=1e-5 * float(cpu.abs().max()))


def _grads(model):
    return {n: p.grad.detach().double().cpu().flatten() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["lfnet", "vos", "vos_rollout"])
def test_training_step_on_the_card_matches_the_cpu(net):
    """One training step from the same weights on the same batch on both
    devices (f32, TF32 off): the loss within 1e-3 relative, each gradient
    tensor's cosine >= 0.99.  The LF-Net score convs' biases are left out:
    the instance norm after each score map removes them, so their gradient
    is rounding noise."""
    from bundletrack_tpu_torch.apps import train_lfnet, train_vos
    from bundletrack_tpu_torch.frontend.lfnet import init_lfnet
    from bundletrack_tpu_torch.models import (
        LFNetTrainBatch,
        VOSTrainBatch,
        make_adam,
        make_lfnet_train_step,
        make_vos_train_step,
    )
    from bundletrack_tpu_torch.models.vos import init_vos

    _need_card()
    if net == "lfnet":
        cfg = FrontendConfig(kind="lfnet", input_size=64, top_k=32, net_channel=8, net_num_scales=3,
                             desc_net_channel=16, desc_dim=32, sm_ksize=5, bf16=False)
        batch_np = train_lfnet.build_batches(64, 2, 2, seed=0, num_batches=1)[0]
        fields, Batch = LFNetTrainBatch._fields, LFNetTrainBatch
    else:
        batch_np = train_vos.build_clips(32, 2, 3, 1, 0, "easy", 35)[0]
        fields, Batch = VOSTrainBatch._fields, VOSTrainBatch
    runs = {}
    for device in ("cuda", "cpu"):
        if net == "lfnet":
            model = init_lfnet(cfg, seed=1)[0].to(device)
            step = make_lfnet_train_step(model, make_adam(model.parameters(), 1e-3))
        else:
            model = init_vos(out_dim=32, width=16, seed=1)[0].to(device)
            step = make_vos_train_step(model, make_adam(model.parameters(), 1e-3), (32, 32),
                                       rollout=net == "vos_rollout")
        metrics = step(Batch(*(torch.from_numpy(batch_np[k]).to(device) for k in fields)))
        assert metrics["loss"].device.type == device
        runs[device] = float(metrics["loss"]), _grads(model)
    (loss_card, g_card), (loss_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    assert np.isfinite(loss_card) and abs(loss_card - loss_cpu) <= 1e-3 * abs(loss_cpu)
    assert set(g_card) == set(g_cpu)
    for n in g_cpu:
        if n.startswith("detector.score_conv_") and n.endswith(".bias"):
            continue
        cos = float(g_card[n] @ g_cpu[n] / (g_card[n].norm() * g_cpu[n].norm()))
        assert cos >= 0.99, (n, cos)
