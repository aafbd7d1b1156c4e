"""The normal equations' pair blocks summed in a fixed order, on the CPU.

`kernels/normal_blocks.scatter_blocks` adds the Gauss-Newton pair blocks
into H [..., K, K, 6, 6] and g [..., K, 6]; on the card its kernel adds
each entry's terms in one order (Hii over the pairs, then Hjj, Hij, Hij
transposed; gi, then gj), on the CPU its plain version adds them with
index_add_.  Here the plain version is held bit for bit to jax.jit (and
jax.vmap) of the JAX package's scatter_blocks, and to a sequential f32
loop in the kernel's order, on seeded blocks whose entries span 1e-3 to
1e3 in magnitude: all 120 pairs of 16 frames, repeated and reversed pairs,
pairs whose i equals j, one pair of two frames, 300 pairs of two frames
(one output block with more terms than the kernel lists at a time) and
1500 pairs over 16 frames (more than one tile of pair indices).  A numpy
mirror of the kernel's term list (per output block, each kind's hits found
32 pairs a ballot step, listed at their rank, added in parts) is held to
the plain version bit for bit at the kernel's own tile sizes and at small
ones.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.solver.residuals import scatter_blocks as jax_scatter_blocks
from bundletrack_tpu_torch.kernels import normal_blocks as nb
from bundletrack_tpu_torch.solver import dense_p2p, residuals


def _pairs(case):
    """(K, pair_i, pair_j) of a named case."""
    rng = np.random.RandomState(len(case))
    if case == "all_pairs_K16":
        i, j = np.triu_indices(16, k=1)
        return 16, i, j
    if case == "repeated_and_self_pairs":  # the 120 pairs, 7 of them again, two with i == j
        i, j = np.triu_indices(16, k=1)
        extra = rng.choice(120, 7, replace=False)
        return 16, np.concatenate([i, i[extra], [3, 11]]), np.concatenate([j, j[extra], [3, 11]])
    if case == "reversed_and_repeated_K6":  # pairs in both orientations, drawn with replacement
        i, j = rng.randint(0, 6, 40), rng.randint(0, 6, 40)
        return 6, i, j
    if case == "one_pair_K2":
        return 2, np.array([0]), np.array([1])
    if case == "tiled_list_K2":  # 300 pairs of two frames, most on (0, 0): ~700 terms land on block (0, 0)
        pairs = np.array([(0, 0), (0, 1), (1, 0), (1, 1)])[rng.choice(4, 300, p=[0.4, 0.3, 0.25, 0.05])]
        return 2, pairs[:, 0], pairs[:, 1]
    if case == "pairs_beyond_a_tile_K16":  # 1500 pairs over 16 frames drawn with replacement
        return 16, rng.randint(0, 16, 1500), rng.randint(0, 16, 1500)
    raise ValueError(case)


CASES = ["all_pairs_K16", "repeated_and_self_pairs", "reversed_and_repeated_K6", "one_pair_K2", "tiled_list_K2",
         "pairs_beyond_a_tile_K16"]


def _blocks(P, batch=(), seed=0):
    """Hii, Hjj, Hij [*batch, P, 6, 6] and gi, gj [*batch, P, 6], f32, each
    entry of either sign with magnitude 10^U(-3, 3)."""
    rng = np.random.RandomState(seed)

    def draw(shape):
        return (rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    return [draw((*batch, P, 6, 6)) for _ in range(3)] + [draw((*batch, P, 6)) for _ in range(2)]


def _port(K, i, j, blocks, fn=nb.scatter_blocks):
    return [t.numpy() for t in fn(K, torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64)),
                                  *(torch.from_numpy(b) for b in blocks))]


def _sequential(K, i, j, blocks):
    """The kernel's order on the host: from +0.0, for each kind in turn and
    each pair in order, one f32 add into the entries it lands on."""
    Hii, Hjj, Hij, gi, gj = blocks
    H = np.zeros((K, K, 6, 6), np.float32)
    g = np.zeros((K, 6), np.float32)
    for rows, cols, vals in ((i, i, Hii), (j, j, Hjj), (i, j, Hij), (j, i, np.swapaxes(Hij, -1, -2))):
        for p in range(len(i)):
            H[rows[p], cols[p]] = H[rows[p], cols[p]] + vals[p]
    for rows, vals in ((i, gi), (j, gj)):
        for p in range(len(i)):
            g[rows[p]] = g[rows[p]] + vals[p]
    return H, g


def _kernel_tiles():
    """(PAIR_TILE, LIST_CAP, TERM_TILE) as csrc/normal_blocks.cu defines them."""
    with open(os.path.join(os.path.dirname(nb.__file__), os.pardir, "csrc", nb.SOURCE)) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("PAIR_TILE", "LIST_CAP", "TERM_TILE"))


def _ballot_list_order(K, i, j, blocks, pair_tile, list_cap, term_tile):
    """csrc/normal_blocks.cu's order on the host: per output block (r, c),
    the pair indices taken pair_tile at a time (an index outside 0..K-1 as
    -1); for each kind in turn (an off-diagonal block skips (i, i) and
    (j, j)) the hits found 32 pairs a ballot step, each listed at its rank
    among the lower lanes' hits; the list added before a tile could take it
    past list_cap, term_tile terms at a time, each term one f32 add into the
    block's entries (and, for the kinds (i, i) and (j, j), the first of the
    list, into g).  Returns H, g and (index tiles, list parts, term parts)
    counted over the blocks."""
    Hii, Hjj, Hij, gi, gj = blocks
    batch, P = Hii.shape[:-3], len(i)
    H = np.empty((*batch, K, K, 6, 6), np.float32)
    g = np.empty((*batch, K, 6), np.float32)
    si, sj = (np.where((v >= 0) & (v < K), v, -1) for v in (i, j))
    terms = {0: Hii, 1: Hjj, 2: Hij, 3: np.swapaxes(Hij, -1, -2)}
    parts = [0, 0, 0]
    for r in range(K):
        for c in range(K):
            acc = np.zeros((*batch, 6, 6), np.float32)
            gacc = np.zeros((*batch, 6), np.float32)
            listed, g_count = [], 0

            def add_listed():
                nonlocal acc, gacc, listed, g_count
                parts[1] += bool(listed)
                for t0 in range(0, len(listed), term_tile):
                    parts[2] += 1
                    for t, (p, kind) in enumerate(listed[t0:t0 + term_tile]):
                        acc = acc + terms[kind][..., p, :, :]
                        if t0 + t < g_count:
                            gacc = gacc + (gi, gj)[kind][..., p, :]
                listed, g_count = [], 0

            for kind in (0, 1, 2, 3) if r == c else (2, 3):
                rows, cols = (si if kind in (0, 2) else sj), (si if kind in (0, 3) else sj)
                for p0 in range(0, P, pair_tile):
                    n = min(pair_tile, P - p0)
                    parts[0] += 1
                    if len(listed) + n > list_cap:
                        add_listed()
                    for s in range(p0, p0 + n, 32):
                        lanes = np.arange(s, min(s + 32, p0 + n))
                        hit = (rows[lanes] == r) & (cols[lanes] == c)
                        rank = np.cumsum(hit) - hit
                        step = [None] * int(hit.sum())
                        for lane in np.flatnonzero(hit):
                            step[rank[lane]] = (int(lanes[lane]), kind)
                        listed += step
                    if kind < 2:
                        g_count = len(listed)
            add_listed()
            H[..., r, c, :, :] = acc
            if r == c:
                g[..., r, :] = gacc
    return H, g, tuple(parts)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_jax_jit_bit_for_bit(case):
    K, i, j = _pairs(case)
    blocks = _blocks(len(i), seed=len(i))
    want = jax.jit(jax_scatter_blocks, static_argnums=0)(K, jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32),
                                                          *(jnp.asarray(b) for b in blocks))
    got = _port(K, i, j, blocks, nb.scatter_blocks_reference)
    for g_, w_ in zip(got, want):
        assert g_.dtype == np.float32 and g_.shape == w_.shape
        np.testing.assert_array_equal(g_, np.asarray(w_))
    # the entries span the range the case was drawn for, and repeats do add
    assert np.abs(got[0]).max() > 1e2 and np.count_nonzero(got[0]) > 0


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_the_kernels_order_bit_for_bit(case):
    """The sequence each thread of csrc/normal_blocks.cu adds, run on the
    host, gives the plain version's bits."""
    K, i, j = _pairs(case)
    blocks = _blocks(len(i), seed=len(i) + 1)
    for got, want in zip(_port(K, i, j, blocks, nb.scatter_blocks_reference), _sequential(K, i, j, blocks)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_ballot_list_order_equals_the_plain_version_bit_for_bit(case, tiles):
    """The term lists csrc/normal_blocks.cu builds and adds, mirrored on the
    host at its own tile sizes and at small ones (16 pairs a tile, 16 terms
    a list, 4 a stage), give the plain version's bits."""
    K, i, j = _pairs(case)
    blocks = _blocks(len(i), seed=len(i) + 2)
    sizes = _kernel_tiles() if tiles == "kernel" else (16, 16, 4)
    H, g, (pair_tiles, list_parts, term_parts) = _ballot_list_order(K, i, j, blocks, *sizes)
    want = _port(K, i, j, blocks, nb.scatter_blocks_reference)
    np.testing.assert_array_equal(H, want[0])
    np.testing.assert_array_equal(g, want[1])
    # the two new graphs reach the kernel's own tiling: a list added in parts, more than one index tile
    if tiles == "kernel" and case == "tiled_list_K2":
        assert list_parts > K * K and term_parts > list_parts
    if tiles == "kernel" and case == "pairs_beyond_a_tile_K16":
        assert pair_tiles > 2 * K * K + 2 * K


def test_kernels_ballot_list_order_on_a_batch_bit_for_bit():
    """The mirror on three graphs of the tiled-list case at once: each
    graph's entries added in the same list order."""
    K, i, j = _pairs("tiled_list_K2")
    blocks = _blocks(len(i), batch=(3,), seed=11)
    H, g, _ = _ballot_list_order(K, i, j, blocks, *_kernel_tiles())
    want = _port(K, i, j, blocks, nb.scatter_blocks_reference)
    np.testing.assert_array_equal(H, want[0])
    np.testing.assert_array_equal(g, want[1])


def test_batch_of_three_graphs_equals_jax_vmap_bit_for_bit():
    K, i, j = _pairs("repeated_and_self_pairs")
    blocks = _blocks(len(i), batch=(3,), seed=7)
    fn = jax.jit(jax.vmap(functools.partial(jax_scatter_blocks, K), in_axes=(None, None, 0, 0, 0, 0, 0)))
    want = fn(jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32), *(jnp.asarray(b) for b in blocks))
    got = _port(K, i, j, blocks)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, np.asarray(w_))
    # each graph sums its own pairs
    for s in range(3):
        for g_, w_ in zip(_port(K, i, j, [b[s] for b in blocks]), got):
            np.testing.assert_array_equal(g_, w_[s])


def test_cpu_tensors_go_to_the_plain_version():
    K, i, j = _pairs("all_pairs_K16")
    blocks = _blocks(len(i), batch=(2,), seed=3)
    before = nb.launches
    got = _port(K, i, j, blocks)
    assert nb.launches == before
    for g_, w_ in zip(got, _port(K, i, j, blocks, nb.scatter_blocks_reference)):
        np.testing.assert_array_equal(g_, w_)
    # the solver's three callers reach this wrapper
    assert residuals.scatter_blocks is nb.scatter_blocks
    assert dense_p2p.scatter_blocks is nb.scatter_blocks


def test_refuses_a_gradient_and_bad_shapes():
    K, i, j = _pairs("one_pair_K2")
    pi, pj = torch.from_numpy(i), torch.from_numpy(j)
    blocks = [torch.from_numpy(b) for b in _blocks(1)]
    with pytest.raises(RuntimeError, match="no gradient"):
        nb.scatter_blocks(K, pi, pj, blocks[0].requires_grad_(), *blocks[1:])
    with torch.no_grad():
        H, g = nb.scatter_blocks(K, pi, pj, *blocks)
    assert H.shape == (2, 2, 6, 6) and g.shape == (2, 6)
    with pytest.raises(ValueError, match="not \\[P\\]"):
        nb.scatter_blocks(K, pi, pj, blocks[0].detach(), blocks[1], blocks[2][..., :5], *blocks[3:])
