"""The normal equations' pair blocks summed in a fixed order, on the CPU.

`kernels/normal_blocks.scatter_blocks` adds the Gauss-Newton pair blocks
into H [..., K, K, 6, 6] and g [..., K, 6]; on the card its kernel adds
each entry's terms in one order (Hii over the pairs, then Hjj, Hij, Hij
transposed; gi, then gj), on the CPU its plain version adds them with
index_add_.  Here the plain version is held bit for bit to jax.jit (and
jax.vmap) of the JAX package's scatter_blocks, and to a sequential f32
loop in the kernel's order, on seeded blocks whose entries span 1e-3 to
1e3 in magnitude: all 120 pairs of 16 frames, repeated and reversed pairs,
pairs whose i equals j, one pair of two frames.
"""

import functools

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
    raise ValueError(case)


CASES = ["all_pairs_K16", "repeated_and_self_pairs", "reversed_and_repeated_K6", "one_pair_K2"]


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
