"""The norms' statistics in XLA's order against jax.jit, on the CPU.

The JAX package runs its LF-Net jitted, and XLA sums the f32 statistics of
Flax's GroupNorm and of detector_ops.instance_norm in an order of its own.
The port's plain version of the sums kernel (`kernels/norm_sums.
xla_order_sums_reference`, what a CPU tensor runs) and the mean and
variance built on it (`ops/numerics.xla_mean_var`) are held to the
statistics of the jitted JAX norm itself: bit for bit on every shape the
LF-Net paths give them (the detector at input 96, 160, 192 and 400, the
score maps' sizes, the descriptor's norms and fc1_norm), within 1e-6
relative on a 2x2 or 4x4 window grid (inputs 64 and 128, which no path
uses, and the smallest score map at input 96, 48x48).  The norms' outputs
differ from JAX's only by XLA's approximate rsqrt (and, at some sizes, its
division), and are held within 1e-6.
"""

import flax.linen as fnn
import flax.linen.normalization as fnorm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.frontend import detector_ops as jops
from bundletrack_tpu_torch.frontend.detector_ops import instance_norm, instance_norms
from bundletrack_tpu_torch.kernels.norm_sums import (
    xla_order_instance_stats,
    xla_order_mean_var,
    xla_order_sums,
    xla_order_sums_reference,
)
from bundletrack_tpu_torch.ops.numerics import reciprocal_f32, round_bf16, xla_mean_var
from bundletrack_tpu_torch.utils.flax_layers import XlaGroupNorm

torch.set_num_threads(2)

BOUND_RTOL = 1e-6  # statistics on a window grid that is not XLA's order, and the norms' outputs

# NHWC shapes of the LF-Net's GroupNorm(1) inputs at a small batch: the
# detector at input 96, 160, 192, 400 (16 channels), the descriptor's three
# norms and fc1_norm; and the two power-of-two grids
GN_EXACT = [(2, 96, 96, 16), (1, 96, 96, 16), (1, 160, 160, 16), (1, 192, 192, 16), (1, 400, 400, 16),
            (3, 16, 16, 64), (3, 8, 8, 128), (3, 4, 4, 256), (3, 512)]
GN_BOUNDED = [(1, 64, 64, 16), (1, 128, 128, 16)]
# instance_norm's inputs: the photo at input 96, 160, 192, 400 and the five
# score maps at each (input x 0.5 ... 2)
IN_EXACT = [68, 96, 136, 160, 192, 200, 272, 283, 384, 400, 566, 800]
IN_BOUNDED = [48, 64, 128]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2) if x.ndim == 4 else x))


def _jax_group_norm(x):
    """The jitted Flax GroupNorm(1) with random scale and bias: its output
    and the statistics it normalises with, from the same program."""
    rng = np.random.RandomState(x.size % 1000)
    gn = fnn.GroupNorm(num_groups=1, dtype=jnp.float32)
    c = x.shape[-1]
    params = {"params": {"scale": jnp.asarray(1 + 0.3 * rng.randn(c), jnp.float32),
                         "bias": jnp.asarray(0.3 * rng.randn(c), jnp.float32)}}
    axes = list(range(1, x.ndim - 1)) + [x.ndim]

    def fn(a):
        return gn.apply(params, a), fnorm._compute_stats(a.reshape(a.shape[:-1] + (1, c)), axes, jnp.float32)

    y, (mean, var) = jax.jit(fn)(x)
    return np.asarray(y), np.asarray(mean).ravel(), np.asarray(var).ravel(), params["params"]


def _group_norm_case(shape, exact):
    rng = np.random.RandomState(sum(shape))
    # bf16 values: the norm's statistics read its input rounded to bf16,
    # here the identity, so they are the jitted f32 Flax norm's
    x = round_bf16(torch.from_numpy((rng.randn(*shape) * 0.7 + 0.3).astype(np.float32))).numpy()
    y, mean, var, p = _jax_group_norm(x)
    s, s2 = xla_order_sums(_nchw(x))
    for got_mean, got_var in (xla_mean_var(s, s2, int(np.prod(shape[1:]))), xla_order_mean_var(_nchw(x))):
        if exact:
            np.testing.assert_array_equal(got_mean.numpy(), mean)
            np.testing.assert_array_equal(got_var.numpy(), var)
        else:
            np.testing.assert_allclose(got_mean.numpy(), mean, rtol=BOUND_RTOL)
            np.testing.assert_allclose(got_var.numpy(), var, rtol=BOUND_RTOL)
    norm = XlaGroupNorm(shape[-1])
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(np.array(p["scale"])))
        norm.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        out = norm(_nchw(x)).numpy()
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1) if out.ndim == 4 else out, y,
                               rtol=BOUND_RTOL, atol=BOUND_RTOL)


@pytest.mark.parametrize("shape", GN_EXACT, ids=str)
def test_group_norm_statistics_equal_jax_jit(shape):
    """Sums, mean and variance of GroupNorm(1) bit for bit those of the
    jitted Flax norm on the LF-Net's shapes (a single sample takes XLA's
    other variance form)."""
    _group_norm_case(shape, exact=True)


@pytest.mark.parametrize("shape", GN_BOUNDED, ids=str)
def test_group_norm_statistics_on_power_of_two_grids_bounded(shape):
    _group_norm_case(shape, exact=False)


def _instance_norm_case(n, exact):
    B = 2 if n <= 200 else 1
    x = np.random.RandomState(n).uniform(-1, 2, (B, n, n, 1)).astype(np.float32)

    def fn(a):
        return jops.instance_norm(a), jnp.mean(a, axis=(1, 2)), jnp.var(a, axis=(1, 2))

    y, mean, var = (np.asarray(t) for t in jax.jit(fn)(x))
    xt = _nchw(x)
    inv = reciprocal_f32(n * n)
    s, _ = xla_order_sums(xt, per_channel=True)
    _, s2 = xla_order_sums(xt, per_channel=True, shift=s * inv)
    check = np.testing.assert_array_equal if exact else (
        lambda a, b: np.testing.assert_allclose(a, b, rtol=BOUND_RTOL))
    check((s * inv).numpy(), mean.ravel())
    check((s2 * inv).numpy(), var.ravel())
    np.testing.assert_allclose(instance_norm(xt, xla_order=True).numpy().transpose(0, 2, 3, 1), y,
                               rtol=BOUND_RTOL, atol=BOUND_RTOL)


@pytest.mark.parametrize("n", IN_EXACT)
def test_instance_norm_statistics_equal_jax_jit(n):
    """The photo's and the score maps' instance norm: mean and variance bit
    for bit those of the jitted detector_ops.instance_norm."""
    _instance_norm_case(n, exact=True)


@pytest.mark.parametrize("n", IN_BOUNDED)
def test_instance_norm_statistics_on_power_of_two_grids_bounded(n):
    _instance_norm_case(n, exact=False)


def test_rounding_shift_and_the_contract():
    """`round_bf16` sums the rounded values, `shift` the shifted ones; the
    [B, F] form is [B, F, 1, 1]; per channel gives [B * C]; no gradient, no
    other dtype or rank, and not both flags."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 16, 20, 24).astype(np.float32))
    for a, b in zip(xla_order_sums(x, round_bf16=True), xla_order_sums(round_bf16(x))):
        assert torch.equal(a, b)
    shift = torch.from_numpy(rng.randn(3 * 16).astype(np.float32))
    got = xla_order_sums(x, per_channel=True, shift=shift)
    want = xla_order_sums(x - shift.view(3, 16, 1, 1), per_channel=True)
    assert got[0].shape == (48,) and torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    f = torch.from_numpy(rng.randn(5, 96).astype(np.float32))
    for a, b in zip(xla_order_sums(f), xla_order_sums_reference(f[:, :, None, None])):
        assert torch.equal(a, b)
    # windows of 32 along the features: three sequential partials, not one chain
    w = f.reshape(5, 3, 32)
    part = np.add.accumulate(w.numpy(), axis=-1, dtype=np.float32)[..., -1]
    np.testing.assert_array_equal(xla_order_sums(f)[0].numpy(), np.add.accumulate(part, axis=-1, dtype=np.float32)[:, -1])
    with pytest.raises(RuntimeError, match="no gradient"):
        xla_order_sums(x.clone().requires_grad_())
    with torch.no_grad():
        xla_order_sums(x.clone().requires_grad_())
    with pytest.raises(ValueError, match="float32"):
        xla_order_sums(x.double())
    with pytest.raises(ValueError, match="not \\[B, C, H, W\\]"):
        xla_order_sums(x[0])
    with pytest.raises(ValueError, match="do not go together"):
        xla_order_sums(x, per_channel=True, round_bf16=True, shift=shift)
    with pytest.raises(ValueError, match="shift must be"):
        xla_order_sums(x, shift=shift)


def test_instance_stats_of_a_ragged_list_equal_the_per_map_norms():
    """`xla_order_instance_stats` on a ragged list (one call: one launch on
    the card) gives, map by map, the statistics that the sums in XLA's order
    give one map at a time (sum, mean = sum * (1/n), shifted squares), and
    `instance_norms` the outputs of instance_norm(xla_order=True) per map,
    bit for bit."""
    rng = np.random.RandomState(7)
    maps = [torch.from_numpy(rng.uniform(-1, 2, shape).astype(np.float32))
            for shape in [(2, 1, 48, 48), (1, 1, 68, 68), (2, 3, 37, 70), (1, 1, 200, 200), (3, 2, 5, 9)]]
    means, variances = xla_order_instance_stats(maps)
    normed = instance_norms(maps)
    for x, mu, var, y in zip(maps, means, variances, normed):
        B, C, H, W = x.shape
        inv = reciprocal_f32(H * W)
        s, _ = xla_order_sums(x, per_channel=True)
        _, s2 = xla_order_sums(x, per_channel=True, shift=s * inv)
        assert mu.shape == (B, C) and var.shape == (B, C)
        assert torch.equal(mu.reshape(-1), s * inv) and torch.equal(var.reshape(-1), s2 * inv)
        assert torch.equal(y, instance_norm(x, xla_order=True))
    assert xla_order_instance_stats([]) == ([], [])
    with pytest.raises(ValueError, match="float32"):
        xla_order_instance_stats([maps[0].double()])
    with pytest.raises(ValueError, match="float32"):
        xla_order_instance_stats([maps[0][0]])
    with pytest.raises(RuntimeError, match="no gradient"):
        xla_order_instance_stats([maps[0].clone().requires_grad_()])


def test_instance_stats_of_the_score_maps_equal_jax_jit():
    """The five score maps of a 96x96 bf16 forward on the shipped weights
    (48, 68, 96, 136 and 192 square), in one call: mean and variance bit for
    bit those of the jitted detector_ops.instance_norm (48 is a 2x2 window
    grid, not XLA's order: within 1e-6 there)."""
    from bundletrack_tpu_torch.config import FrontendConfig
    from bundletrack_tpu_torch.frontend import lfnet

    net, _ = lfnet.load_params_npz("checkpoints/lfnet_params.npz",
                                   FrontendConfig(kind="lfnet", input_size=96, bf16=True))
    yy, xx = np.mgrid[0:96, 0:96]
    photo = (0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
             + 0.1 * np.random.RandomState(5).rand(96, 96)).astype(np.float32)
    with torch.inference_mode():
        score_maps, _, _ = net.detector(instance_norm(torch.from_numpy(photo)[None, None], xla_order=True))
        means, variances = xla_order_instance_stats(score_maps)

    def fn(a):
        return jnp.mean(a, axis=(1, 2)), jnp.var(a, axis=(1, 2))

    assert [sm.shape[-1] for sm in score_maps] == [48, 68, 96, 136, 192]
    for sm, mu, var in zip(score_maps, means, variances):
        want_mean, want_var = (np.asarray(t).ravel() for t in jax.jit(fn)(sm.numpy().transpose(0, 2, 3, 1)))
        if sm.shape[-1] in IN_EXACT:
            np.testing.assert_array_equal(mu.numpy().ravel(), want_mean)
            np.testing.assert_array_equal(var.numpy().ravel(), want_var)
        else:
            np.testing.assert_allclose(mu.numpy().ravel(), want_mean, rtol=BOUND_RTOL)
            np.testing.assert_allclose(var.numpy().ravel(), want_var, rtol=BOUND_RTOL)
