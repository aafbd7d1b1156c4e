"""Parity of the port's geometry (bundletrack_tpu_torch.geometry) with the JAX package.

Inputs come from numpy with a fixed seed and go through both functions.
Tolerance 1e-5 absolute: both sides compute in f32, and the only
differences are summation order and libm rounding (a few ulps on O(1)
values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.geometry import procrustes as jproc
from bundletrack_tpu.geometry import se3 as jse3
from bundletrack_tpu_torch.geometry import procrustes as tproc
from bundletrack_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(2)

ATOL = 1e-5  # f32 on both sides; only summation order and libm rounding differ


def _twists(seed: int, n: int = 32, scale: float = 1.0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    xi = rng.randn(n, 6).astype(np.float32) * scale
    xi[0] = 0.0  # identity
    xi[1, 3:] = [1e-5, -2e-5, 1e-5]  # small-angle branch
    return xi


def _transforms(seed: int, n: int = 16) -> np.ndarray:
    return np.array(jse3.se3_exp(jnp.asarray(_twists(seed, n))))


@pytest.mark.parametrize("scale", [1e-3, 0.5, 1.0])
def test_se3_exp(scale):
    xi = _twists(0, scale=scale)
    np.testing.assert_allclose(
        tse3.se3_exp(torch.from_numpy(xi)).numpy(), np.asarray(jse3.se3_exp(jnp.asarray(xi))), atol=ATOL
    )


@pytest.mark.parametrize("scale", [1e-3, 0.5, 1.0])
def test_se3_log(scale):
    # angles kept below pi - 0.1, where the axis-angle is unique
    xi = _twists(1, scale=scale)
    ang = np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
    xi[:, 3:] *= np.minimum(1.0, (np.pi - 0.1) / np.maximum(ang, 1e-12))
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    got = tse3.se3_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.se3_log(jnp.asarray(T))), atol=ATOL)


def test_so3_log_near_pi():
    w = np.array([[np.pi - 5e-4, 0.0, 0.0], [0.0, 0.0, np.pi - 1e-4]], np.float32)
    R = np.array(jse3.so3_exp(jnp.asarray(w)))
    got = tse3.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.so3_log(jnp.asarray(R))), atol=1e-4)  # arccos near pi loses ~3 digits


def test_compose_and_inverse():
    A, B = _transforms(2), _transforms(3)
    np.testing.assert_allclose(
        tse3.se3_compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
        np.asarray(jse3.se3_compose(jnp.asarray(A), jnp.asarray(B))), atol=ATOL,
    )
    np.testing.assert_allclose(
        tse3.se3_inverse(torch.from_numpy(A)).numpy(), np.asarray(jse3.se3_inverse(jnp.asarray(A))), atol=ATOL
    )


def test_transform_points_and_geodesic():
    T = _transforms(4, 8)
    pts = np.random.RandomState(5).rand(8, 20, 3).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=ATOL,
    )
    R1, R2 = T[:, :3, :3], _transforms(6, 8)[:, :3, :3]
    np.testing.assert_allclose(
        tse3.rotation_geodesic_distance(torch.from_numpy(R1), torch.from_numpy(R2)).numpy(),
        np.asarray(jse3.rotation_geodesic_distance(jnp.asarray(R1), jnp.asarray(R2))), atol=1e-4,  # arccos slope near 0
    )


def test_se3_update_left():
    delta = _twists(7, 8, 0.01)
    T = _transforms(8, 8)
    np.testing.assert_allclose(
        tse3.se3_update_left(torch.from_numpy(delta), torch.from_numpy(T)).numpy(),
        np.asarray(jse3.se3_update_left(jnp.asarray(delta), jnp.asarray(T))), atol=ATOL,
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch(weighted):
    rng = np.random.RandomState(9)
    T = _transforms(10, 4)
    src = rng.rand(4, 50, 3).astype(np.float32) - 0.5
    dst = np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
    dst = (dst + 1e-3 * rng.randn(*dst.shape)).astype(np.float32)
    w = rng.rand(4, 50).astype(np.float32) if weighted else None
    got = tproc.kabsch(torch.from_numpy(src), torch.from_numpy(dst), None if w is None else torch.from_numpy(w))
    ref = jproc.kabsch(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    # the SVD's sign conventions differ between libraries; R and t do not
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_rigid_from_three_points():
    rng = np.random.RandomState(11)
    T = _transforms(12, 64)
    src = rng.rand(64, 3, 3).astype(np.float32)
    src[0, 2] = src[0, 0]  # degenerate (repeated vertex): invalid
    dst = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]).astype(np.float32)
    got_T, got_ok = tproc.rigid_from_three_points(torch.from_numpy(src), torch.from_numpy(dst))
    ref_T, ref_ok = jproc.rigid_from_three_points(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    ok = np.asarray(ref_ok)
    np.testing.assert_allclose(got_T.numpy()[ok], np.asarray(ref_T)[ok], atol=ATOL)
