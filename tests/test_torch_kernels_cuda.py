"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels_cuda.py -q
"""

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


@pytest.mark.cuda
def test_tracker_on_the_card_matches_the_cpu():
    """The same frames and RANSAC phases through the step on both devices."""
    _need_card()
    H, W = 120, 160
    cfg = TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4), keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=FrontendConfig(top_k=128), ransac=RansacConfig(max_iter=256),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )
    seq = render_synthetic_sequence(num_frames=5, H=H, W=W, orbit_deg_per_frame=4.0)
    rng = np.random.RandomState(0)
    phases = [(rng.randint(0, 128, (3, 2)), rng.randint(0, 128, (6, 3, 2))) for _ in range(5)]
    poses = {}
    for device in ("cuda", "cpu"):
        trk = Tracker(cfg, H, W, device=device)
        for f in range(5):
            out = trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K,
                                    np.linalg.inv(seq.ob_in_cam[0]), phases=phases[f])
            assert int(out.status) == 0
        poses[device] = out.ob_in_cam.cpu().numpy()
    # f32 on both devices; sums run in other orders (scatter-adds on CUDA
    # vary from run to run), so 1e-4 m / 1e-4 on rotation entries
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-4)
