"""Parity of the port's depth/cloud/mask ops and classical frontend with the JAX package.

Inputs are rendered frames (numpy, fixed seed).  Each stage gets the same
inputs on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import DepthProcessingConfig, SegmentationConfig
from bundletrack_tpu.data import render_synthetic_sequence as jax_render
from bundletrack_tpu.frontend.classical import harris_keypoints_and_descriptors as j_harris
from bundletrack_tpu.frontend.pipeline import _lift_to_3d as j_lift
from bundletrack_tpu.ops.depth import process_depth as j_process_depth
from bundletrack_tpu.ops.masks import dilate_mask as j_dilate
from bundletrack_tpu.ops.masks import mask_roi as j_mask_roi
from bundletrack_tpu.ops.masks import preprocess_mask as j_preprocess_mask
from bundletrack_tpu.ops.pointcloud import depth_to_cloud_and_normals as j_cloud
from bundletrack_tpu_torch import config as tcfg
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.frontend.classical import harris_keypoints_and_descriptors
from bundletrack_tpu_torch.frontend.interface import FrontendOutput
from bundletrack_tpu_torch.frontend.pipeline import _lift_to_3d
from bundletrack_tpu_torch.ops.depth import process_depth
from bundletrack_tpu_torch.ops.masks import dilate_mask, mask_roi, preprocess_mask
from bundletrack_tpu_torch.ops.pointcloud import depth_to_cloud_and_normals

torch.set_num_threads(2)

H, W = 120, 160


@pytest.fixture(scope="module")
def frames():
    seq = render_synthetic_sequence(num_frames=3, H=H, W=W, orbit_deg_per_frame=4.0, depth_noise=0.002)
    out = []
    for f in range(3):
        depth = np.array(j_process_depth(jnp.asarray(seq.depth[f]), DepthProcessingConfig()))
        pts, nrm, val = (np.array(a) for a in j_cloud(jnp.asarray(depth), jnp.asarray(seq.K)))
        mask = np.asarray(j_preprocess_mask(jnp.asarray(seq.mask[f]), SegmentationConfig())) & (depth > 0.1)
        out.append(dict(gray=seq.gray[f], raw_depth=seq.depth[f], raw_mask=seq.mask[f], depth=depth,
                        pts=pts, nrm=nrm, val=val & mask, mask=mask))
    return seq, out


def test_synthetic_copy_renders_the_same_frames():
    a = render_synthetic_sequence(num_frames=2, H=48, W=64, seed=3, depth_noise=0.001)
    b = jax_render(num_frames=2, H=48, W=64, seed=3, depth_noise=0.001)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("f", [0, 2])
def test_process_depth(frames, f):
    seq, fr = frames
    got = process_depth(torch.from_numpy(seq.depth[f]), tcfg.DepthProcessingConfig()).numpy()
    # f32 stencil sums in the same order; exp/division may differ by an ulp
    np.testing.assert_allclose(got, fr[f]["depth"], atol=1e-6)


@pytest.mark.parametrize("f", [0, 2])
def test_depth_to_cloud_and_normals(frames, f):
    seq, fr = frames
    pts, nrm, val = depth_to_cloud_and_normals(torch.from_numpy(fr[f]["depth"]), torch.from_numpy(seq.K))
    np.testing.assert_allclose(pts.numpy(), fr[f]["pts"], atol=1e-6)  # one multiply-divide chain per pixel
    np.testing.assert_allclose(nrm.numpy(), fr[f]["nrm"], atol=1e-5)  # normalized cross products, O(1)
    ref_val = np.asarray(j_cloud(jnp.asarray(fr[f]["depth"]), jnp.asarray(seq.K))[2])
    np.testing.assert_array_equal(val.numpy(), ref_val)


def test_masks(frames):
    seq, _ = frames
    m = seq.mask[1]
    np.testing.assert_array_equal(dilate_mask(torch.from_numpy(m), 2).numpy(), np.asarray(j_dilate(jnp.asarray(m), 2)))
    np.testing.assert_array_equal(
        preprocess_mask(torch.from_numpy(m), tcfg.SegmentationConfig()).numpy(),
        np.asarray(j_preprocess_mask(jnp.asarray(m), SegmentationConfig())),
    )
    for blank in (m, np.zeros_like(m)):
        got = [int(x) for x in mask_roi(torch.from_numpy(blank))]
        ref = [int(x) for x in j_mask_roi(jnp.asarray(blank))]
        assert got == ref


def test_nocs_mask_fill_not_ported():
    """The NOCS mask fill is ported now: the chain equals the JAX package's,
    on a rendered mask and on an empty one (tests/test_torch_nocs.py holds
    each fill to JAX on more masks)."""
    for m in (jax_render(num_frames=1, H=48, W=64).mask[0], np.zeros((8, 8), bool)):
        got = preprocess_mask(torch.from_numpy(m), tcfg.SegmentationConfig(nocs_mask_fill=True)).numpy()
        want = np.asarray(j_preprocess_mask(jnp.asarray(m), SegmentationConfig(nocs_mask_fill=True)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f,top_k,z0", [(0, 128, 0.55), (1, 256, 0.55), (2, 128, 0.0)])
def test_classical_keypoints_and_descriptors(frames, f, top_k, z0):
    _, fr = frames
    d = fr[f]
    kw = dict(top_k=top_k, sigma=1.0, patch_z0=z0)
    got = harris_keypoints_and_descriptors(
        torch.from_numpy(d["gray"]), torch.from_numpy(d["mask"]), z_map=torch.from_numpy(d["pts"][..., 2]), **kw
    )
    ref = j_harris(jnp.asarray(d["gray"]), jnp.asarray(d["mask"]), z_map=jnp.asarray(d["pts"][..., 2]), **kw)
    # keypoints: exact — same response arithmetic, and the same tie order in
    # the bucketed top-K (stable sort = lax.top_k's lower-index-first)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.kpts_uv.numpy(), np.asarray(ref.kpts_uv))
    assert int(got.valid.sum()) > 20
    # descriptors: unit vectors built from f32 means/std; 1e-5 covers the
    # reduction order
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc), atol=1e-5)


def test_lift_to_3d(frames):
    _, fr = frames
    d = fr[0]
    ref = j_harris(jnp.asarray(d["gray"]), jnp.asarray(d["mask"]), top_k=128, sigma=1.0)
    feats = _lift_to_3d(
        FrontendOutput(*(torch.from_numpy(np.array(a)) for a in ref)),
        torch.from_numpy(d["pts"]), torch.from_numpy(d["nrm"]), torch.from_numpy(d["val"]),
    )
    jf = j_lift(ref, jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]), jnp.asarray(d["val"]))
    np.testing.assert_array_equal(feats.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(feats.pts.numpy(), np.asarray(jf.pts))  # pure gathers: exact
    np.testing.assert_array_equal(feats.normals.numpy(), np.asarray(jf.normals))
