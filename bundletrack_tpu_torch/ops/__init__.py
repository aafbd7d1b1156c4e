"""Depth filtering, cloud + normals, masks, resizes, and the port's top-k /
scatter helpers."""

from bundletrack_tpu_torch.ops.depth import bilateral_filter_depth, erode_depth, process_depth
from bundletrack_tpu_torch.ops.masks import (
    convex_hull_fill,
    dilate_mask,
    largest_component_fill,
    mask_roi,
    preprocess_mask,
)
from bundletrack_tpu_torch.ops.pointcloud import compute_normals, depth_to_cloud_and_normals, downsample_nearest
from bundletrack_tpu_torch.ops.resize import crop_resize_square, keypoints_to_original, resize_bilinear

__all__ = [
    "erode_depth",
    "bilateral_filter_depth",
    "process_depth",
    "compute_normals",
    "depth_to_cloud_and_normals",
    "downsample_nearest",
    "dilate_mask",
    "mask_roi",
    "largest_component_fill",
    "convex_hull_fill",
    "preprocess_mask",
    "crop_resize_square",
    "resize_bilinear",
    "keypoints_to_original",
]
