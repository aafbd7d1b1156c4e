"""SE(3)/SO(3), Huber, Kabsch and 3-point Procrustes, pinhole camera."""

from bundletrack_tpu_torch.geometry.camera import bilinear_sample, project, scale_intrinsics, unproject
from bundletrack_tpu_torch.geometry.procrustes import kabsch, rigid_from_three_points, umeyama_rigid
from bundletrack_tpu_torch.geometry.robust import huber, huber_weight
from bundletrack_tpu_torch.geometry.se3 import (
    hat,
    rotation_geodesic_distance,
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
    transform_normals,
    transform_points,
    vee,
)

__all__ = [
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "se3_inverse",
    "se3_compose",
    "transform_points",
    "transform_normals",
    "rotation_geodesic_distance",
    "hat",
    "vee",
    "huber",
    "huber_weight",
    "kabsch",
    "rigid_from_three_points",
    "umeyama_rigid",
    "project",
    "unproject",
    "scale_intrinsics",
    "bilinear_sample",
]
