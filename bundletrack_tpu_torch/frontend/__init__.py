"""Keypoint frontends: the classical Shi-Tomasi frontend, LF-Net, and 3D lifting."""

from bundletrack_tpu_torch.frontend.classical import harris_keypoints_and_descriptors
from bundletrack_tpu_torch.frontend.interface import FrontendOutput
from bundletrack_tpu_torch.frontend.lfnet import init_lfnet, load_params_npz, make_lfnet_apply, save_params_npz
from bundletrack_tpu_torch.frontend.pipeline import extract_frame_features

__all__ = [
    "FrontendOutput",
    "harris_keypoints_and_descriptors",
    "extract_frame_features",
    "init_lfnet",
    "load_params_npz",
    "make_lfnet_apply",
    "save_params_npz",
]
