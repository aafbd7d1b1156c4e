"""Configuration for the PyTorch tracker.

The port's own copy of the typed configuration: the same dataclasses, field
names and defaults as the JAX package, so a configuration built for one loads
unchanged in the other.  It covers the reference YAML surface
(config_ycbineoat.yml, config_nocs.yml) plus the static capacities
(keypoint, match, pair and trial padding) the tracker step is shaped by.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional


def _frozen(cls):
    return dataclass(frozen=True)(cls)


@_frozen
class ErodeConfig:
    radius: int = 1
    diff: float = 0.001
    ratio: float = 0.8  # if the fraction of differing neighbors exceeds this, zero depth


@_frozen
class BilateralConfig:
    radius: int = 2
    sigma_d: float = 2.0
    sigma_r: float = 100000.0


@_frozen
class OutlierRemovalConfig:
    num: int = 30
    std_mul: float = 3.0


@_frozen
class DepthProcessingConfig:
    erode: ErodeConfig = ErodeConfig()
    bilateral_filter: BilateralConfig = BilateralConfig()
    outlier_removal: OutlierRemovalConfig = OutlierRemovalConfig()
    zfar: float = 2.0
    znear: float = 0.1


@_frozen
class BundleConfig:
    """Pose-graph optimizer settings (reference: config bundle.*)."""

    num_iter_outer: int = 7
    num_iter_inner: int = 5  # PCG inner iterations (the "pcg" backend is not ported yet)
    window_size: int = 2  # parsed, not used (the keyframe pool takes its role)
    max_ba_frames: int = 16
    subset_selection_method: str = "greedy_rot"
    robust_delta: float = 0.005
    min_fm_edges_newframe: int = 5
    image_downscale: int = 4  # dense point-to-plane term resolution divisor
    dense_src_capacity: int = 4096  # compacted valid source pixels per frame
    solver_backend: str = "cholesky"  # only "cholesky" is ported
    lm_lambda: float = 1e-6
    w_sparse: float = 1.0
    w_dense_depth: float = 1.0
    w_dense_color: float = 0.0  # the photometric term is not ported yet
    early_stop_delta: float = 0.0  # > 0: a graph stops once its max |delta| is below it
    use_verification: bool = False
    verify_dist_thresh: float = 0.02
    verify_percent_thresh: float = 0.05
    ba_mesh_axis: str = ""  # multi-device pair sharding; not ported yet


@_frozen
class KeyframeConfig:
    min_interval: int = 1
    min_feat_num: int = 0
    min_rot: float = 10.0  # degrees of rotation from every existing keyframe
    pool_size: int = 32  # static capacity of the keyframe pool


@_frozen
class FeatureCorresConfig:
    """Geometric gates for descriptor matching (reference feature_corres.*)."""

    mutual: bool = True
    max_dist_no_neighbor: float = 0.02
    max_normal_no_neighbor: float = 45.0
    max_dist_neighbor: float = 0.03
    max_normal_neighbor: float = 45.0
    map_points: bool = True  # propagate matches through the landmark table


@_frozen
class RansacConfig:
    max_iter: int = 2000
    num_sample: int = 3
    inlier_dist: float = 0.01
    inlier_normal_angle: float = 45.0
    max_trans_neighbor: float = 0.05
    max_rot_deg_neighbor: float = 45.0
    max_trans_no_neighbor: float = 0.02
    max_rot_no_neighbor: float = 10.0
    epsilon: float = 1e-8
    min_match_after_ransac: int = 5
    # after a FAIL, require this many neighbor-RANSAC inliers to re-acquire
    reinit_min_matches: int = 15


@_frozen
class P2PConfig:
    """Dense point-to-plane association gates (reference p2p.*)."""

    max_dist: float = 0.02
    max_normal_angle: float = 45.0
    min_pair_pixels: int = 800


@_frozen
class FrontendConfig:
    """Keypoint frontend settings: the classical frontend and LF-Net
    (reference: lf-net-release/run_server.py:66-106)."""

    kind: str = "classical"  # "lfnet" | "classical"
    input_size: int = 400
    top_k: int = 512
    desc_dim: int = 256
    net_block: int = 3
    net_channel: int = 16
    conv_ksize: int = 3
    net_min_scale: float = 0.5
    net_max_scale: float = 2.0
    net_num_scales: int = 5
    sm_ksize: int = 15
    com_strength: float = 100.0
    score_com_strength: float = 100.0
    scale_com_strength: float = 100.0
    nms_thresh: float = 0.0
    nms_ksize: int = 5
    crop_radius: int = 16
    patch_size: int = 32
    kp_loc_size: int = 9
    soft_kpts: bool = True
    soft_scale: bool = True
    do_softmax_kp_refine: bool = True
    kp_com_strength: float = 1.0
    desc_net_channel: int = 64
    desc_net_depth: int = 3
    desc_conv_ksize: int = 3
    norm: str = "gn"
    bf16: bool = True
    # classical frontend
    harris_k: float = 0.04
    harris_sigma: float = 1.0
    # depth-scaled descriptor patches: sample spacing z0/z so a patch covers
    # a constant physical extent; 0 disables (fixed 16-px patches)
    harris_patch_z0: float = 0.55


@_frozen
class SegmentationConfig:
    """Mask settings: the NOCS mask fill the tracker's preprocess reads,
    and the VOS mask propagator's settings (models/vos.py)."""

    seg_dilation_iter: int = 0  # parsed, not used (the reference always dilates once)
    nocs_mask_fill: bool = False
    backbone: str = "resnet18"
    ref_num: int = 9
    sigma1: float = 8.0
    sigma2: float = 21.0
    temperature: float = 0.05
    range_: int = 40
    downscale: int = 8
    history_cap: int = 48  # feature-ring capacity; >= range_, or older wanted ages snap to the oldest frame
    anchor_first: bool = True  # keep frame 0 (the given mask) as the last, sparse reference

    def long_range(self, num_frames: int) -> "SegmentationConfig":
        """Widen the sparse-reference window to cover a long sequence: range_
        up to 100 frames, and a ring large enough to hold it."""
        rg = min(int(num_frames), 100)
        if rg <= self.range_:
            return self
        cap = max(self.history_cap, rg + 28)
        return dataclasses.replace(self, range_=rg, history_cap=cap)


@_frozen
class ShapeConfig:
    """Static capacities that replace the reference's dynamic containers."""

    max_matches: int = 256  # per-pair correspondence capacity M
    max_landmarks: int = 2048  # map-point table capacity
    image_h: int = 480
    image_w: int = 640


@_frozen
class TrackerConfig:
    data_dir: str = ""
    mask_dir: str = ""
    model_name: str = ""
    model_dir: str = ""
    debug_dir: str = ""
    log_level: int = 0
    use_6pack_datalist: bool = False

    depth_processing: DepthProcessingConfig = DepthProcessingConfig()
    bundle: BundleConfig = BundleConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    feature_corres: FeatureCorresConfig = FeatureCorresConfig()
    ransac: RansacConfig = RansacConfig()
    p2p: P2PConfig = P2PConfig()
    frontend: FrontendConfig = FrontendConfig()
    segmentation: SegmentationConfig = SegmentationConfig()
    shapes: ShapeConfig = ShapeConfig()

    def replace(self, **kw) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)


def nocs_config(**overrides) -> TrackerConfig:
    """NOCS-REAL275 preset (reference: config_nocs.yml deltas vs ycbineoat)."""
    cfg = TrackerConfig(
        use_6pack_datalist=True,
        bundle=BundleConfig(min_fm_edges_newframe=10),
        feature_corres=FeatureCorresConfig(max_dist_neighbor=10000.0, max_normal_neighbor=180.0),
        ransac=RansacConfig(inlier_dist=0.005, max_trans_neighbor=0.2, max_rot_deg_neighbor=25.0),
        segmentation=SegmentationConfig(seg_dilation_iter=3, nocs_mask_fill=True),
    )
    return cfg.replace(**overrides) if overrides else cfg


def ycbineoat_config(**overrides) -> TrackerConfig:
    cfg = TrackerConfig()
    return cfg.replace(**overrides) if overrides else cfg


# Reference YAML key -> our field name
_YAML_ALIASES = {
    "LOG": "log_level",
    "num_iter_outter": "num_iter_outer",
    "max_BA_frames": "max_ba_frames",
    "sigma_D": "sigma_d",
    "sigma_R": "sigma_r",
}


def _update_dataclass(dc, data: Mapping[str, Any]):
    """Recursively rebuild a frozen dataclass from a nested mapping."""
    kw = {}
    names = {f.name for f in dataclasses.fields(dc)}
    for key, val in data.items():
        name = _YAML_ALIASES.get(key, key)
        if name not in names:
            continue
        cur = getattr(dc, name)
        if dataclasses.is_dataclass(cur) and isinstance(val, Mapping):
            kw[name] = _update_dataclass(cur, val)
        else:
            kw[name] = val
    return dataclasses.replace(dc, **kw)


def load_config(path_or_dict, base: Optional[TrackerConfig] = None) -> TrackerConfig:
    """Load a TrackerConfig from a reference-format YAML file or a dict.

    Unknown keys (for example the reference's unused `sift:` block) are
    ignored, so reference configurations load unmodified.
    """
    base = base or TrackerConfig()
    if isinstance(path_or_dict, Mapping):
        data = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            data = yaml.safe_load(f)
    return _update_dataclass(base, data)
