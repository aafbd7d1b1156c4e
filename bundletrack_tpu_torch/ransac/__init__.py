"""Batched 3-point RANSAC."""

from bundletrack_tpu_torch.ransac.ransac import RansacResult, ransac_multi_pair, ransac_pair

__all__ = ["ransac_pair", "ransac_multi_pair", "RansacResult"]
