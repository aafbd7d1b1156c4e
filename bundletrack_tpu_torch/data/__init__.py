"""Synthetic RGB-D sequences with ground truth."""

from bundletrack_tpu_torch.data.synthetic import SyntheticSequence, render_synthetic_sequence

__all__ = ["SyntheticSequence", "render_synthetic_sequence"]
