"""Synthetic RGB-D sequences with ground truth: the easy textured cube and
the hard, degraded multi-shape world."""

from bundletrack_tpu_torch.data.hard_world import (
    HardSequence,
    hard_passes,
    model_points,
    render_hard_sequence,
)
from bundletrack_tpu_torch.data.synthetic import SyntheticSequence, render_synthetic_sequence

__all__ = [
    "render_synthetic_sequence",
    "SyntheticSequence",
    "HardSequence",
    "hard_passes",
    "model_points",
    "render_hard_sequence",
]
