"""Frontend output contract shared by keypoint extractors (padded, fixed-size)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrontendOutput(NamedTuple):
    """Padded keypoints for one frame.

    kpts_uv: [N, 2] float pixel coords (u, v) in the original image.
    scores:  [N] detection scores (descending).
    desc:    [N, D] L2-normalized descriptors.
    valid:   [N] bool.
    """

    kpts_uv: torch.Tensor
    scores: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
