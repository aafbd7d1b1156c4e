"""The precision the reference computes in: as the configuration states it,
or, for the control (`set_control(True)`), one step below.

The configuration states f32 for the tracker and bf16 for the matcher's
descriptor products and the LF-Net forward.  The control rounds every f32
operand at the layer boundaries listed below to bf16 (the observation's
gray and depth, the lifted keypoints and descriptors, RANSAC's match
points, the Gauss-Newton inputs), and the bf16 operands of the matcher's
products and of the LF-Net convolutions and dense layers to fp8 (e4m3,
one scale per tensor, as fp8 products are run).  The reference's own
runs never set it.
"""

from __future__ import annotations

import torch

CONTROL = False
FP8_MAX = 448.0  # largest finite e4m3 value


def set_control(on: bool) -> None:
    global CONTROL
    CONTROL = bool(on)


def low(x: torch.Tensor) -> torch.Tensor:
    """x as computed in the stated f32, or rounded to bf16 in the control."""
    if not CONTROL or not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the tensor, in x's dtype."""
    scale = torch.clamp(torch.amax(torch.abs(x.float())), min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of a bf16 product, as f32: bf16-rounded, or e4m3 in the control."""
    x = x.float()
    return fp8(x) if CONTROL else x.to(torch.bfloat16).to(torch.float32)


def net_operand(x: torch.Tensor) -> torch.Tensor:
    """A convolution's or dense layer's operand in the LF-Net forward: as it
    is, or rounded to e4m3 in the control."""
    return fp8(x) if CONTROL else x
