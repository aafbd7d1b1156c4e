"""The products of one batched LF-Net forward, counted from its shapes.

profile_step's count, frozen here and run on the reference's copy of the
network (the same layers at the same shapes): 2 FLOP per multiply-add of
every convolution and dense layer, and of the dense resize matrices, by
the dtype they run in.
"""

from __future__ import annotations

import collections

import torch


def lfnet_flop(apply, streams: int, side: int, device) -> dict:
    """{"bf16": FLOP, "f32": FLOP} of one forward of `apply` (the
    reference's LFNetApply) on `streams` crops of side x side."""
    from trackbench.reference.frontend import lfnet as lf
    from trackbench.reference.utils.flax_layers import Conv, Dense

    flop = collections.Counter()

    def count(mod, inp, out):
        flop[_dtype(mod.dtype)] += 2 * out.numel() * mod.weight[0].numel()

    resize = lf.resize_bilinear

    def counted_resize(img, out_hw):
        H, W = img.shape[-2:]
        oh, ow = out_hw
        macs = (oh * H * W if oh != H else 0) + (oh * W * ow if ow != W else 0)
        flop[_dtype(img.dtype)] += 2 * (img.numel() // (H * W)) * macs
        return resize(img, out_hw)

    hooks = [m.register_forward_hook(count) for m in apply.modules() if isinstance(m, (Conv, Dense))]
    lf.resize_bilinear = counted_resize
    try:
        apply(torch.zeros((streams, side, side, 1), device=device))
    finally:
        lf.resize_bilinear = resize
        for h in hooks:
            h.remove()
    return dict(flop)


def _dtype(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"
