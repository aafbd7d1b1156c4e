"""The LF-Net keypoint frontend in PyTorch: detector + descriptor, NCHW.

Counterpart of bundletrack_tpu/frontend/lfnet.py (reference:
lf-net-release/models/mso_resnet_detector.py get_model, inference.py
build_multi_scale_deep_detector_3DNMS and build_patch_extraction,
models/simple_desc.py get_model).  It runs the trained weights the repo
ships in checkpoints/lfnet_params.npz, which hold the JAX package's Flax
parameters; `lfnet_state_dict_from_flax` carries them over.

What follows the Flax module exactly, because the checkpoint depends on it:
- every conv pads "SAME" and every norm is Flax's GroupNorm(1)
  (utils/flax_layers.py);
- the descriptor flattens its [C, 4, 4] maps, while Flax flattened [4, 4, C]:
  the carry-over reorders fc1's input rows to match.

With `bf16` (inference only) the forward computes what jax.jit of the Flax
module computes, as every JAX path runs it (the tracker step, the frontend
evaluation), read from XLA's compiled CPU program at input 96, 192 and
400: every conv and dense product takes bf16 operands, accumulates in f32
and is rounded once to bf16, and its bias, rounded to bf16, is added in f32
without rounding again; a residual block returns r(conv2) + r(x) in f32
(r = round to bf16); every norm's statistics read its input rounded to
bf16 and normalise the input itself (`XlaGroupNorm`), with the sums in
XLA's order (the sums kernel, kernels/norm_sums.py), as are the photo's
and the score maps' instance norms; the per-scale resize
runs in bf16, each of its two products rounded; the score maps and fc2's
output stay f32, unrounded; the orientation conv runs in f32.  What is
left unmatched: XLA's approximate rsqrt, and the products' f32 sums, which
cuDNN / oneDNN add in another order than XLA.  The f32 forward (training)
is the module's plain arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from trackbench.reference.config import FrontendConfig
from trackbench.reference.frontend.detector_ops import (
    end_of_frame_mask,
    instance_norm,
    instance_norms,
    non_max_suppression_mask,
    soft_argmax_2d,
    soft_max_and_argmax_1d,
    soft_nms_3d,
    top_k_keypoints,
    transformer_crop,
)
from trackbench.reference.frontend.interface import FrontendOutput
from trackbench.reference.ops.numerics import clip, round_bf16
from trackbench.reference.ops.resize import resize_bilinear
from trackbench.reference.utils import params_io
from trackbench.reference.utils.flax_layers import (
    Conv,
    Dense,
    GroupNorm,
    XlaGroupNorm,
    channel_shape,
    flax_param_shapes,
    state_dict_from_flax,
)


class FrozenBN(nn.Module):
    """Inference-mode batch norm with ported running statistics (reference
    common/tf_layer_utils.py:130, epsilon 1e-3), in f32.  The statistics
    are parameters, as in the Flax module, so a training step moves them
    too: kept for parity with the JAX trainer."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        shape = channel_shape(x)
        x = x.to(torch.float32)
        return ((x - self.mean.view(shape)) * torch.rsqrt(self.var.view(shape) + self.eps)
                * self.scale.view(shape) + self.bias.view(shape))


def _make_norm(kind: str, c: int, dtype=torch.float32) -> nn.Module:
    if kind == "bn":
        return FrozenBN(c)
    if dtype == torch.bfloat16:  # the jitted forward's norm (module docstring)
        return XlaGroupNorm(c)
    return GroupNorm(c, num_groups=1)


class ResBlock(nn.Module):
    """Pre-activation residual block (reference building_block)."""

    def __init__(self, channels: int, ksize: int = 3, norm: str = "gn", dtype=torch.float32):
        super().__init__()
        self.pre_norm = _make_norm(norm, channels, dtype)
        self.conv1 = Conv(channels, channels, ksize, dtype=dtype)
        self.mid_norm = _make_norm(norm, channels, dtype)
        self.conv2 = Conv(channels, channels, ksize, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        h = self.conv1(F.relu(self.pre_norm(x)))
        h = self.conv2(F.relu(self.mid_norm(h)))
        if self.dtype == torch.bfloat16:  # r(conv2) + r(x), in f32
            return round_bf16(h) + round_bf16(x)
        return h + x


class MSODetector(nn.Module):
    """Multi-Scale-Orientation detector (reference get_model)."""

    def __init__(self, num_blocks=3, channels=16, ksize=3, num_scales=5, min_scale=0.5,
                 max_scale=2.0, norm="gn", dtype=torch.float32):
        super().__init__()
        self.num_scales, self.min_scale, self.max_scale = num_scales, min_scale, max_scale
        self.dtype = dtype
        self.init_conv = Conv(1, channels, ksize, dtype=dtype)
        for i in range(num_blocks):
            setattr(self, f"block_{i + 1}", ResBlock(channels, ksize, norm, dtype))
        self.num_blocks = num_blocks
        self.final_norm = _make_norm(norm, channels, dtype)
        for i in range(num_scales):
            setattr(self, f"score_conv_{i}", Conv(channels, 1, ksize, dtype=dtype))
        self.ori_conv = Conv(channels, 2, ksize, dtype=torch.float32)  # no dtype in Flax: f32
        # the scale values on the module's device: uploading them per call
        # from host memory would synchronise
        self.register_buffer("scale_values", torch.from_numpy(self.scale_factors()), persistent=False)

    def scale_factors(self) -> np.ndarray:
        """Host constants, float32, as the JAX package computes them."""
        if self.num_scales == 1:
            return np.array([1.0], np.float32)
        return np.exp(
            np.linspace(np.log(self.max_scale), np.log(self.min_scale), self.num_scales)
        ).astype(np.float32)

    def forward(self, photos):  # [B, 1, H, W] f32
        H, W = photos.shape[-2:]
        x = self.init_conv(photos)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i + 1}")(x)
        feat_maps = F.relu(self.final_norm(x))  # f32
        # the per-scale resize (two products, each rounded in bf16) and the
        # score conv run in the compute dtype; the score maps come out f32
        feat_rs = feat_maps.to(self.dtype)
        score_maps = []
        for i, s in enumerate(self.scale_factors()):
            inv_s = 1.0 / float(s)
            fh, fw = int(H * inv_s + 0.5), int(W * inv_s + 0.5)
            rs = resize_bilinear(feat_rs, (fh, fw))
            score_maps.append(getattr(self, f"score_conv_{i}")(rs))
        ori = self.ori_conv(feat_maps)
        ori = ori / clip(torch.linalg.vector_norm(ori, dim=1, keepdim=True), 1e-6)
        return score_maps, ori, feat_maps


class SimpleDesc(nn.Module):
    """Patch descriptor (reference simple_desc.py get_model)."""

    def __init__(self, out_dim=256, init_channels=64, num_layers=3, ksize=3, norm="gn",
                 patch_size=32, dtype=torch.float32):
        super().__init__()
        cin, side = 1, patch_size
        for i in range(num_layers):
            cout = init_channels * (2 ** i)
            setattr(self, f"conv{i + 1}", Conv(cin, cout, ksize, stride=2, dtype=dtype))
            setattr(self, f"norm{i + 1}", _make_norm(norm, cout, dtype))
            cin, side = cout, -(-side // 2)
        self.num_layers = num_layers
        self.fc1 = Dense(cin * side * side, 512, dtype=dtype)
        self.fc1_norm = _make_norm(norm, 512, dtype)
        self.fc2 = Dense(512, out_dim, dtype=dtype)

    def forward(self, patches):  # [N, 1, P, P]
        x = patches
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i + 1}")(x)
            x = F.relu(getattr(self, f"norm{i + 1}")(x))
        x = x.reshape(x.shape[0], -1)  # (c, h, w) order: fc1's rows were reordered to it
        x = F.relu(self.fc1_norm(self.fc1(x)))
        x = self.fc2(x)  # f32 (in bf16 unrounded after the bias add)
        return x / clip(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


class LFNet(nn.Module):
    """Detector -> 3D soft NMS -> top-K -> oriented patches -> descriptor
    (reference build_multi_scale_deep_detector_3DNMS + build_patch_extraction)."""

    def __init__(self, cfg: FrontendConfig):
        super().__init__()
        self.cfg = c = cfg
        dtype = torch.bfloat16 if c.bf16 else torch.float32
        self.detector = MSODetector(
            num_blocks=c.net_block, channels=c.net_channel, ksize=c.conv_ksize,
            num_scales=c.net_num_scales, min_scale=c.net_min_scale,
            max_scale=c.net_max_scale, norm=c.norm, dtype=dtype,
        )
        self.descriptor = SimpleDesc(
            out_dim=c.desc_dim, init_channels=c.desc_net_channel, num_layers=c.desc_net_depth,
            ksize=c.desc_conv_ksize, norm=c.norm, patch_size=c.patch_size, dtype=dtype,
        )

    def describe_patches(self, patches):
        """The descriptor tower alone on patches [N, 1, P, P] -> [N, D] (the
        training step describes warped patches with it)."""
        return self.descriptor(patches)

    def forward(self, photos, return_endpoints: bool = False):
        """photos [B, 1, H, W] gray in [0, 1] -> FrontendOutput with
        kpts_uv [B, K, 2], scores [B, K], desc [B, K, D], valid [B, K].

        With `return_endpoints`, (out, ep): ep holds the maps the training
        loss reads, channels-first where the JAX package's are channels-last:
        max_heat [B, 1, H, W], max_scale [B, H, W], ori_maps [B, 2, H, W],
        feat_maps [B, C, H, W] and photos_n [B, 1, H, W]."""
        c = self.cfg
        B, _, H, W = photos.shape
        dev = photos.device
        photos_n = instance_norm(photos, xla_order=c.bf16)
        score_maps, ori_maps, feat_maps = self.detector(photos_n)
        scale_factors = self.detector.scale_values

        normed = instance_norms(score_maps) if c.bf16 else [instance_norm(sm) for sm in score_maps]
        scale_logits = torch.cat([resize_bilinear(sm, (H, W)) for sm in normed], dim=1)
        heat = soft_nms_3d(scale_logits, ksize=c.sm_ksize, com_strength=c.com_strength)
        if c.soft_scale:
            max_heat, max_scale = soft_max_and_argmax_1d(
                heat, scale_factors, dim=1, com1=c.score_com_strength, com2=c.scale_com_strength,
            )
            max_heat = max_heat[:, None]
        else:
            max_heat = torch.amax(heat, dim=1, keepdim=True)
            max_scale = scale_factors[torch.argmax(heat, dim=1)]

        pad = (c.net_block * 2 + 2) * (c.conv_ksize // 2)
        max_heat = max_heat * end_of_frame_mask(H, W, pad, device=dev)
        nms = non_max_suppression_mask(max_heat, c.nms_thresh, c.nms_ksize)
        scores = max_heat * nms.to(max_heat.dtype) * end_of_frame_mask(H, W, c.crop_radius, device=dev)

        kpts, kp_scores, valid = top_k_keypoints(scores, c.top_k)  # [B, K, 2]
        batch_inds = torch.arange(B, device=dev).repeat_interleave(c.top_k)
        kpts_flat = kpts.reshape(-1, 2)
        xi = torch.clamp(kpts_flat[:, 0].to(torch.int64), 0, W - 1)
        yi = torch.clamp(kpts_flat[:, 1].to(torch.int64), 0, H - 1)
        kp_scale = max_scale[batch_inds, yi, xi]
        kp_ori = ori_maps[batch_inds, :, yi, xi]

        if c.soft_kpts:
            local = transformer_crop(max_heat, c.kp_loc_size, batch_inds, kpts_flat, kpts_scale=kp_scale)
            dxdy = soft_argmax_2d(local, do_softmax=c.do_softmax_kp_refine, com=c.kp_com_strength)
            kpts_flat = kpts_flat + dxdy * kp_scale[:, None] * (c.kp_loc_size / 2.0)

        patches = transformer_crop(photos_n, c.patch_size, batch_inds, kpts_flat,
                                   kpts_scale=kp_scale, kpts_ori=kp_ori)
        desc = self.descriptor(patches)
        out = FrontendOutput(
            kpts_uv=kpts_flat.reshape(B, c.top_k, 2),
            scores=kp_scores,
            desc=desc.reshape(B, c.top_k, -1),
            valid=valid,
        )
        if return_endpoints:
            return out, {"max_heat": max_heat, "max_scale": max_scale, "ori_maps": ori_maps,
                         "feat_maps": feat_maps, "photos_n": photos_n}
        return out


class LFNetApply(nn.Module):
    """The frontend contract of the tracker step: one crop [side, side, 1]
    in, one FrontendOutput in crop coordinates out; or a stack of crops
    [S, side, side, 1] (the fleet's streams), one batched forward, and a
    FrontendOutput with a leading stream axis.  The forward runs under
    torch.inference_mode(); `.to(device)` moves the weights."""

    def __init__(self, net: LFNet):
        super().__init__()
        self.net = net.eval()

    def forward(self, crop):
        single = crop.dim() == 3
        photos = crop.permute(2, 0, 1)[None] if single else crop.permute(0, 3, 1, 2)
        with torch.inference_mode():
            out = self.net(photos)
        if single:
            out = FrontendOutput(*(t[0] for t in out))
        return out


def make_lfnet_apply(cfg: FrontendConfig, params) -> LFNetApply:
    """The single-image apply module for the state dict `params`."""
    net = LFNet(cfg)
    net.load_state_dict(params)
    return LFNetApply(net)


# ---- carrying the Flax parameters over --------------------------------------


def lfnet_state_dict_from_flax(flat_params) -> dict:
    """The port's state dict from the JAX package's flat parameters
    {"detector/init_conv/kernel": array, ...} (numpy arrays).

    Conv kernels HWIO -> OIHW; dense kernels [in, out] -> [out, in];
    descriptor/fc1's input rows go from Flax's (h, w, c) flatten order to
    torch's (c, h, w)."""
    convs = sorted((k for k in flat_params if k.startswith("descriptor/conv") and k.endswith("/kernel")),
                   key=lambda k: int(k.split("/")[1][len("conv"):]))

    def reorder_fc1(name, a):
        if name != "descriptor/fc1/kernel":
            return a
        c = flat_params[convs[-1]].shape[-1]  # channels of the last descriptor conv
        side = math.isqrt(a.shape[0] // c)
        return a.reshape(side, side, c, -1).transpose(2, 0, 1, 3).reshape(a.shape[0], -1)

    return state_dict_from_flax(flat_params, dense_kernel=reorder_fc1)


def load_params_npz(path: str, cfg: FrontendConfig):
    """(model, state dict) from an npz of the JAX package's LF-Net
    parameters.  `cfg` must describe the architecture the checkpoint was
    trained with; every name and shape is checked."""
    model = LFNet(cfg)
    flat = params_io.load_params_npz(path, flax_param_shapes(model))
    sd = lfnet_state_dict_from_flax(flat)
    model.load_state_dict(sd)
    return model, sd
