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

Tensor parallelism (the JAX package's "model" mesh axis, parallel/fleet.py)
splits the descriptor MLP over a process group: fc1 is column-parallel
(each rank holds 512 / n of its outputs, with their bias and fc1_norm's
scale and bias), fc2 row-parallel (the matching 512 / n inputs; partial
products summed, the bias added once).  fc1_norm is GroupNorm(1) over all
512 features, so its mean and mean square are summed over the group; a
per-shard norm would compute another function.  In bf16 each rank sums
its features' windows of 32 (with n <= 16 a rank holds whole windows), the
group gathers the window partials and adds them in window order, so the
statistics equal the unsharded ones bit for bit.  `shard_lfnet_state_dict`
and `gather_lfnet_state_dict` cut a full state dict to one rank's shard
and make it whole again.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.frontend.detector_ops import (
    end_of_frame_mask,
    instance_norm,
    non_max_suppression_mask,
    soft_argmax_2d,
    soft_max_and_argmax_1d,
    soft_nms_3d,
    top_k_keypoints,
    transformer_crop,
)
from bundletrack_tpu_torch.frontend.interface import FrontendOutput
from bundletrack_tpu_torch.ops.collectives import (
    all_gather_cat,
    copy_to_group,
    group_size,
    reduce_from_group,
    sum_over_group,
)
from bundletrack_tpu_torch.kernels.norm_sums import WINDOW, xla_order_sums
from bundletrack_tpu_torch.ops.numerics import clip, round_bf16, xla_mean_var, xla_normalize
from bundletrack_tpu_torch.ops.resize import resize_bilinear
from bundletrack_tpu_torch.utils import params_io
from bundletrack_tpu_torch.utils.flax_layers import (
    Conv,
    Dense,
    GroupNorm,
    XlaGroupNorm,
    channel_shape,
    flax_from_state_dict,
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
        self.model_group = None  # tensor parallelism over this group: `shard_lfnet_`

    def forward(self, patches):  # [N, 1, P, P]
        x = patches
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i + 1}")(x)
            x = F.relu(getattr(self, f"norm{i + 1}")(x))
        x = x.reshape(x.shape[0], -1)  # (c, h, w) order: fc1's rows were reordered to it
        if self.model_group is None:
            x = F.relu(self.fc1_norm(self.fc1(x)))
            x = self.fc2(x)  # f32 (in bf16 unrounded after the bias add)
        else:
            x = self._mlp_tensor_parallel(x, self.model_group)
        return x / clip(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)

    def _mlp_tensor_parallel(self, x, group):
        """fc1 -> fc1_norm -> relu -> fc2 with this rank's shards (module docstring)."""
        h = self.fc1(copy_to_group(x, group))  # [N, 512 / n] f32
        norm = self.fc1_norm
        n = h.shape[-1] * group_size(group)
        if isinstance(norm, XlaGroupNorm):  # window partials of every rank, added in window order
            if h.shape[-1] % WINDOW:
                raise ValueError(f"tensor-parallel bf16 fc1_norm: {h.shape[-1]} features per rank are not "
                                 f"whole windows of {WINDOW}")
            N = h.shape[0]
            part = xla_order_sums(h.reshape(-1, WINDOW), round_bf16=True)
            part = all_gather_cat(torch.stack(part).view(2, N, -1), group, dim=2)  # [2, N, windows]
            s, s2 = xla_order_sums(part[0]), xla_order_sums(part[1])
            mu, var = xla_mean_var(s[0], s2[0], n)
            mul = torch.rsqrt(var + norm.eps)[:, None] * norm.scale
            h = xla_normalize(h, mu[:, None], mul, norm.bias)
        elif isinstance(norm, GroupNorm):  # GroupNorm(1): statistics over all 512 features
            stats = sum_over_group(torch.stack([h.sum(-1), (h * h).sum(-1)]), group)
            mu, mu2 = (stats / torch.tensor(float(n)))[:, :, None]
            var = clip(mu2 - mu * mu, 0.0)
            h = (h - mu) * (torch.rsqrt(var + norm.eps) * norm.scale) + norm.bias
        else:  # per-feature: the shard's own rows
            h = norm(h)
        fc2 = self.fc2
        h = F.relu(h).to(fc2.dtype)
        if fc2.dtype == torch.float32:
            return reduce_from_group(F.linear(h, fc2.weight), group) + fc2.bias
        # the partial products exact in f32, summed over the group, then
        # rounded once as the unsharded bf16 product is
        y = reduce_from_group(F.linear(h.to(torch.float32), round_bf16(fc2.weight)), group)
        return round_bf16(y) + round_bf16(fc2.bias)


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

        scale_logits = torch.cat([resize_bilinear(instance_norm(sm, xla_order=c.bf16), (H, W))
                                  for sm in score_maps], dim=1)
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


# the tensor-parallel split: parameter -> the dimension cut over the "model" group
TP_SHARD_DIMS = {"descriptor.fc1.weight": 0, "descriptor.fc1.bias": 0, "descriptor.fc2.weight": 1}
TP_NORM_PREFIX = "descriptor.fc1_norm."  # every fc1_norm parameter: dimension 0


def tp_shard_dim(name: str):
    """The dimension a parameter is cut along under tensor parallelism, or
    None for a replicated one."""
    return 0 if name.startswith(TP_NORM_PREFIX) else TP_SHARD_DIMS.get(name)


def shard_lfnet_state_dict(sd, rank: int, size: int) -> dict:
    """The shard of a full LF-Net state dict that model rank `rank` of
    `size` holds: fc1's outputs (weight rows, bias, fc1_norm) and fc2's
    inputs cut into `size` contiguous blocks; the rest as it is."""
    out = {}
    for name, t in sd.items():
        d = tp_shard_dim(name)
        if d is not None:
            if t.shape[d] % size:
                raise ValueError(f"{name}: {t.shape[d]} features do not split over {size} model ranks")
            t = t.chunk(size, dim=d)[rank].clone()
        out[name] = t
    return out


def gather_lfnet_state_dict(sd, group) -> dict:
    """The inverse of `shard_lfnet_state_dict` over the model group: every
    rank of the group gets the full state dict (a collective)."""
    return {name: t if tp_shard_dim(name) is None else all_gather_cat(t, group, dim=tp_shard_dim(name))
            for name, t in sd.items()}


def shard_lfnet_(model: "LFNet", group) -> None:
    """Cut the model's parameters, in place, to this rank's shard over the
    model group and switch the descriptor to the tensor-parallel forward.
    The Parameter objects stay, so an optimiser built on them keeps them."""
    rank = torch.distributed.get_rank(group)
    size = group_size(group)
    shards = shard_lfnet_state_dict(
        {n: p.data for n, p in model.named_parameters() if tp_shard_dim(n) is not None}, rank, size)
    for name, p in model.named_parameters():
        if name in shards:
            p.data = shards[name]
    model.descriptor.model_group = group


def make_lfnet_apply(cfg: FrontendConfig, params) -> LFNetApply:
    """The single-image apply module for the state dict `params`."""
    net = LFNet(cfg)
    net.load_state_dict(params)
    return LFNetApply(net)


def init_lfnet(cfg: FrontendConfig, seed: int = 0):
    """(model, state dict) with seeded random weights: conv and dense
    kernels lecun-normal, biases 0, norms identity, the orientation head
    (cos, sin) = (1, 0), as the Flax initialisers give."""
    model = LFNet(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
        model.detector.ori_conv.weight.zero_()
        model.detector.ori_conv.bias.copy_(torch.tensor([1.0, 0.0]))
    return model, model.state_dict()


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


def lfnet_flax_from_state_dict(sd) -> dict:
    """The inverse of `lfnet_state_dict_from_flax`: the JAX package's flat
    parameters from the port's state dict (OIHW -> HWIO, [out, in] ->
    [in, out], fc1's input rows back to Flax's (h, w, c) order)."""
    convs = sorted((k for k in sd if k.startswith("descriptor.conv") and k.endswith(".weight")),
                   key=lambda k: int(k.split(".")[1][len("conv"):]))
    c = sd[convs[-1]].shape[0]  # channels of the last descriptor conv

    def reorder_fc1(name, a):
        if name != "descriptor/fc1/kernel":
            return a
        side = math.isqrt(a.shape[0] // c)
        return a.reshape(c, side, side, -1).transpose(1, 2, 0, 3).reshape(a.shape[0], -1)

    return flax_from_state_dict(sd, dense_kernel=reorder_fc1)


def save_params_npz(path: str, sd) -> None:
    """Write an LF-Net state dict as the JAX package's npz
    (`checkpoints/lfnet_params.npz`'s layout), which both packages load."""
    params_io.save_params_npz(path, lfnet_flax_from_state_dict(sd))


def load_params_npz(path: str, cfg: FrontendConfig):
    """(model, state dict) from an npz of the JAX package's LF-Net
    parameters.  `cfg` must describe the architecture the checkpoint was
    trained with; every name and shape is checked."""
    model = LFNet(cfg)
    flat = params_io.load_params_npz(path, flax_param_shapes(model))
    sd = lfnet_state_dict_from_flax(flat)
    model.load_state_dict(sd)
    return model, sd
