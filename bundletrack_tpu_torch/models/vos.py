"""Transductive video-object segmentation (mask propagation) in PyTorch.

Counterpart of bundletrack_tpu/models/vos.py (reference:
transductive-vos.pytorch — modeling/network.py:8-50 VOSNet = ResNet
backbone + 1x1 projection to 256-d features at 1/8 resolution;
lib/predict.py:10-60 label propagation by softmax feature similarity with
Gaussian spatial priors sigma1=8 (dense recent refs) / sigma2=21 (sparse
older refs); frame sampling 63-78: ref_num=9 = 4 dense recent + sparse over
range 40; run_video.py:77-160 online loop writing the mask PNGs the tracker
consumes).  It runs the weights the repo ships in
checkpoints/vos_params.npz, the JAX package's Flax parameters;
`vos_state_dict_from_flax` carries them over.

Tensors are channels-first: features [C, h, w], labels [L, h, w].  The
history is a fixed-capacity ring of features and soft labels on the
device; its frame count is a host int, so a push never reads the device.

Where the numerics follow the JAX package on purpose:
- the layers are Flax's (utils/flax_layers.py): "SAME" pads, (2, 3) on the
  7x7 stride-2 stem, GroupNorm(8) with epsilon 1e-6 and E[x^2] - E[x]^2;
- the first mask's one-hot labels are downsampled with jax.image.resize's
  nearest rule, input index floor((i + 0.5) * in / out) in f32, where
  F.interpolate reads floor(i * in / out);
- the similarity rounds both operands to bf16 and accumulates and returns
  f32; its logits are divided by the temperature as a tensor (torch's
  division by a Python scalar on the card is a multiply by the reciprocal);
- the spatial priors are computed in numpy, as the JAX package does, and
  their denormal entries set to 0: XLA on the CPU reads denormal inputs as
  zero, torch does not;
- ties in the reference selection and in the final argmax go to the first
  index, in both frameworks.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bundletrack_tpu_torch.device import resolve_device
from bundletrack_tpu_torch.ops.numerics import clip, flush_denormals, round_bf16
from bundletrack_tpu_torch.ops.resize import resize_bilinear
from bundletrack_tpu_torch.utils import params_io
from bundletrack_tpu_torch.utils.flax_layers import (
    Conv,
    GroupNorm,
    flax_from_state_dict,
    flax_param_shapes,
    state_dict_from_flax,
)

# Submodules carry Flax's auto-generated names (Conv_0, GroupNorm_1, ...), so
# a checkpoint's flat names map onto the state dict one for one.
class ResNetBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, 3, stride)
        self.GroupNorm_0 = GroupNorm(channels, num_groups=8)
        self.Conv_1 = Conv(channels, channels, 3)
        self.GroupNorm_1 = GroupNorm(channels, num_groups=8)
        self.Conv_2 = Conv(cin, channels, 1, stride) if (cin != channels or stride != 1) else None

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(h + x)


class VOSNet(nn.Module):
    """Feature extractor at 1/8 resolution, `out_dim`-d, unit-norm
    (reference VOSNet).  rgb [B, 3, H, W] in [0, 1] -> [B, out_dim, H/8, W/8]."""

    def __init__(self, out_dim: int = 256, width: int = 32):
        super().__init__()
        self.out_dim, self.width = out_dim, width
        self.Conv_0 = Conv(3, width, 7, stride=2)  # /2
        self.GroupNorm_0 = GroupNorm(width, num_groups=8)
        self.ResNetBlock_0 = ResNetBlock(width, width)
        self.ResNetBlock_1 = ResNetBlock(width, width * 2, stride=2)  # /4
        self.ResNetBlock_2 = ResNetBlock(width * 2, width * 2)
        self.ResNetBlock_3 = ResNetBlock(width * 2, width * 4, stride=2)  # /8
        self.ResNetBlock_4 = ResNetBlock(width * 4, width * 4)
        self.Conv_1 = Conv(width * 4, out_dim, 1)  # projection (reference 1024 -> 256)

    def forward(self, rgb):
        x = F.relu(self.GroupNorm_0(self.Conv_0(rgb)))
        for i in range(5):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        x = self.Conv_1(x)
        # l2-normalise for cosine similarity; sqrt of the sum of squares, as jnp.linalg.norm
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        return x / clip(norm, 1e-6)


def spatial_weight(h: int, w: int, sigma: float) -> torch.Tensor:
    """[h*w, h*w] Gaussian distance prior (reference lib/predict.py:115-130),
    computed in numpy f32 as the JAX package does; a CPU tensor."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([ys.ravel(), xs.ravel()], axis=-1).astype(np.float32)
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    return torch.from_numpy(np.exp(-d2 / (sigma * sigma)))


def _mm_bf16_f32(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """bf16 a [n, k] @ bf16 b [k, m], accumulated and returned in f32.  On
    the card, cuBLAS's bf16 GEMM with an f32 output; on the CPU, the f32
    product of the operands, which is exact per term."""
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.to(torch.float32) @ b16.to(torch.float32)


class Bf16DotF32(torch.autograd.Function):
    """a [n, k] @ b [k, m] with both operands rounded to bf16, accumulated
    and returned in f32 (jax.lax.dot_general with bf16 operands and
    preferred_element_type=f32).

    `torch.mm(..., out_dtype=f32)` has no derivative, so the backward is
    written out as jax.grad computes it: the f32 product of the cotangent
    with the other rounded operand, rounded to bf16 (the dtype of the
    operand it is the gradient of), returned as f32."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _mm_bf16_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        ga = round_bf16(g @ b16.to(torch.float32).t()) if ctx.needs_input_grad[0] else None
        gb = round_bf16(a16.to(torch.float32).t() @ g) if ctx.needs_input_grad[1] else None
        return ga, gb


def similarity(feats_ref: torch.Tensor, feat_tgt: torch.Tensor) -> torch.Tensor:
    """[N_tgt, R * N_ref] f32 similarity of the target's features [C, h, w]
    to the references' [R, C, h, w], as one bf16 product with an f32 result."""
    R, C = feats_ref.shape[:2]
    fr = feats_ref.reshape(R, C, -1).permute(1, 0, 2).reshape(C, -1)
    return Bf16DotF32.apply(feat_tgt.reshape(C, -1).t(), fr)


def attention(sim, ref_valid, ref_is_recent, w_sigma1, w_sigma2, temperature) -> torch.Tensor:
    """[N, R * N] attention from the similarity (overwritten): the softmax
    of sim / temperature over every valid reference cell, times the spatial
    prior of each reference (sigma1 for the recent ones, sigma2 for the
    others), renormalised with a 1e-8 floor.  `temperature` is a float, or
    a 0-dim f32 tensor on the similarity's device."""
    R = ref_valid.shape[0]
    N = sim.shape[0]
    if not torch.is_tensor(temperature):
        temperature = torch.tensor(temperature, dtype=torch.float32, device=sim.device)
    sim = sim.div_(temperature).view(N, R, N)
    sim.masked_fill_(~ref_valid[None, :, None], float("-inf"))
    att = torch.softmax(sim.view(N, R * N), dim=-1).view(N, R, N)
    del sim
    # the prior multiplies the post-softmax weights, which are renormalised
    att.mul_(torch.where(ref_is_recent[None, :, None], w_sigma1[:, None, :], w_sigma2[:, None, :]))
    att.div_(torch.clamp(att.sum(dim=(1, 2), keepdim=True), min=1e-8))
    return att.view(N, R * N)


def attention_train(sim, ref_valid, ref_is_recent, w_sigma1, w_sigma2, temperature) -> torch.Tensor:
    """`attention` out of place, for autograd (which refuses the in-place
    version's writes into the softmax's output); the same values."""
    R = ref_valid.shape[0]
    N = sim.shape[0]
    if not torch.is_tensor(temperature):
        temperature = torch.tensor(temperature, dtype=torch.float32)
    sim = (sim / temperature).view(N, R, N).masked_fill(~ref_valid[None, :, None], float("-inf"))
    att = torch.softmax(sim.reshape(N, R * N), dim=-1).view(N, R, N)
    att = att * torch.where(ref_is_recent[None, :, None], w_sigma1[:, None, :], w_sigma2[:, None, :])
    att = att / clip(att.sum(dim=(1, 2), keepdim=True), 1e-8)
    return att.reshape(N, R * N)


def label_product(att: torch.Tensor, labels_ref: torch.Tensor) -> torch.Tensor:
    """Soft labels [L, h, w]: the attention [N, R * N] times the references'
    labels [R, L, h, w]."""
    R, L, h, w = labels_ref.shape
    lab = labels_ref.reshape(R, L, h * w).permute(0, 2, 1).reshape(-1, L)
    return (att @ lab).t().reshape(L, h, w)


def propagate_labels(
    feats_ref: torch.Tensor,  # [R, C, h, w]
    labels_ref: torch.Tensor,  # [R, L, h, w] one-hot or soft
    ref_valid: torch.Tensor,  # [R] bool
    ref_is_recent: torch.Tensor,  # [R] bool: True -> sigma1 prior, else sigma2
    feat_tgt: torch.Tensor,  # [C, h, w]
    w_sigma1: torch.Tensor,  # [h*w, h*w]
    w_sigma2: torch.Tensor,  # [h*w, h*w]
    temperature=1.0,
) -> torch.Tensor:
    """Soft target labels [L, h, w] by spatially weighted attention
    (reference lib/predict.py:10-60).  Where the similarity carries a
    gradient (training), the attention is computed out of place."""
    sim = similarity(feats_ref, feat_tgt)
    att = (attention_train if sim.requires_grad else attention)(
        sim, ref_valid, ref_is_recent, w_sigma1, w_sigma2, temperature)
    return label_product(att, labels_ref)


class VOSState(NamedTuple):
    """Ring-buffer history of features and soft labels on the device; `count`
    (frames pushed so far) is a host int."""

    feats: torch.Tensor  # [cap, C, h, w]
    labels: torch.Tensor  # [cap, L, h, w]
    frame_ids: torch.Tensor  # [cap] int64, -1 empty
    count: int


def init_vos_state(cap: int, h: int, w: int, C: int, L: int, device=None) -> VOSState:
    device = resolve_device(device)
    return VOSState(
        feats=torch.zeros((cap, C, h, w), dtype=torch.float32, device=device),
        labels=torch.zeros((cap, L, h, w), dtype=torch.float32, device=device),
        frame_ids=torch.full((cap,), -1, dtype=torch.int64, device=device),
        count=0,
    )


def vos_push(state: VOSState, feat: torch.Tensor, label: torch.Tensor, frame_id: int) -> VOSState:
    """Write (feat, label, frame_id) into the next slot of the ring, in place;
    returns the state with the count advanced."""
    slot = state.count % state.feats.shape[0]
    state.feats[slot].copy_(feat)
    state.labels[slot].copy_(label)
    state.frame_ids[slot].fill_(int(frame_id))
    return state._replace(count=state.count + 1)


def _wanted_ages_host(ref_num: int, dense_num: int, range_: int) -> np.ndarray:
    """Ages 1..dense_num, then jnp.linspace(dense_num + 1, range_,
    ref_num - dense_num) in f32 (start * (1 - step) + stop * step), truncated."""
    n_sparse = ref_num - dense_num
    start, stop = np.float32(dense_num + 1), np.float32(range_)
    if n_sparse > 1:
        div = n_sparse - 1
        step = np.arange(div, dtype=np.float32) / np.float32(div)
        sparse = np.concatenate([start * (np.float32(1) - step) + stop * step, [stop]])
    else:
        sparse = np.full((max(n_sparse, 0),), start, np.float32)
    return np.concatenate([np.arange(1, dense_num + 1), sparse.astype(np.int32)]).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _wanted_ages(ref_num: int, dense_num: int, range_: int, device: torch.device) -> torch.Tensor:
    # built once per device: an upload per frame would synchronise the card
    return torch.from_numpy(_wanted_ages_host(ref_num, dense_num, range_)).to(device)


def select_references(state: VOSState, ref_num: int, dense_num: int, range_: int):
    """Dense recent + sparse older refs (reference lib/predict.py:63-78):
    for each wanted age the slot holding the closest one (the first on a
    tie).  Returns (slots [ref_num] int64, valid [ref_num] bool,
    is_recent [ref_num] bool), on the ring's device."""
    ids = state.frame_ids
    used = ids >= 0
    age = state.count - ids  # 1 = previous frame; the next frame id is count
    want = _wanted_ages(ref_num, dense_num, range_, ids.device)
    diff = torch.abs(age[None, :] - want[:, None])  # [ref_num, cap]
    diff = torch.where(used[None, :], diff, torch.full_like(diff, 1 << 20))
    slots = torch.argmin(diff, dim=-1)
    return slots, used[slots], want <= dense_num


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize's "nearest" source index: floor((i + 0.5) * n_in / n_out) in f32."""
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
                    / np.float32(n_out)).astype(np.int64)


class VOSPropagator:
    """Online mask propagator (reference run_video.py flow): `first_frame`
    seeds the history with an image and its mask, then each `propagate`
    returns the next frame's mask.  Runs on the card unless `device` says
    otherwise; the model's weights move there."""

    def __init__(self, model: VOSNet, cfg, H: int, W: int, num_labels: int = 2,
                 history_cap: int | None = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.H, self.W = H, W
        self.h, self.w = H // cfg.downscale, W // cfg.downscale
        self.num_labels = num_labels
        self.w1 = flush_denormals(spatial_weight(self.h, self.w, cfg.sigma1)).to(self.device)
        self.w2 = flush_denormals(spatial_weight(self.h, self.w, cfg.sigma2)).to(self.device)
        self.temperature = torch.tensor(cfg.temperature, dtype=torch.float32, device=self.device)
        self._rows = torch.from_numpy(_nearest_index(H, self.h)).to(self.device)
        self._cols = torch.from_numpy(_nearest_index(W, self.w)).to(self.device)
        cap = history_cap if history_cap is not None else cfg.history_cap
        self.state = init_vos_state(cap, self.h, self.w, model.out_dim, num_labels, self.device)
        self._anchor_feat = self._anchor_label = None

    @torch.no_grad()
    def extract_feat(self, rgb: np.ndarray) -> torch.Tensor:
        """[C, h, w] features of an [H, W, 3] image in [0, 1]."""
        x = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.float32)).to(self.device, non_blocking=True)
        feat = self.model(x.permute(2, 0, 1)[None])[0]
        return resize_bilinear(feat, (self.h, self.w))  # the identity when H, W are multiples of 8

    @torch.no_grad()
    def first_frame(self, rgb, mask) -> None:
        feat = self.extract_feat(rgb)
        m = torch.as_tensor(np.asarray(mask)).to(self.device, non_blocking=True).to(torch.int64)
        onehot = F.one_hot(m, self.num_labels).permute(2, 0, 1).to(torch.float32)  # [L, H, W]
        lab = onehot.index_select(1, self._rows).index_select(2, self._cols)
        self.state = vos_push(self.state, feat, lab, 0)
        self._anchor_feat, self._anchor_label = feat, lab

    @torch.no_grad()
    def propagate_soft(self, feat: torch.Tensor) -> torch.Tensor:
        """[L, h, w] soft labels of a frame's features from the history."""
        cfg = self.cfg
        slots, valid, is_recent = select_references(self.state, cfg.ref_num, dense_num=4, range_=cfg.range_)
        ref_feats = self.state.feats.index_select(0, slots)
        ref_labels = self.state.labels.index_select(0, slots)
        if cfg.anchor_first:
            # pin the first frame (the given mask) as the last, sparse
            # reference: an extension over the reference, whose range_=40
            # window loses the only ground-truth anchor after 40 frames; the
            # pinned slot always takes the loose sigma2 prior
            ref_feats[-1].copy_(self._anchor_feat)
            ref_labels[-1].copy_(self._anchor_label)
            valid[-1].fill_(True)
            is_recent = is_recent.clone()
            is_recent[-1].fill_(False)
        return propagate_labels(ref_feats, ref_labels, valid, is_recent, feat,
                                self.w1, self.w2, self.temperature)

    @torch.no_grad()
    def step(self, rgb):
        """One frame on the device: (mask [H, W] bool, soft labels [L, h, w])."""
        feat = self.extract_feat(rgb)
        soft = self.propagate_soft(feat)
        self.state = vos_push(self.state, feat, soft, self.state.count)
        up = resize_bilinear(soft, (self.H, self.W))
        return torch.argmax(up, dim=0) > 0, soft

    def propagate(self, rgb) -> np.ndarray:
        """The next frame's mask [H, W] bool, on the host."""
        return self.step(rgb)[0].cpu().numpy()


# ---- weights ----------------------------------------------------------------


def vos_state_dict_from_flax(flat_params) -> dict:
    """The port's state dict from the JAX package's flat VOSNet parameters
    {"ResNetBlock_1/Conv_0/kernel": array, ...} (numpy arrays): conv
    kernels HWIO -> OIHW, the rest as they are, as f32."""
    return state_dict_from_flax(flat_params)


def save_vos_npz(path: str, sd) -> None:
    """Write a VOSNet state dict as the JAX package's npz
    (`checkpoints/vos_params.npz`'s layout: the inverse of
    `vos_state_dict_from_flax`, OIHW -> HWIO), which both packages load."""
    params_io.save_params_npz(path, flax_from_state_dict(sd))


def load_vos_npz(path: str):
    """(model, state dict) from an npz of VOSNet parameters; the architecture
    comes from the file: width is the stem conv's output channels, out_dim
    the projection's.  Every name and shape is checked."""
    with np.load(path) as data:
        for k in ("Conv_0/kernel", "Conv_1/kernel"):
            if k not in data:
                raise KeyError(f"checkpoint {path} missing param {k}")
        width = int(data["Conv_0/kernel"].shape[-1])
        out_dim = int(data["Conv_1/kernel"].shape[-1])
    model = VOSNet(out_dim=out_dim, width=width)
    sd = state_dict_from_flax(params_io.load_params_npz(path, flax_param_shapes(model)))
    model.load_state_dict(sd)
    return model, sd


def init_vos(out_dim: int = 256, width: int = 32, seed: int = 0):
    """(model, state dict) with seeded random weights: conv kernels
    lecun-normal, biases 0, norms identity, as the Flax initialisers give."""
    model = VOSNet(out_dim=out_dim, width=width)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(math.prod(p.shape[1:])))
    return model, model.state_dict()
