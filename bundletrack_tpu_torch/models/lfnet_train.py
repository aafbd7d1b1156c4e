"""Self-supervised LF-Net training step (pairs with known warps), in PyTorch.

Counterpart of bundletrack_tpu/models/lfnet_train.py (reference:
lf-net-release/train_lfnet.py).  The same two objectives:

  * detector repeatability: image 2's score heatmap, sampled through the
    ground-truth correspondence field, should match image 1's heatmap;
  * descriptor InfoNCE over the in-batch keypoint set: descriptors of
    corresponding keypoints should match, the others should not.

The batch is data in the JAX package's channels-last layout; the loss
converts it for the port's channels-first network.  Gradients stop where
the JAX loss has `stop_gradient` (image 1's keypoints, image 2's scale and
orientation at the correspondents) and nowhere else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from bundletrack_tpu_torch.frontend.detector_ops import transformer_crop
from bundletrack_tpu_torch.frontend.lfnet import LFNet
from bundletrack_tpu_torch.models.optim import train_step
from bundletrack_tpu_torch.ops.numerics import clip


class LFNetTrainBatch(NamedTuple):
    """A batch of image pairs with ground-truth correspondence.

    img1, img2:   [B, H, W, 1]
    warp12:       [B, H, W, 2] for each pixel of img1, its (x, y) in img2
    warp_valid:   [B, H, W] bool
    """

    img1: torch.Tensor
    img2: torch.Tensor
    warp12: torch.Tensor
    warp_valid: torch.Tensor


def _gather_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W], xy [B, N, 2] (x, y) -> [B, N, C], bilinear, the
    coordinates clipped to [0, W - 1.001] x [0, H - 1.001]."""
    B, C, H, W = img.shape
    x = clip(xy[..., 0], 0.0, W - 1.001)
    y = clip(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    flat = img.reshape(B, C, H * W).transpose(1, 2)  # [B, HW, C]

    def tap(yy, xx):
        idx = (yy * W + xx)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (
        p00 * (1 - dx) * (1 - dy)
        + p01 * dx * (1 - dy)
        + p10 * (1 - dx) * dy
        + p11 * dx * dy
    )


def lfnet_loss(model: LFNet, batch: LFNetTrainBatch, temperature: float = 0.1, neg_mask_px: float = 8.0):
    """(loss, {"det_loss", "desc_loss"}), 0-dim tensors; see the module docstring.

    InfoNCE negative hygiene, as in the JAX loss: batch rows come from
    distinct worlds (the trainer sees to it); same-row negatives whose
    image-2 location lies within `neg_mask_px` of the anchor's correspondent
    and columns of invalid correspondences are set to -1e9, the diagonal
    kept."""
    cfg = model.cfg
    B, H, W, _ = batch.img1.shape
    out1, ep1 = model(batch.img1.permute(0, 3, 1, 2), return_endpoints=True)
    out2, ep2 = model(batch.img2.permute(0, 3, 1, 2), return_endpoints=True)
    warp12 = batch.warp12.permute(0, 3, 1, 2)  # [B, 2, H, W]
    wvalid = batch.warp_valid.to(torch.float32)  # [B, H, W]

    # --- detector repeatability ---------------------------------------
    heat2_in_1 = _gather_bilinear(ep2["max_heat"], batch.warp12.reshape(B, -1, 2)).reshape(B, H, W, 1)
    wmask = wvalid[..., None]
    heat1 = ep1["max_heat"].permute(0, 2, 3, 1)
    det_loss = torch.sum(wmask * (heat1 - heat2_in_1) ** 2) / (torch.sum(wmask) + 1e-6)

    # --- descriptor InfoNCE over corresponding keypoints ----------------
    kp1 = out1.kpts_uv.detach()  # [B, K, 2]
    corr = _gather_bilinear(warp12, kp1)  # [B, K, 2] locations in image 2
    kp_valid = out1.valid & (_gather_bilinear(wvalid[:, None], kp1)[..., 0] > 0.5)
    K = kp1.shape[1]
    batch_inds = torch.arange(B, device=kp1.device).repeat_interleave(K)
    # the correspondents' patches take image 2's own predicted scale and
    # orientation there, the transform chain of the inference forward
    scale2 = _gather_bilinear(ep2["max_scale"][:, None], corr)[..., 0]
    ori2 = _gather_bilinear(ep2["ori_maps"], corr)
    ori2 = ori2 / clip(torch.linalg.vector_norm(ori2, dim=-1, keepdim=True), 1e-6)
    patches2 = transformer_crop(
        ep2["photos_n"], cfg.patch_size, batch_inds, corr.reshape(-1, 2),
        kpts_scale=scale2.reshape(-1).detach(), kpts_ori=ori2.reshape(-1, 2).detach(),
    )
    d1 = out1.desc.reshape(B * K, -1)
    d2 = model.describe_patches(patches2)
    # tensor / tensor: a true division on every device, as XLA's
    sim = (d1 @ d2.T) / torch.tensor(temperature, dtype=torch.float32)
    labels = torch.arange(B * K, device=sim.device)
    mask = kp_valid.reshape(-1)

    corr_flat = corr.reshape(B * K, 2)
    same_row = batch_inds[:, None] == batch_inds[None, :]
    cd2 = torch.sum((corr_flat[:, None, :] - corr_flat[None, :, :]) ** 2, dim=-1)
    near_dup = same_row & (cd2 < neg_mask_px ** 2)
    bad_col = ~mask[None, :]
    off_diag = labels[:, None] != labels[None, :]
    sim = sim.masked_fill(off_diag & (near_dup | bad_col), -1e9)

    ce = F.cross_entropy(sim, labels, reduction="none")
    maskf = mask.to(torch.float32)
    desc_loss = torch.sum(ce * maskf) / (torch.sum(maskf) + 1e-6)
    return det_loss + desc_loss, {"det_loss": det_loss, "desc_loss": desc_loss}


def make_lfnet_train_step(model: LFNet, optimizer, scheduler=None):
    """step(batch: LFNetTrainBatch) -> metrics {"det_loss", "desc_loss",
    "loss"}: lfnet_loss, its gradients and one update of `optimizer` (then
    `scheduler`, when given) on the model's parameters."""
    return train_step(lambda batch: lfnet_loss(model, batch), optimizer, scheduler)
