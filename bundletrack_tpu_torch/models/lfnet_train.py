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

Data parallelism (`data_group`): each rank holds a contiguous block of the
global batch and returns its share of the GLOBAL loss, which is what the
JAX package's sharded step computes (XLA sees the whole batch); the shares
sum to it, and so do the ranks' gradients.  The InfoNCE rows of a rank
score against every rank's image-2 descriptors, gathered with their
gradient; the near-duplicate mask and the invalid columns read every
rank's correspondences and validity, and both normalisers are summed over
the group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from bundletrack_tpu_torch.frontend.detector_ops import transformer_crop
from bundletrack_tpu_torch.frontend.lfnet import LFNet
from bundletrack_tpu_torch.models.optim import train_step
from bundletrack_tpu_torch.ops.collectives import all_gather_cat, all_reduce, gather_over_group, group_rank
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


def lfnet_loss(model: LFNet, batch: LFNetTrainBatch, temperature: float = 0.1, neg_mask_px: float = 8.0,
               data_group=None):
    """(loss, {"det_loss", "desc_loss"}), 0-dim tensors; see the module docstring.
    With `data_group`, `batch` is this rank's block and the loss its share
    of the global loss; the terms are the global ones.

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
    det_loss = torch.sum(wmask * (heat1 - heat2_in_1) ** 2) / (all_reduce(torch.sum(wmask), data_group) + 1e-6)

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
    d2 = gather_over_group(model.describe_patches(patches2), data_group)  # every rank's columns
    # tensor / tensor: a true division on every device, as XLA's
    sim = (d1 @ d2.T) / torch.tensor(temperature, dtype=torch.float32)
    first = group_rank(data_group) * B * K  # this block's first row of the global batch
    labels = torch.arange(B * K, device=sim.device) + first
    cols = torch.arange(d2.shape[0], device=sim.device)
    mask = kp_valid.reshape(-1)
    mask_all = all_gather_cat(mask, data_group)

    corr_flat = corr.reshape(B * K, 2)
    corr_all = all_gather_cat(corr_flat, data_group)
    same_row = (labels // K)[:, None] == (cols // K)[None, :]
    cd2 = torch.sum((corr_flat[:, None, :] - corr_all[None, :, :]) ** 2, dim=-1)
    near_dup = same_row & (cd2 < neg_mask_px ** 2)
    bad_col = ~mask_all[None, :]
    off_diag = labels[:, None] != cols[None, :]
    sim = sim.masked_fill(off_diag & (near_dup | bad_col), -1e9)

    ce = F.cross_entropy(sim, labels, reduction="none")
    maskf = mask.to(torch.float32)
    desc_loss = torch.sum(ce * maskf) / (all_reduce(torch.sum(maskf), data_group) + 1e-6)
    # the terms for the log: the global values (sums of the ranks' shares)
    return det_loss + desc_loss, {"det_loss": all_reduce(det_loss.detach(), data_group),
                                  "desc_loss": all_reduce(desc_loss.detach(), data_group)}


def make_lfnet_train_step(model: LFNet, optimizer, scheduler=None, data_group=None):
    """step(batch: LFNetTrainBatch) -> metrics {"det_loss", "desc_loss",
    "loss"}: lfnet_loss, its gradients and one update of `optimizer` (then
    `scheduler`, when given) on the model's parameters.  With `data_group`
    the batch is this rank's block, the gradients are summed over the group
    before the update, and the metrics are the global values."""
    return train_step(lambda batch: lfnet_loss(model, batch, data_group=data_group), optimizer, scheduler,
                      data_group)
