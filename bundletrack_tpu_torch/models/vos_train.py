"""VOS training step: cross-entropy over transductively propagated labels, in PyTorch.

Counterpart of bundletrack_tpu/models/vos_train.py (reference:
transductive-vos.pytorch/main.py:57-135, lib/loss.py:31-57): the features
of earlier frames and their labels predict the current frame's label by the
attention used at inference, and a class-balanced cross-entropy is taken
against the ground truth.  The JAX step vmaps over the batch and scans over
the rollout; here both are Python loops over the same maths, the rollout's
label buffer rebuilt out of place so that gradients run through it all.

Data parallelism (`data_group`, the reference's DDP): each rank holds a
block of the clips and returns its share of the GLOBAL loss, as the JAX
package's sharded step computes it: the class counts that balance the
cross-entropy are summed over the group, and so are the sums behind the
logged ce, acc and IoU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from bundletrack_tpu_torch.models.optim import train_step
from bundletrack_tpu_torch.models.vos import VOSNet, _nearest_index, propagate_labels, spatial_weight
from bundletrack_tpu_torch.ops.collectives import all_reduce, group_size
from bundletrack_tpu_torch.ops.numerics import clip, flush_denormals


class VOSTrainBatch(NamedTuple):
    """A batch of short clips with per-frame ground-truth labels.

    clips:  [B, T, H, W, 3] in [0, 1]: frames 0..T-2 are references, frame
            T-1 the prediction target.
    labels: [B, T, H, W] integer class ids (0 = background).
    """

    clips: torch.Tensor
    labels: torch.Tensor


@functools.lru_cache(maxsize=16)
def _nearest_rows(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # built once per device: an upload per step would synchronise the card
    return torch.from_numpy(_nearest_index(n_in, n_out)).to(device)


def _downsample_labels(labels: torch.Tensor, h: int, w: int, num_labels: int) -> torch.Tensor:
    """[..., H, W] int -> [..., h, w, L] one-hot at feature resolution, by
    jax.image.resize's nearest rule (models/vos._nearest_index).  Picking
    the labels before the one-hot picks the same one-hot rows."""
    H, W = labels.shape[-2:]
    lab = labels.index_select(-2, _nearest_rows(H, h, labels.device))
    lab = lab.index_select(-1, _nearest_rows(W, w, labels.device))
    return F.one_hot(lab.to(torch.int64), num_labels).to(torch.float32)


def _features(model: VOSNet, clips: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, T, C, h, w]."""
    B, T, H, W, _ = clips.shape
    feats = model(clips.reshape(B * T, H, W, 3).permute(0, 3, 1, 2))
    return feats.reshape(B, T, *feats.shape[1:])


def _balanced_ce(pred: torch.Tensor, tgt: torch.Tensor, group=None):
    """(class-balanced CE sum, per-cell CE) of soft predictions [..., L]
    against one-hot targets: object cells weigh as much in total as
    background cells (the object covers ~10 % of cells).  With `group`,
    the class counts are the group's: the sum is this rank's share."""
    ce = -torch.sum(tgt * torch.log(clip(pred, 1e-8, 1.0)), dim=-1)
    is_obj = tgt[..., 1:].sum(-1)
    n_obj = clip(all_reduce(torch.sum(is_obj), group), 1.0)
    n_bg = clip(all_reduce(torch.sum(1.0 - is_obj), group), 1.0)
    half = torch.tensor(0.5)  # tensor / tensor: a true division, as XLA's
    wt = is_obj * (half / n_obj) + (1.0 - is_obj) * (half / n_bg)
    return torch.sum(ce * wt), ce


def _iou(pred_obj: torch.Tensor, tgt_obj: torch.Tensor, group=None) -> torch.Tensor:
    inter, union = all_reduce(torch.stack([torch.sum(pred_obj & tgt_obj), torch.sum(pred_obj | tgt_obj)]), group)
    return inter / torch.clamp(union, min=1)


def _mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the group's cells (equal blocks on every rank)."""
    if group is None:
        return torch.mean(x)
    return all_reduce(torch.sum(x), group) / (x.numel() * group_size(group))


def vos_loss(model: VOSNet, batch: VOSTrainBatch, w_sigma1, w_sigma2, num_labels: int = 2,
             temperature: float = 0.05, dense_num: int = 4, data_group=None):
    """(loss, {"ce", "bal_ce", "acc", "iou"}): frame T-1 of each clip
    predicted from the ground-truth labels of frames 0..T-2; the most
    recent `dense_num` references take the sigma1 prior, older ones sigma2.
    With `data_group`, the loss is this rank's share, the metrics global."""
    B, T = batch.clips.shape[:2]
    feats = _features(model, batch.clips)
    h, w = feats.shape[-2:]
    labels_lo = _downsample_labels(batch.labels, h, w, num_labels)  # [B, T, h, w, L]
    R = T - 1
    dev = feats.device
    ref_valid = torch.ones((R,), dtype=torch.bool, device=dev)
    age = R - torch.arange(R, device=dev)  # ref t is R - t frames older than the target
    ref_is_recent = age <= dense_num
    pred = torch.stack([
        propagate_labels(feats[b, :R], labels_lo[b, :R].permute(0, 3, 1, 2), ref_valid, ref_is_recent,
                         feats[b, R], w_sigma1, w_sigma2, temperature)
        for b in range(B)
    ]).permute(0, 2, 3, 1)  # [B, h, w, L]
    tgt = labels_lo[:, R]
    loss, ce = _balanced_ce(pred, tgt, data_group)
    acc = _mean((torch.argmax(pred, -1) == torch.argmax(tgt, -1)).to(torch.float32), data_group)
    # object-cell IoU of the hard prediction: the metric that moves
    iou = _iou(torch.argmax(pred, -1) > 0, torch.argmax(tgt, -1) > 0, data_group)
    return loss, {"ce": _mean(ce.detach(), data_group), "bal_ce": all_reduce(loss.detach(), data_group),
                  "acc": acc, "iou": iou}


def vos_rollout_loss(model: VOSNet, batch: VOSTrainBatch, w_sigma1, w_sigma2, num_labels: int = 2,
                     temperature: float = 0.05, dense_num: int = 4, data_group=None):
    """(loss, {"ce", "bal_ce", "iou", "iou_last"}): the inference recurrence.
    Frame 0 keeps its ground-truth label; frames 1..T-1 are predicted in
    sequence, each prediction becoming a (soft, possibly wrong) reference
    of the next, with a class-balanced CE at every step.  `iou_last` is
    the IoU of the last step, the drift-sensitive number.  `data_group` as
    in vos_loss."""
    B, T = batch.clips.shape[:2]
    feats = _features(model, batch.clips)
    h, w = feats.shape[-2:]
    labels_gt = _downsample_labels(batch.labels, h, w, num_labels)  # [B, T, h, w, L]
    R = T - 1
    dev = feats.device
    # row t - 1: each buffered frame's age when frame t is the target
    ages = torch.arange(1, T, device=dev)[:, None] - torch.arange(T, device=dev)[None, :]
    is_ref = ages >= 1
    is_recent = is_ref & (ages <= dense_num)
    zero = torch.zeros((num_labels, h, w), device=dev)
    preds = []
    for b in range(B):
        # slot t holds the label frame t carries as a reference
        buf = [labels_gt[b, 0].permute(2, 0, 1)] + [zero] * (T - 1)
        seq = []
        for t in range(1, T):
            # frame T-1 is never a reference of an earlier frame: R slots
            pred = propagate_labels(feats[b, :R], torch.stack(buf[:R]), is_ref[t - 1, :R], is_recent[t - 1, :R],
                                    feats[b, t], w_sigma1, w_sigma2, temperature)
            buf[t] = pred
            seq.append(pred)
        preds.append(torch.stack(seq))
    preds = torch.stack(preds).permute(0, 1, 3, 4, 2)  # [B, T-1, h, w, L]
    tgt = labels_gt[:, 1:]
    loss, ce = _balanced_ce(preds, tgt, data_group)
    pred_obj = torch.argmax(preds, -1) > 0
    tgt_obj = torch.argmax(tgt, -1) > 0
    return loss, {"ce": _mean(ce.detach(), data_group), "bal_ce": all_reduce(loss.detach(), data_group),
                  "iou": _iou(pred_obj, tgt_obj, data_group),
                  "iou_last": _iou(pred_obj[:, -1], tgt_obj[:, -1], data_group)}


def make_vos_train_step(model: VOSNet, optimizer, image_hw, downscale: int = 8, sigma1: float = 8.0,
                        sigma2: float = 21.0, num_labels: int = 2, rollout: bool = False, data_group=None):
    """step(batch: VOSTrainBatch) -> metrics (the loss's, and "loss"): one
    update of `optimizer` on vos_loss, or vos_rollout_loss with `rollout`.
    The spatial priors are built once, on the model's device, their
    denormals flushed as XLA reads them.  With `data_group` the batch is
    this rank's block and the gradients are summed over the group."""
    H, W = image_hw
    h, w = H // downscale, W // downscale
    dev = next(model.parameters()).device
    w1 = flush_denormals(spatial_weight(h, w, sigma1)).to(dev)
    w2 = flush_denormals(spatial_weight(h, w, sigma2)).to(dev)
    loss_fn = vos_rollout_loss if rollout else vos_loss
    return train_step(lambda batch: loss_fn(model, batch, w1, w2, num_labels, data_group=data_group), optimizer,
                      data_group=data_group)
