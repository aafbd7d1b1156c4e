"""Keyframe admission, eviction, and BA subset selection.

Counterpart of bundletrack_tpu/tracker/selection.py (reference
src/Bundler.cpp checkAndAddKeyframe:185-218, selectKeyFramesForBA:222-274).
All three are masked argmin/argmax loops over the fixed-capacity pool and
read nothing back to the host: a picked slot is used through a one-hot mask,
never as an index (indexing with a 0-dim tensor reads it to the host).  The
pool may carry a leading stream axis: each stream picks its own slots.
"""

from __future__ import annotations

import torch

from bundletrack_tpu_torch.geometry.se3 import rotation_geodesic_distance

_BIG = 1e9
_BIG_ID = 1 << 30


def keyframe_admission(
    kf_frame_id, kf_pose, new_pose, num_feat, status_ok, min_feat_num: int, min_rot_deg: float
) -> torch.Tensor:
    """Whether the new frame joins the keyframe pool: status OK, enough
    keypoints, and at least min_rot degrees from every keyframe."""
    used = kf_frame_id >= 0
    rot = torch.rad2deg(rotation_geodesic_distance(kf_pose[..., :3, :3], new_pose[..., None, :3, :3]))
    far_enough = torch.all(torch.where(used, rot >= min_rot_deg, True), dim=-1)
    return status_ok & (num_feat >= min_feat_num) & far_enough


def _pairwise_rotation(kf_pose):
    R = kf_pose[..., :3, :3]
    return rotation_geodesic_distance(R[..., :, None, :, :], R[..., None, :, :, :])


def eviction_slot(kf_frame_id, kf_pose) -> torch.Tensor:
    """Slot to overwrite: the first free slot, else the most redundant
    keyframe (smallest rotation to its nearest pool neighbour), never the
    oldest one."""
    Kp = kf_frame_id.shape[-1]
    dev = kf_frame_id.device
    used = kf_frame_id >= 0
    any_free = torch.any(~used, dim=-1)
    first_free = torch.argmax((~used).to(torch.int32), dim=-1)

    d = _pairwise_rotation(kf_pose)
    big = torch.full_like(d, _BIG)
    d = torch.where(torch.eye(Kp, dtype=torch.bool, device=dev), big, d)
    d = torch.where(used[..., :, None] & used[..., None, :], d, big)
    nearest = torch.amin(d, dim=-1)
    oldest = torch.argmin(torch.where(used, kf_frame_id, _BIG_ID), dim=-1, keepdim=True)
    big1 = torch.full_like(nearest, _BIG)
    nearest = torch.where(torch.arange(Kp, device=dev) == oldest, big1, nearest)
    nearest = torch.where(used, nearest, big1)
    most_redundant = torch.argmin(nearest, dim=-1)
    return torch.where(any_free, first_free, most_redundant)


def select_ba_subset(kf_frame_id, kf_pose, new_pose, max_pool_frames: int):
    """greedy_rot subset selection over the pool.

    Returns (slots [..., max_pool_frames] int64 pool indices sorted by frame
    id, valid [..., max_pool_frames] bool).  The caller appends the new frame.
    """
    Kp = kf_frame_id.shape[-1]
    dev = kf_frame_id.device
    used = kf_frame_id >= 0
    any_used = torch.any(used, dim=-1, keepdim=True)
    rot_pool = _pairwise_rotation(kf_pose)
    rot_new = rotation_geodesic_distance(kf_pose[..., :3, :3], new_pose[..., None, :3, :3])

    slot_ids = torch.arange(Kp, device=dev)

    def column(onehot):  # rot_pool[..., :, slot] for a one-hot slot mask
        return torch.sum(torch.where(onehot[..., None, :], rot_pool, 0.0), dim=-1)

    def argmin_hot(x):
        return slot_ids == torch.argmin(x, dim=-1, keepdim=True)

    oldest = argmin_hot(torch.where(used, kf_frame_id, _BIG_ID))
    selected = oldest & any_used
    # cumulative rotation to the selected set, seeded with the new frame's
    cum = rot_new + torch.where(any_used, column(oldest), torch.zeros_like(rot_new))
    for _ in range(max_pool_frames - 1):
        eligible = used & ~selected
        pick = argmin_hot(torch.where(eligible, cum, torch.full_like(cum, _BIG)))
        ok = torch.any(eligible & pick, dim=-1, keepdim=True)
        selected = selected | (pick & ok)
        cum = torch.where(ok, cum + column(pick), cum)

    # order selected slots by frame id (reference sorts _local_frames by id)
    sort_key = torch.where(selected, kf_frame_id, _BIG_ID)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    slots = order[..., :max_pool_frames]
    return slots, torch.gather(selected, -1, slots)
