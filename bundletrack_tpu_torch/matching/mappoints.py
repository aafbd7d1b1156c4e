"""Map-point (landmark) memory: long-range feature tracks across keyframes.

Counterpart of bundletrack_tpu/matching/mappoints.py (reference:
src/FeatureManager.cpp:448-485 updateFramePairMapPoints, 489-520
findCorresByMapPoints, 142-170 forgetFrame).  Two fixed-capacity tables:

  obs [L, K]: keypoint index of landmark l in keyframe slot k (-1 = none)
  rev [K, N]: landmark id owning keypoint n of slot k (-1 = none)

Updates are masked writes with the last of repeated indices winning
(ops/scatter.py); new landmarks take free rows by rank (a cumsum).  Slots
are 0-dim (or one-element) tensors, used through one-hot masks and
index_select, never as plain indices, which would read them to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.matching.pairwise import MatchResult
from bundletrack_tpu_torch.ops.scatter import set_last_wins
from bundletrack_tpu_torch.ops.topk import topk_stable


class MapPointTable(NamedTuple):
    obs: torch.Tensor  # [L, K] int32, -1 invalid
    rev: torch.Tensor  # [K, N] int32, -1 invalid


def init_mappoints(capacity: int, num_slots: int, num_kpts: int, device=None) -> MapPointTable:
    return MapPointTable(
        obs=torch.full((capacity, num_slots), -1, dtype=torch.int32, device=device),
        rev=torch.full((num_slots, num_kpts), -1, dtype=torch.int32, device=device),
    )


def _onehot(slot: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=slot.device) == slot.reshape(())


def _row(table: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, row.reshape(1))[0]


def _set_column(obs, col, index, values, keep):
    """obs[index[m], col] = values[m] for kept m."""
    new = set_last_wins(obs.index_select(1, col.reshape(1))[:, 0], index, values, keep)
    return torch.where(_onehot(col, obs.shape[1])[None, :], new[:, None], obs)


def _set_row(rev, row, index, values, keep):
    """rev[row, index[m]] = values[m] for kept m."""
    new = set_last_wins(_row(rev, row), index, values, keep)
    return torch.where(_onehot(row, rev.shape[0])[:, None], new[None, :], rev)


def update_mappoints(
    table: MapPointTable,
    slot_i: torch.Tensor,
    slot_j: torch.Tensor,
    matches: MatchResult,
) -> MapPointTable:
    """Absorb verified matches between keyframe slots i and j into the tracks:
    a match extends the landmark owning either endpoint, else it spawns a new
    landmark observing both (reference updateFramePairMapPoints)."""
    obs, rev = table.obs, table.rev
    L = obs.shape[0]
    ia, ib, mvalid = matches.idx_a, matches.idx_b, matches.valid
    ia32, ib32 = ia.to(torch.int32), ib.to(torch.int32)

    lm_a = _row(rev, slot_i)[ia]
    lm_b = _row(rev, slot_j)[ib]
    has_a = mvalid & (lm_a >= 0)
    has_b = mvalid & (lm_b >= 0) & ~has_a
    fresh = mvalid & (lm_a < 0) & (lm_b < 0)

    # extend existing landmarks: a owns one -> record j's observation
    obs = _set_column(obs, slot_j, lm_a.clamp(min=0), ib32, has_a)
    rev = _set_row(rev, slot_j, ib, lm_a, has_a)
    # b owns one -> record i's observation
    obs = _set_column(obs, slot_i, lm_b.clamp(min=0), ia32, has_b)
    rev = _set_row(rev, slot_i, ia, lm_b, has_b)

    # allocate new landmarks: the r-th fresh match takes the r-th free row
    free = ~torch.any(obs >= 0, dim=-1)  # [L]
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    fresh_rank = torch.cumsum(fresh.to(torch.int32), 0) - 1
    rows = torch.arange(L, dtype=torch.int32, device=obs.device)
    rank_to_row = torch.full((L + 1,), L, dtype=torch.int32, device=obs.device)
    rank_to_row = set_last_wins(rank_to_row, free_rank.clamp(min=0), rows, free)
    new_rows = rank_to_row[torch.clamp(fresh_rank, 0, L).long()]
    ok_new = fresh & (new_rows < L)
    tgt = new_rows.clamp(max=L - 1)
    obs = _set_column(obs, slot_i, tgt, ia32, ok_new)
    obs = _set_column(obs, slot_j, tgt, ib32, ok_new)
    rev = _set_row(rev, slot_i, ia, new_rows, ok_new)
    rev = _set_row(rev, slot_j, ib, new_rows, ok_new)
    return MapPointTable(obs=obs, rev=rev)


def propagate_matches(
    table: MapPointTable,
    slot_i: torch.Tensor,  # [] or [P]
    slot_j: torch.Tensor,
    max_matches: int,
) -> MatchResult:
    """Matches between slots i and j implied by shared landmarks: one gather
    and a stable top-k compaction over the track table.  Slots may carry a
    leading pair axis."""
    def columns(slot):  # [L] or [P, L]
        cols = table.obs.index_select(1, slot.reshape(-1)).transpose(0, 1)
        return cols if slot.dim() else cols[0]

    oi, oj = columns(slot_i), columns(slot_j)
    both = (oi >= 0) & (oj >= 0)
    topv, topl = topk_stable(both.to(torch.float32), max_matches)
    valid = topv > 0.5
    zero = torch.zeros_like(topl)
    return MatchResult(
        idx_a=torch.where(valid, torch.gather(oi, -1, topl).long(), zero),
        idx_b=torch.where(valid, torch.gather(oj, -1, topl).long(), zero),
        valid=valid,
    )


def forget_frame(table: MapPointTable, slot: torch.Tensor) -> MapPointTable:
    """Remove every observation of a keyframe slot (reference forgetFrame);
    landmarks left without observations free their rows."""
    hot = _onehot(slot, table.rev.shape[0])
    return MapPointTable(
        obs=torch.where(hot[None, :], -1, table.obs),
        rev=torch.where(hot[:, None], -1, table.rev),
    )
