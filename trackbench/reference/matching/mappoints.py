"""Map-point (landmark) memory: long-range feature tracks across keyframes.

Counterpart of bundletrack_tpu/matching/mappoints.py (reference:
src/FeatureManager.cpp:448-485 updateFramePairMapPoints, 489-520
findCorresByMapPoints, 142-170 forgetFrame).  Two fixed-capacity tables:

  obs [L, K]: keypoint index of landmark l in keyframe slot k (-1 = none)
  rev [K, N]: landmark id owning keypoint n of slot k (-1 = none)

Updates are masked writes with the last of repeated indices winning
(ops/scatter.py); new landmarks take free rows by rank (a cumsum).  Slots
are tensors, used through one-hot masks and gathers, never as plain
indices, which would read them to the host.  A fleet's tables carry a
leading stream axis ([S, L, K], [S, K, N]) and take one slot per stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackbench.reference.matching.pairwise import MatchResult
from trackbench.reference.ops.scatter import set_last_wins
from trackbench.reference.ops.topk import topk_stable


class MapPointTable(NamedTuple):
    obs: torch.Tensor  # [L, K] int32, -1 invalid
    rev: torch.Tensor  # [K, N] int32, -1 invalid


def init_mappoints(capacity: int, num_slots: int, num_kpts: int, device=None) -> MapPointTable:
    return MapPointTable(
        obs=torch.full((capacity, num_slots), -1, dtype=torch.int32, device=device),
        rev=torch.full((num_slots, num_kpts), -1, dtype=torch.int32, device=device),
    )


def _onehot(slot: torch.Tensor, n: int) -> torch.Tensor:
    """[S] slots -> [S, n] one-hot rows."""
    return torch.arange(n, device=slot.device) == slot[:, None]


def _row(table: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """table [S, R, X], row [S] -> table[s, row[s]] as [S, X]."""
    S, _, X = table.shape
    return torch.gather(table, 1, row[:, None, None].expand(S, 1, X))[:, 0]


def _set_column(obs, col, index, values, keep):
    """obs[s, index[s, m], col[s]] = values[s, m] for kept m."""
    new = set_last_wins(_row(obs.transpose(1, 2), col), index, values, keep)
    return torch.where(_onehot(col, obs.shape[2])[:, None, :], new[:, :, None], obs)


def _set_row(rev, row, index, values, keep):
    """rev[s, row[s], index[s, m]] = values[s, m] for kept m."""
    new = set_last_wins(_row(rev, row), index, values, keep)
    return torch.where(_onehot(row, rev.shape[1])[:, :, None], new[:, None, :], rev)


def _update_mappoints(table, slot_i, slot_j, matches):
    obs, rev = table.obs, table.rev
    L = obs.shape[1]
    S = obs.shape[0]
    ia, ib, mvalid = matches.idx_a, matches.idx_b, matches.valid
    ia32, ib32 = ia.to(torch.int32), ib.to(torch.int32)

    lm_a = torch.gather(_row(rev, slot_i), 1, ia)
    lm_b = torch.gather(_row(rev, slot_j), 1, ib)
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
    free = ~torch.any(obs >= 0, dim=-1)  # [S, L]
    free_rank = torch.cumsum(free.to(torch.int32), -1) - 1
    fresh_rank = torch.cumsum(fresh.to(torch.int32), -1) - 1
    rows = torch.arange(L, dtype=torch.int32, device=obs.device).expand(S, L)
    rank_to_row = torch.full((S, L + 1), L, dtype=torch.int32, device=obs.device)
    rank_to_row = set_last_wins(rank_to_row, free_rank.clamp(min=0), rows, free)
    new_rows = torch.gather(rank_to_row, 1, torch.clamp(fresh_rank, 0, L).long())
    ok_new = fresh & (new_rows < L)
    tgt = new_rows.clamp(max=L - 1)
    obs = _set_column(obs, slot_i, tgt, ia32, ok_new)
    obs = _set_column(obs, slot_j, tgt, ib32, ok_new)
    rev = _set_row(rev, slot_i, ia, new_rows, ok_new)
    rev = _set_row(rev, slot_j, ib, new_rows, ok_new)
    return MapPointTable(obs=obs, rev=rev)


def update_mappoints(
    table: MapPointTable,
    slot_i: torch.Tensor,
    slot_j: torch.Tensor,
    matches: MatchResult,
) -> MapPointTable:
    """Absorb verified matches between keyframe slots i and j into the tracks:
    a match extends the landmark owning either endpoint, else it spawns a new
    landmark observing both (reference updateFramePairMapPoints).  A fleet's
    tables [S, L, K] / [S, K, N] take per-stream slots [S] and matches
    [S, M]; one stream's tables take 0-dim slots and matches [M]."""
    if table.obs.dim() == 3:
        return _update_mappoints(table, slot_i, slot_j, matches)
    one = _update_mappoints(
        MapPointTable(table.obs[None], table.rev[None]), slot_i.reshape(1), slot_j.reshape(1),
        MatchResult(*(t[None] for t in matches)),
    )
    return MapPointTable(one.obs[0], one.rev[0])


def propagate_matches(
    table: MapPointTable,
    slot_i: torch.Tensor,  # [] or [P]; [S, P] for a fleet's tables
    slot_j: torch.Tensor,
    max_matches: int,
) -> MatchResult:
    """Matches between slots i and j implied by shared landmarks: one gather
    and a stable top-k compaction over the track table.  Slots may carry a
    leading pair axis, and a fleet's tables a stream axis before it."""
    def columns(slot):  # [L] or [P, L] per table
        if table.obs.dim() == 3:  # [S, L, K] with [S, P] slots -> [S, P, L]
            S, L, _ = table.obs.shape
            return torch.gather(table.obs, 2, slot[:, None, :].expand(S, L, slot.shape[1])).transpose(1, 2)
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
    landmarks left without observations free their rows.  A fleet's tables
    take per-stream slots [S]."""
    hot = torch.arange(table.rev.shape[-2], device=slot.device) == slot[..., None]
    return MapPointTable(
        obs=torch.where(hot[..., None, :], -1, table.obs),
        rev=torch.where(hot[..., :, None], -1, table.rev),
    )
