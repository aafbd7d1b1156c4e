"""The yardstick's arithmetic: percentiles, the union of device intervals,
published peaks, and the operations and bytes of the counted work.

Frozen here so that a change to the program cannot move it.  The matcher's
bound is chip_smoke.py's `matcher_bound` (the matcher_bench figures), the
sums kernel's is sums_bench's bytes and operations, the LF-Net forward's
products are profile_step's count.
"""

from __future__ import annotations

import math

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# f32 instruction rate outside the tensor cores: 132 SMs x 128 lanes x 1.98 GHz
F32_INSTR_PER_S = 132 * 128 * 1.98e9
# f32 instructions per candidate in the matcher's epilogue: distance 2, gate
# 13, 2 compares and 1 select, row minimum 2, column minimum 2
MATCHER_INSTR_PER_CANDIDATE = 22
# products of one Gauss-Newton row with 12 unknowns (two poses): the three
# 6x6 blocks of J^T J and the two 6-vectors of J^T r, 2 FLOP per multiply-add
GN_FLOP_PER_ROW = 2 * (3 * 36 + 12)
# products of one RANSAC trial score: the [26] match feature against the
# [26] trial feature (ransac/ransac.py's G [M, 26] x F [26, T])
RANSAC_FLOP_PER_SCORE = 2 * 26


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between the
    closest ranks (numpy's default method)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches [(start, end)] of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def matcher_bound_s(K: int, N: int, D: int, P: int) -> float:
    """Least seconds of one matcher call on a [K, N, D] table with P pairs:
    the largest of bytes, bf16 products and the epilogue's f32 instructions."""
    in_bytes = K * N * D * 4 + 2 * K * N * 3 * 4 + K * N + 2 * P * 4
    out_bytes = P * N * (4 + 4 + 1)
    return max((in_bytes + out_bytes) / HBM_BYTES_PER_S,
               2 * P * N * N * D / BF16_FLOP_PER_S,
               MATCHER_INSTR_PER_CANDIDATE * P * N * N / F32_INSTR_PER_S)


def sums_bound_s(n: int, groups: int, ops_per_element: int) -> float:
    """Least seconds of one sums-kernel call over n f32 elements in `groups`
    groups: the input read once and two floats written per group, against
    `ops_per_element` f32 operations per element (3: add, multiply, add; 4
    for the instance statistics' shifted squares)."""
    return max((4 * n + 8 * groups) / HBM_BYTES_PER_S, ops_per_element * n / F32_FLOP_PER_S)


def matcher_flop(pairs: int, N: int, D: int) -> int:
    """bf16 products of the BA matcher: 2 S P N^2 D."""
    return 2 * pairs * N * N * D


def ransac_flop(batches: int, trials: int, M: int) -> int:
    """f32 products of RANSAC's trial scoring: every batch (a frame pair)
    scores its M match slots against T = ceil(trials / M) * M trials."""
    T = -(-trials // M) * M
    return batches * M * T * RANSAC_FLOP_PER_SCORE


def gn_flop(iterations: int, pairs: int, M: int, C: int) -> int:
    """f32 products of the GN normal equations: per iteration and pair, 3
    rows per sparse match slot and 1 per dense source pixel."""
    return iterations * pairs * (3 * M + C) * GN_FLOP_PER_ROW


def least_seconds(flop_by_dtype: dict) -> float:
    """The least time for {"bf16": FLOP, "f32": FLOP} at the published peaks."""
    return flop_by_dtype.get("bf16", 0) / BF16_FLOP_PER_S + flop_by_dtype.get("f32", 0) / F32_FLOP_PER_S


def corner_gap_mm(T_a, T_b, corners) -> float:
    """Largest distance in mm between the cube's corners placed by two
    object-in-camera poses: [..., 4, 4] each; rotation and translation in one
    number (1 degree about the centre moves a corner of the 0.2 m cube by
    ~3 mm)."""
    T_a = np.asarray(T_a, np.float64)
    T_b = np.asarray(T_b, np.float64)
    pa = np.einsum("...ij,kj->...ki", T_a[..., :3, :3], corners) + T_a[..., None, :3, 3]
    pb = np.einsum("...ij,kj->...ki", T_b[..., :3, :3], corners) + T_b[..., None, :3, 3]
    d = np.linalg.norm(pa - pb, axis=-1)
    return float(np.nanmax(np.where(np.isfinite(d), d, np.inf)) * 1e3) if d.size else 0.0
