"""The yardstick's arithmetic against hand-worked values."""

import numpy as np
import pytest

from trackbench import arith
from trackbench.render import corner_points


def test_percentile_interpolates_between_ranks():
    assert arith.percentile(range(1, 101), 95) == pytest.approx(95.05)  # rank 94.05 of 0..99
    assert arith.percentile([3.0], 95) == 3.0
    assert arith.percentile([10, 0, 20, 30], 50) == 15.0
    assert arith.percentile(range(21), 95) == 19.0


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (9, 12)]
    assert arith.union_length(iv, 0, 10) == pytest.approx(3 + 2 + 1)
    assert arith.union_length(iv, 1.5, 5.75) == pytest.approx(1.5 + 0.75)
    assert arith.union_length([], 0, 1) == 0.0
    assert arith.gaps(iv, 0, 10) == [(3, 5), (7, 9)]


def test_matcher_bound_at_the_fleet_is_the_epilogue():
    # S*P = 960 pairs on the [128, 512, 256] table: 22 * 960 * 512^2 / (132*128*1.98e9)
    s = arith.matcher_bound_s(128, 512, 256, 960)
    assert s == pytest.approx(22 * 960 * 512 * 512 / (132 * 128 * 1.98e9))
    assert s * 1e3 == pytest.approx(0.1655, abs=5e-5)  # chip_smoke's figure
    assert 2 * 960 * 512 * 512 * 256 / 989e12 < s


def test_sums_bound_is_bytes_on_a_large_map():
    n, groups = 8 * 16 * 400 * 400, 8
    assert arith.sums_bound_s(n, groups, 3) == pytest.approx((4 * n + 8 * groups) / 3.35e12)


def test_flop_counts():
    assert arith.matcher_flop(960, 512, 256) == 2 * 960 * 512**2 * 256
    assert arith.ransac_flop(968, 2000, 256) == 968 * 256 * 2048 * 52  # T = 8 * 256
    assert arith.gn_flop(7, 960, 256, 4096) == 7 * 960 * (768 + 4096) * 240
    assert arith.least_seconds({"bf16": 989e12, "f32": 67e12}) == pytest.approx(2.0)


def test_corner_gap_reads_a_rotation_and_a_translation_in_mm():
    c = corner_points(0.2)
    T = np.eye(4)
    U = np.eye(4)
    U[:3, 3] = [0.001, 0, 0]
    assert arith.corner_gap_mm(T, U, c) == pytest.approx(1.0)
    a = np.deg2rad(1.0)
    R = np.eye(4)
    R[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    # a corner at radius sqrt(0.02) from the z axis moves 2 r sin(a / 2)
    assert arith.corner_gap_mm(T, R, c) == pytest.approx(2 * np.sqrt(0.02) * np.sin(a / 2) * 1e3)
    bad = np.full((4, 4), np.nan)
    assert arith.corner_gap_mm(bad, T, c) == float("inf")
