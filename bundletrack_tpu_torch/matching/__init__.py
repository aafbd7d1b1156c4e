"""Pairwise mutual-NN matching with geometric gates, and the landmark table."""

from bundletrack_tpu_torch.matching.mappoints import (
    MapPointTable,
    init_mappoints,
    propagate_matches,
    update_mappoints,
)
from bundletrack_tpu_torch.matching.mappoints import forget_frame as forget_frame_mappoints
from bundletrack_tpu_torch.matching.pairwise import (
    MatchResult,
    descriptor_distances,
    geometric_gate,
    match_pair,
    match_pairs_batched,
    mutual_nearest,
)

__all__ = [
    "descriptor_distances",
    "mutual_nearest",
    "geometric_gate",
    "match_pair",
    "match_pairs_batched",
    "MatchResult",
    "MapPointTable",
    "init_mappoints",
    "update_mappoints",
    "propagate_matches",
    "forget_frame_mappoints",
]
