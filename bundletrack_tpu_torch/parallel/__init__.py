"""Multi-stream tracking: S streams in one step (parallel/fleet.py)."""

from bundletrack_tpu_torch.parallel.fleet import (
    fleet_observation,
    init_fleet_state,
    make_fleet_step,
)

__all__ = ["fleet_observation", "init_fleet_state", "make_fleet_step"]
