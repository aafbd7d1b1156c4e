"""Multi-stream tracking (parallel/fleet.py), the pair-sharded BA
(parallel/pair_sharded.py) and the multi-process runtime
(parallel/distributed.py)."""

from bundletrack_tpu_torch.parallel.distributed import (
    global_fleet_mesh,
    global_train_mesh,
    initialize_multihost,
    local_stream_slice,
    make_mesh,
)
from bundletrack_tpu_torch.parallel.fleet import (
    fleet_observation,
    init_fleet_state,
    make_fleet_step,
    make_sharded_lfnet_train_step,
    make_sharded_vos_train_step,
)

__all__ = [
    "fleet_observation",
    "global_fleet_mesh",
    "global_train_mesh",
    "init_fleet_state",
    "initialize_multihost",
    "local_stream_slice",
    "make_fleet_step",
    "make_mesh",
    "make_sharded_lfnet_train_step",
    "make_sharded_vos_train_step",
]
