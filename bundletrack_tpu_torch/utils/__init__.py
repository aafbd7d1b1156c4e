"""Host-side helpers: parameter files, checkpoints, stage timing, profiling, viz."""

from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state, save_tracker_state
from bundletrack_tpu_torch.utils.timing import StageTimer

__all__ = ["StageTimer", "save_tracker_state", "restore_tracker_state"]
