"""Host-side helpers: parameter files, checkpoints, profiling, viz."""

from bundletrack_tpu_torch.utils.checkpoint import restore_tracker_state, save_tracker_state

__all__ = ["save_tracker_state", "restore_tracker_state"]
