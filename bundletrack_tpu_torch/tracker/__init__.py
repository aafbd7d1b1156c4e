"""Tracker state, keyframe selection, the per-frame step and the host driver."""

from bundletrack_tpu_torch.tracker.bundler import make_track_frame, track_frame
from bundletrack_tpu_torch.tracker.selection import keyframe_admission, select_ba_subset
from bundletrack_tpu_torch.tracker.state import FrameObservation, TrackerState, init_tracker_state, set_streams

__all__ = [
    "TrackerState",
    "init_tracker_state",
    "FrameObservation",
    "track_frame",
    "make_track_frame",
    "select_ba_subset",
    "keyframe_admission",
    "set_streams",
]
