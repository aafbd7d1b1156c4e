"""Tracker state, keyframe selection, the per-frame step and the host driver."""
