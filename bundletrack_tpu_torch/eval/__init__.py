"""Pose-accuracy metrics (ADD-S AUC, rotation and translation errors)."""
