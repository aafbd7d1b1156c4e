"""Pose-accuracy metrics (ADD and ADD-S AUC, rotation and translation errors)."""
