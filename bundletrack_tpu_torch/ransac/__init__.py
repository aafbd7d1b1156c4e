"""Batched 3-point RANSAC."""
