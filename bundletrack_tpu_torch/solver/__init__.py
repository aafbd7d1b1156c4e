"""Sparse + dense normal equations and the Gauss-Newton pose-graph solve."""
