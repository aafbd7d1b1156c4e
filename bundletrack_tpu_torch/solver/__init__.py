"""Sparse + dense normal equations and the Gauss-Newton pose-graph solve."""

from bundletrack_tpu_torch.solver.dense_p2p import (
    CompactDense,
    DenseFrames,
    compact_dense_frames,
    dense_p2p_from_compact,
    dense_p2p_normal_equations,
)
from bundletrack_tpu_torch.solver.gauss_newton import (
    GraphInputs,
    optimize_pose_graph,
    solve_normal_equations_cholesky,
)
from bundletrack_tpu_torch.solver.pcg import solve_normal_equations_pcg
from bundletrack_tpu_torch.solver.residuals import SparseCorres, sparse_normal_equations, sparse_residuals

__all__ = [
    "sparse_residuals",
    "sparse_normal_equations",
    "SparseCorres",
    "dense_p2p_normal_equations",
    "dense_p2p_from_compact",
    "compact_dense_frames",
    "CompactDense",
    "DenseFrames",
    "GraphInputs",
    "optimize_pose_graph",
    "solve_normal_equations_cholesky",
    "solve_normal_equations_pcg",
]
