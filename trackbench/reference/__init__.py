"""The plain reference: a frozen copy of the port's plain path.

The tracker step and every module it calls, copied from the port
(bundletrack_tpu_torch at the commit that added the benchmark) with its
imports pointed here and its three hand-written kernels replaced by their
plain PyTorch versions (kernels/: the BA matcher, the normal-blocks sum,
the norm sums in XLA's order on the host).  It imports nothing of the
program, of JAX or of the JAX package, and a later change to the program
does not change it.  `precision` switches it to the control, which
computes one precision below what the configuration states.
"""
