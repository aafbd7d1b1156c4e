"""Collectives over one process group, explicit, and the autograd ones.

The JAX package's `shard_map` bodies call `psum`, `pmax` and return sharded
outputs; here each of those is one visible call on the process group of a
mesh axis: `all_reduce` (SUM or MAX), `all_gather_cat` and
`broadcast_from_first`.  Only all_reduce, all_gather and broadcast are used:
gloo runs them on CUDA tensors too, which ranks sharing one card need.

`group=None` means no group: every function is then the identity, so the
single-device paths run unchanged.

The autograd operators follow Megatron's conjugate pair for tensor
parallelism, plus the two a data-parallel loss needs:
- `copy_to_group` (f): identity forward, all-reduce backward, before a
  column-parallel layer whose input is replicated;
- `reduce_from_group` (g): all-reduce forward, identity backward, after a
  row-parallel layer whose output feeds replicated work;
- `sum_over_group`: all-reduce forward and backward, for a sum whose
  consumers are sharded (a norm's statistics over sharded features);
- `gather_over_group`: all_gather forward; backward, all-reduce of the
  incoming gradient, then this rank's slice (a loss term that reads every
  rank's rows).  torch.distributed.nn.functional.all_gather fails in
  backward on a group that does not hold global rank 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MAX = dist.ReduceOp.MAX


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (backends differ in what they take)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_reduce(t: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """A reduced copy of t over the group (psum / pmax); t itself unchanged."""
    if group is None:
        return t
    out = _wire(t).clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.dtype)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order (a
    sharded output made whole)."""
    if group is None:
        return t
    w = _wire(t).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


def broadcast_from_first(t: torch.Tensor, group) -> torch.Tensor:
    """Group rank 0's value of t on every rank of the group."""
    if group is None:
        return t
    out = _wire(t).clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out.to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _GatherOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_cat(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        lo = group_rank(ctx.group) * ctx.n
        return all_reduce(grad.contiguous(), ctx.group)[lo:lo + ctx.n], None


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_over_group(x, group):
    return x if group is None else _SumOverGroup.apply(x, group)


def gather_over_group(x, group):
    """x [n, ...] on every rank -> [group size * n, ...] in group-rank order,
    differentiable (see the module docstring)."""
    return x if group is None else _GatherOverGroup.apply(x, group)
