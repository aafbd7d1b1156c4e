"""The trainers' optimiser and step: Adam with optax's defaults, optax's
cosine decay, and one update of a loss.

`torch.optim.Adam` and `optax.adam` make the same update with the same
defaults (b1 0.9, b2 0.999, eps 1e-8).  optax builds its state at `init`;
torch builds Adam's on the first step, so `make_adam` builds it at once:
the state dict then holds every tensor a checkpoint restores into.
`CosineAnnealingLR` is recursive and differs from optax's schedule, so
`cosine_lr` is the closed form, applied through `LambdaLR`.
"""

from __future__ import annotations

import math

import torch

from bundletrack_tpu_torch.ops.collectives import all_reduce


def cosine_lr(step: int, decay_steps: int, alpha: float = 0.1) -> float:
    """The factor of optax.cosine_decay_schedule(lr, decay_steps, alpha) at
    `step`: (1 - alpha) * 0.5 * (1 + cos(pi * min(step, decay_steps) /
    decay_steps)) + alpha.  optax reads it at the update's count before the
    update, so step 0 takes the factor at 0."""
    t = min(step, decay_steps) / decay_steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam at `lr` on `params`, its state built (optax.adam(lr) and its init)."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr)
    # the base rate a scheduler keeps: with it in every state dict, a run
    # with a schedule and one without restore into the same template
    opt.param_groups[0]["initial_lr"] = lr
    for p in params:
        # the state Adam would create on its first step (`step` a CPU f32
        # count, as torch keeps it when not capturable)
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


def cosine_schedule(optimizer, decay_steps: int, start_step: int = 0):
    """A LambdaLR that gives step i of this run the rate lr * cosine_lr(start_step
    + i, decay_steps), `start_step` being the step a resumed run starts at.
    Make it after restoring the optimiser's state: it sets the rate of the
    next step from the restored base rate."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda i: cosine_lr(start_step + i, decay_steps))


def train_step(loss_fn, optimizer, scheduler=None, data_group=None):
    """step(*args) -> metrics: one optimiser update on loss_fn(*args) ->
    (loss, metrics).  The metrics, "loss" among them, are detached 0-dim
    tensors on the loss's device: the step reads nothing back to the host.

    With `data_group` (data parallelism), loss_fn returns this rank's share
    of the global loss: the gradients are summed over the group (one
    all-reduce of them all, not a mean), and "loss" is the sum of the
    shares; the other metrics are loss_fn's, already global."""

    def step(*args):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(*args)
        loss.backward()
        if data_group is not None:
            _sum_gradients(optimizer, data_group)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = all_reduce(loss.detach(), data_group)
        return metrics

    return step


def _sum_gradients(optimizer, group) -> None:
    """Every parameter's gradient summed over the group, in one all-reduce.
    Every rank has a gradient for the same parameters (one program)."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))
