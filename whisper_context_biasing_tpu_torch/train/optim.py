"""Optimizer and learning-rate schedule, written out to match the JAX
package's ``optax.chain(clip_by_global_norm(max_norm), adamw(schedule))``
step for step:

  * clip: the gradients are scaled by ``max_norm / norm`` only when their
    global norm is at least ``max_norm`` (``torch.nn.utils.clip_grad_norm_``
    adds 1e-6 to the norm and so differs)
  * schedule: linear warmup from 0 to the peak, then cosine decay to 0,
    evaluated at the count *before* the update
  * AdamW: bias-corrected moments, ``eps`` added to sqrt(nu_hat), decoupled
    weight decay on every parameter (layer norms and biases included)

The update runs in place on the parameters; the count lives on the host,
so a step needs no device-to-host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           end_lr_scale: float = 0.0):
    """count -> lr: linear warmup from 0 over ``warmup_steps``, then cosine
    decay to ``end_lr_scale * peak_lr`` over the remaining steps (optax's
    ``join_schedules([linear_schedule, cosine_decay_schedule])``)."""
    warmup = max(1, warmup_steps)
    decay = max(1, total_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * min(count, warmup) / warmup
        t = min(count - warmup_steps, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
        return peak_lr * ((1 - end_lr_scale) * cosine + end_lr_scale)

    return schedule


@dataclass
class OptState:
    count: int = 0                                  # updates applied so far
    mu: list = field(default_factory=list)          # first moments, one per param
    nu: list = field(default_factory=list)          # second moments


def global_norm(grads, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (None counts as 0).
    Under tensor parallelism ``sharded[i]`` marks a gradient that is this
    rank's shard of a tensor split over ``group`` (the "model" axis): their
    squares sum over the group, the replicated ones count once."""
    if group is None:
        sq = [g.float().pow(2).sum() for g in grads if g is not None]
        return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())
    parts = [[], []]
    for g, s in zip(grads, sharded):
        if g is not None:
            parts[bool(s)].append(g.float().pow(2).sum())
    rep, shard = (torch.stack(p).sum() if p else torch.zeros(()) for p in parts)
    dist.all_reduce(shard, group=group)
    return (rep + shard).sqrt()


class AdamW:
    """Global-norm clipping, then AdamW with decoupled weight decay, under a
    learning-rate schedule (the JAX package's ``make_optimizer``)."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, max_grad_norm: float | None = 1.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params) -> OptState:
        params = list(params)
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params, grads, state: OptState, norm: torch.Tensor | None = None,
                frozen=()) -> OptState:
        """One step, in place on ``params`` and ``state``. ``grads`` align with
        ``params`` (None = zero); ``norm`` is their global norm, if already
        computed. Parameters whose index is in ``frozen`` keep their value
        (their moments still see zero gradients, as in the JAX package's
        ``freeze_encoder``, which zeroes their updates)."""
        params = list(params)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self.max_grad_norm is not None:
            norm = global_norm(grads) if norm is None else norm
            keep = norm < self.max_grad_norm
            grads = [torch.where(keep, g, g / norm * self.max_grad_norm) for g in grads]
        count = state.count + 1
        bc1, bc2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        lr = self.schedule(state.count)
        frozen = set(frozen)
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, state.mu, state.nu)):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            if i in frozen:
                continue
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)
        state.count = count
        return state


def make_optimizer(peak_lr: float = 1e-5, warmup_steps: int = 50, total_steps: int = 10000,
                   weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, max_grad_norm: float | None = 1.0) -> AdamW:
    """The reference recipe: AdamW, lr 1e-5 with 50 warmup steps and cosine
    decay, weight decay 0.01, gradients clipped to global norm 1.0."""
    return AdamW(warmup_cosine_schedule(peak_lr, warmup_steps, total_steps), b1=b1, b2=b2,
                 eps=eps, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
