"""Training layer: the WeightCE loss, clipped AdamW with a warmup-cosine
schedule, and the training step with microbatch accumulation."""

from .loss import bias_span_weights, weighted_ce_loss
from .optim import AdamW, OptState, global_norm, make_optimizer, warmup_cosine_schedule
from .step import (
    TrainState,
    accumulate_microbatch_grads,
    init_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "bias_span_weights",
    "weighted_ce_loss",
    "AdamW",
    "OptState",
    "global_norm",
    "make_optimizer",
    "warmup_cosine_schedule",
    "TrainState",
    "accumulate_microbatch_grads",
    "init_train_state",
    "make_eval_loss_step",
    "make_loss_fn",
    "make_train_step",
]
