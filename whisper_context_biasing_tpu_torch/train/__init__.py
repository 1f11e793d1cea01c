"""Training layer: the WeightCE loss, clipped AdamW with a warmup-cosine
schedule, the training step with microbatch accumulation, npz checkpoints in
the JAX package's layout, the fine-tuning loop with WER evaluation,
SpecAugment, LoRA adapters, Medusa head training and draft distillation."""

from .augment import SpecAugmentConfig, apply_spec_augment
from .checkpoint import (
    find_best_checkpoint,
    is_native_checkpoint,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from .distill import (
    DistillConfig,
    distill_and_evaluate,
    make_agreement_step,
    make_distill_loss_fn,
    make_distill_step,
)
from .loop import TrainingConfig, evaluate_wer, train_and_evaluate
from .lora import (
    init_lora_params,
    init_lora_state,
    lora_param_count,
    make_lora_train_step,
    merge_lora,
)
from .loss import bias_span_weights, weighted_ce_loss
from .medusa import (
    MedusaConfig,
    expected_tokens_per_round,
    init_medusa_state,
    make_medusa_loss_fn,
    make_medusa_train_step,
    train_medusa_heads,
)
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
    "SpecAugmentConfig",
    "apply_spec_augment",
    "init_lora_params",
    "init_lora_state",
    "lora_param_count",
    "make_lora_train_step",
    "merge_lora",
    "DistillConfig",
    "distill_and_evaluate",
    "make_agreement_step",
    "make_distill_loss_fn",
    "make_distill_step",
    "find_best_checkpoint",
    "is_native_checkpoint",
    "latest_checkpoint",
    "list_checkpoints",
    "load_checkpoint",
    "save_checkpoint",
    "TrainingConfig",
    "evaluate_wer",
    "train_and_evaluate",
    "bias_span_weights",
    "weighted_ce_loss",
    "MedusaConfig",
    "expected_tokens_per_round",
    "init_medusa_state",
    "make_medusa_loss_fn",
    "make_medusa_train_step",
    "train_medusa_heads",
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
