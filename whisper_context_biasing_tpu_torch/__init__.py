"""whisper_context_biasing_tpu_torch — the PyTorch + CUDA port of
``whisper_context_biasing_tpu`` for NVIDIA Hopper (H100).

Whisper ASR with contextual biasing: decoder prompt conditioning and the
in-loop bias-trie logits processor, on the short-form (greedy or beam) and
sequential long-form serving paths, and the bias-weighted cross-entropy
(WeightCE) fine-tuning step.
The JAX package beside it is the reference each ported function is held
against; this package imports nothing from it.

Layout mirrors the JAX package:
  models/   config, the Whisper modules, weight carry-over (``params_from_jax``)
  ops/      hand-written CUDA kernels (mel, flash forward and backward, int8
            cross-attention) beside their plain torch versions
  audio/    loading, the log-mel frontend and the energy VAD gate
  decode/   greedy and beam decode, the bias-trie processor, language id,
            sequential long-form transcription
  train/    WeightCE loss, clipped AdamW, ``make_train_step``
  pipeline  ``Pipeline``: load once, transcribe
"""

from .models import get_config, params_from_jax
from .pipeline import Pipeline, TranscriptionResult

__all__ = ["Pipeline", "TranscriptionResult", "get_config", "params_from_jax"]
