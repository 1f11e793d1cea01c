"""whisper_context_biasing_tpu_torch — the PyTorch + CUDA port of
``whisper_context_biasing_tpu`` for NVIDIA Hopper (H100).

Whisper ASR with contextual biasing: decoder prompt conditioning and the
in-loop bias-trie logits processor, on the short-form (greedy or beam,
optionally duration-bucketed), sequential and chunked long-form, streaming
and HTTP serving paths with word timestamps, and the bias-weighted
cross-entropy (WeightCE) fine-tuning step.
The JAX package beside it is the reference each ported function is held
against; this package imports nothing from it.

Layout mirrors the JAX package:
  models/   config, the Whisper modules, weight carry-over (``params_from_jax``),
            the cross-attention alignment pass
  ops/      hand-written CUDA kernels (mel, flash forward and backward, int8
            cross-attention) beside their plain torch versions
  audio/    loading (and the native C++ WAV runtime), the log-mel frontend and
            the energy VAD gate
  decode/   greedy and beam decode, the bias-trie processor, language id,
            sequential and chunked long-form transcription, word timestamps,
            streaming sessions
  train/    WeightCE loss, clipped AdamW, ``make_train_step``
  pipeline  ``Pipeline``: load once, transcribe
  cli/      the command-line entry points, the HTTP server among them
"""

from .models import get_config, params_from_jax
from .pipeline import Pipeline, TranscriptionResult

__all__ = ["Pipeline", "TranscriptionResult", "get_config", "params_from_jax"]
