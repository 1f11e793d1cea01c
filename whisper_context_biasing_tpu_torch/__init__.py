"""whisper_context_biasing_tpu_torch — the PyTorch + CUDA port of
``whisper_context_biasing_tpu`` for NVIDIA Hopper (H100).

Whisper ASR with contextual biasing: decoder prompt conditioning and the
in-loop bias-trie logits processor, on the short-form (greedy or beam,
optionally duration-bucketed), sequential and chunked long-form, streaming
and HTTP serving paths with word timestamps, speculative (draft-model) and
Medusa decoding; the bias-weighted cross-entropy (WeightCE) fine-tune with
SpecAugment and LoRA, and draft distillation.
The JAX package beside it is the reference each ported function is held
against; this package imports nothing from it.

Layout mirrors the JAX package:
  models/   config, the Whisper modules, weight carry-over (``params_from_jax``),
            HF safetensors in and out, Medusa heads, the cross-attention
            alignment pass
  ops/      hand-written CUDA kernels beside their plain torch versions: the
            log-mel, the flash forward and backward, the int8 cross-attention
            and the fused LayerNorm+matmul
  audio/    loading (and the native C++ WAV runtime), the log-mel frontend and
            the energy VAD gate
  data/     the prompted jsonl dataset, the collator, the threaded loader
  decode/   greedy and beam decode, the bias-trie processor, language id,
            speculative and Medusa decoding, sequential and chunked
            long-form transcription, word timestamps, streaming sessions
  train/    WeightCE loss, clipped AdamW, ``make_train_step``, SpecAugment,
            LoRA, the fine-tuning loop with WER evaluation and npz
            checkpoints, the Medusa trainer, draft distillation
  metrics/  WER and bias-word WER
  pipeline  ``Pipeline``: load once, transcribe
  cli/      the command-line entry points, the HTTP server, the acceptance
            sweep and the inspection harnesses among them

Common entry points are re-exported here, as in the JAX package (its
``init_params`` is the port's ``init_state_dict``: a seeded state dict)::

    from whisper_context_biasing_tpu_torch import (
        load_tokenizer, get_config, init_state_dict, load_pretrained,
        PromptWhisperDataset, SpeechSeq2SeqCollator,
        greedy_decode, beam_decode, decode_batch, transcribe_long,
        TrainingConfig, train_and_evaluate, evaluate_wer,
        compute_bias_wer, corpus_wer, BasicTextNormalizer,
    )
"""

__version__ = "0.1.0"

from .tokenizer import WhisperTokenizer, load_tokenizer
from .models import (
    WhisperConfig,
    get_config,
    init_state_dict,
    load_checkpoint_or_safetensors,
    load_pretrained,
    params_from_jax,
)
from .data import PromptWhisperDataset, SpeechSeq2SeqCollator
from .decode import (
    beam_decode,
    beam_decode_batch,
    decode_batch,
    greedy_decode,
    transcribe_long,
    transcribe_long_batch,
)
from .train import TrainingConfig, evaluate_wer, train_and_evaluate
from .metrics import BasicTextNormalizer, compute_bias_wer, corpus_wer, score_predictions
from .pipeline import Pipeline, TranscriptionResult

__all__ = [
    "load_tokenizer",
    "WhisperTokenizer",
    "WhisperConfig",
    "get_config",
    "init_state_dict",
    "load_pretrained",
    "load_checkpoint_or_safetensors",
    "params_from_jax",
    "PromptWhisperDataset",
    "SpeechSeq2SeqCollator",
    "beam_decode",
    "beam_decode_batch",
    "decode_batch",
    "greedy_decode",
    "transcribe_long",
    "transcribe_long_batch",
    "TrainingConfig",
    "evaluate_wer",
    "train_and_evaluate",
    "BasicTextNormalizer",
    "compute_bias_wer",
    "corpus_wer",
    "score_predictions",
    "Pipeline",
    "TranscriptionResult",
]
