"""High-level serving API: load once, transcribe short-form clips.

The counterpart of the JAX package's ``pipeline.py`` for its short-form
greedy route: clips of at most one window, optional context conditioning
(``<|startofprev|>`` prompt) and bias words (the in-loop trie bonus)::

    from whisper_context_biasing_tpu_torch import Pipeline

    pipe = Pipeline("base.en")                 # on the card; device="cpu" to opt out
    res = pipe.transcribe(["a.wav", "b.wav"], context="patient on aspirin",
                          bias_words=["aspirin"], bias_boost=2.0)
    res[0].text

Options of the JAX Pipeline that are not ported yet raise
``NotImplementedError`` naming the ROADMAP queue item that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import resolve_device
from .audio import load_audio, pad_or_trim, pcm_to_float32, select_mel_frontend
from .data.collator import SpeechSeq2SeqCollator
from .decode import decode_batch
from .decode.greedy import Clock
from .models import (
    FAST_OVERRIDES,
    build_model,
    get_config,
    load_checkpoint_or_safetensors,
    params_from_jax,
)
from .tokenizer import load_tokenizer


@dataclass
class TranscriptionResult:
    text: str
    tokens: list = field(default_factory=list)


def _not_ported(what: str, queue: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {queue})")


class Pipeline:
    """Model + tokenizer on one device.

    ``model``: family name (``tiny.en`` .. ``large-v3``). ``checkpoint``: an
    HF ``model.safetensors`` (file or directory) or a native checkpoint-N
    dir; ``params``: the JAX package's params tree as numpy arrays
    (``params_from_jax``); seeded random weights (``seed``) without either.
    ``fast`` (default: on a card) turns on the serving fast path: the
    flash-attention and int8 cross-attention kernels, int8 cross-K/V and tanh
    gelu. The log-mel frontend takes the mel kernel on a card either way.
    ``config`` replaces the named config outright."""

    def __init__(
        self,
        model: str = "base.en",
        *,
        checkpoint: str | None = None,
        vocab: str | None = None,
        merges: str | None = None,
        dtype: str = "bfloat16",
        fast: bool | None = None,
        bias_words: list[str] | None = None,
        bias_boost: float = 0.0,
        config_overrides: dict | None = None,
        params: dict | None = None,
        config=None,
        tokenizer=None,
        seed: int = 0,
        device="cuda",
        draft_model: str | None = None,
        medusa=None,
    ):
        if draft_model is not None or medusa is not None:
            _not_ported("speculative and Medusa decoding", "Queue A.7")
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or load_tokenizer(
            vocab, merges, multilingual=not model.endswith(".en"))
        if fast is None:
            fast = self.device.type == "cuda"
        overrides = dict(config_overrides or {})
        if fast:
            for k, v in FAST_OVERRIDES.items():
                overrides.setdefault(k, v)
        self.cfg = config if config is not None else get_config(model, dtype=dtype, **overrides)
        state = None
        if params is not None:
            state = params_from_jax(params, self.cfg)
        elif checkpoint:
            state, self.cfg = load_checkpoint_or_safetensors(checkpoint, self.cfg)
        self.model = build_model(self.cfg, state, seed=seed, device=self.device)
        self.default_bias_words = bias_words
        self.default_bias_boost = bias_boost
        self.collator = SpeechSeq2SeqCollator(
            pad_token_id=self.tokenizer.pad_token_id,
            decoder_start_token_id=self.tokenizer.sot,
            bias_span_pad_id=self.tokenizer.eot,
        )
        # per-call times of the last transcribe(): mel_ms, encode_ms,
        # prefill_ms, decode_ms (CUDA events on a card) and decode steps
        self.last_timings: dict = {}

    @property
    def window_samples(self) -> int:
        """Audio window in samples: one encoder state per 320 samples
        (480000 = 30 s for the standard configs)."""
        return self.cfg.n_audio_ctx * 320

    def _load(self, audio) -> np.ndarray:
        if isinstance(audio, (str, bytes)):
            return load_audio(audio)
        return pcm_to_float32(audio)

    def _spans(self, bias_words, n):
        words = bias_words if bias_words is not None else self.default_bias_words
        if not words:
            return None
        enc = [self.tokenizer.encode(w.lower(), add_special_tokens=False) for w in words]
        return self.collator.pad_bias_spans([enc] * n)

    def mel(self, stacked: np.ndarray) -> torch.Tensor:
        """(B, window) audio -> (B, n_mels, frames) features on the device,
        through the mel kernel on a card."""
        audio = torch.as_tensor(stacked, dtype=torch.float32, device=self.device)
        return select_mel_frontend()(audio, n_mels=self.cfg.n_mels)

    @torch.no_grad()
    def transcribe(
        self,
        audio,
        *,
        context: str | None = None,
        bias_words: list[str] | None = None,
        bias_boost: float | None = None,
        max_tokens: int = 224,
        language: str | None = None,
        task: str = "transcribe",
        num_beams: int = 1,
        long_form: bool | str = "auto",
        timestamps: bool = False,
        word_timestamps: bool = False,
        window_buckets=None,
    ) -> list[TranscriptionResult] | TranscriptionResult:
        """Transcribe file paths and/or 16 kHz float arrays in one batch, each
        padded or trimmed to one window: a longer clip needs
        ``long_form=False`` (trimmed), since long-form is not ported yet."""
        if num_beams > 1:
            _not_ported("beam search", "Queue A.6 (decode/beam.py)")
        if timestamps or word_timestamps:
            _not_ported("timestamps", "Queue A.6 (word timestamps, long-form)")
        if window_buckets:
            _not_ported("window_buckets", "Queue A.6 (serving surfaces)")
        if language is not None or task != "transcribe":
            _not_ported("language forcing, detection and translation",
                        "Queue A.6 (decode/language.py)")
        single = not isinstance(audio, (list, tuple))
        clips = [self._load(a) for a in ([audio] if single else audio)]
        n = len(clips)
        win = self.window_samples
        # as in JAX, only "auto" routes a clip over one window to long-form;
        # long_form=False trims it to the window (pad_or_trim below)
        if long_form is True or long_form == "chunked" or (
                long_form == "auto" and any(len(c) > win for c in clips)):
            _not_ported("long-form transcription (a clip over one window)",
                        "Queue A.6 (decode/long_form.py, decode/chunked.py)")
        boost = self.default_bias_boost if bias_boost is None else bias_boost
        spans = self._spans(bias_words, n)
        ctx = None
        if context:
            ctx = [self.tokenizer.encode(context.lower(), add_special_tokens=False)] * n

        clock = Clock(self.device)
        clock.mark("start")
        mel = self.mel(np.stack([pad_or_trim(c, win) for c in clips]))
        clock.mark("mel")
        timings: dict = {}
        hyps = decode_batch(self.model, self.tokenizer, mel, contexts=ctx,
                            max_new=max_tokens, bias_spans=spans, bias_boost=boost,
                            pad_to_multiple=32, device=self.device, timings=timings)
        self.last_timings = dict(mel_ms=clock.ms("start", "mel"), **timings)
        results = [TranscriptionResult(
            text=self.tokenizer.decode(h, skip_special_tokens=True).strip(),
            tokens=list(h)) for h in hyps]
        return results[0] if single else results
