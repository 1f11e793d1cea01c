"""High-level serving API: load once, transcribe anything.

The counterpart of the JAX package's ``pipeline.py``: batched short-form
decode (greedy or beam, optionally in duration buckets), sequential or
chunked long-form with timestamps, the temperature ladder, the no-speech
rule and the VAD gate, word timestamps on every route, context conditioning
(``<|startofprev|>`` prompt), bias words (the in-loop trie bonus), language
id / translation for the multilingual models, and streaming sessions::

    from whisper_context_biasing_tpu_torch import Pipeline

    pipe = Pipeline("base.en")                 # on the card; device="cpu" to opt out
    res = pipe.transcribe(["a.wav", "b.wav"], context="patient on aspirin",
                          bias_words=["aspirin"], bias_boost=2.0, word_timestamps=True)
    res[0].text, res[0].words, res[0].segments, res[0].srt()

Greedy decoding can run speculatively, with the same tokens: a draft model
proposes (``Pipeline("base.en", draft_model="tiny.en", draft_checkpoint=...)``)
or Medusa heads on the model itself do (``Pipeline("base.en",
medusa="medusa.npz")``, from ``cli.medusa``; they win over a draft). Both
drive the short-form route and the t=0 rung of the long-form, chunked and
streaming routes.

Under a process group of several cards (``parallel.initialize_multihost``,
or ``torchrun``), ``model_parallelism`` meshes the pipeline as the JAX
package's does (``parallel.auto_mesh``): 1 (the default) is data parallelism
over every rank, N > 1 tensor parallelism over groups of N, 0 none. The
short-form route's rows then shard over "data" and the weights over
"model"; every rank gets every result. Every route takes the mesh: beams, a
draft (sharded like the model) and Medusa heads (whole on every rank) on the
short-form route, and the sequential and chunked long-form routes, whose
window batches shard over "data". Streams run the same calls on every rank.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import resolve_device
from .audio import load_audio, pad_or_trim, pcm_to_float32, select_mel_frontend
from .data.collator import SpeechSeq2SeqCollator
from .decode import (
    StreamingTranscriber,
    beam_decode_batch,
    decode_batch,
    detect_language,
    find_word_timestamps,
    load_draft,
    medusa_decode_batch,
    resolve_start_tokens,
    speculative_decode_batch,
    transcribe_chunked,
    transcribe_long_batch,
    unpack_long_form,
)
from .decode.greedy import Clock
from .models import (
    FAST_OVERRIDES,
    build_model,
    get_config,
    load_checkpoint_or_safetensors,
    params_from_jax,
)
from .models.medusa import load_medusa
from .models.whisper import Whisper, encode_audio
from .parallel import auto_mesh, shard_params
from .tokenizer import load_tokenizer
from .utils.subtitles import close_open_segments, format_srt, format_vtt, words_to_segments


@dataclass
class TranscriptionResult:
    text: str
    tokens: list = field(default_factory=list)
    language: str | None = None
    # (start_s, end_s, text) cues: long-form timestamps or word grouping
    segments: list | None = None
    # word-level timings (decode/word_timestamps.WordTiming)
    words: list | None = None
    # per-window QC dicts (transcribe(window_info=True), long-form modes):
    # start_s, temperature, avg_logprob, no_speech_prob, compression_ratio,
    # accepted
    windows: list | None = None

    def srt(self) -> str:
        if self.segments is None:
            raise ValueError("no timed segments (use timestamps=True or word_timestamps=True)")
        return format_srt(self.segments)

    def vtt(self) -> str:
        if self.segments is None:
            raise ValueError("no timed segments (use timestamps=True or word_timestamps=True)")
        return format_vtt(self.segments)


class Pipeline:
    """Model + tokenizer on one device.

    ``model``: family name (``tiny.en`` .. ``large-v3``). ``checkpoint``: an
    HF ``model.safetensors`` (file or directory) or a native checkpoint-N
    dir; ``params``: the JAX package's params tree as numpy arrays
    (``params_from_jax``); seeded random weights (``seed``) without either.
    ``fast`` (default: on a card) turns on the serving fast path: the
    flash-attention and int8 cross-attention kernels, int8 cross-K/V and tanh
    gelu. The log-mel frontend takes the mel kernel on a card either way.
    ``config`` replaces the named config outright.

    ``draft_model`` (a family name; ``draft_config`` replaces its config)
    turns on speculative greedy decoding with ``speculative_k`` proposals a
    round: the draft's weights come from ``draft_checkpoint``, from
    ``draft_params`` (a JAX params tree, or a ``Whisper`` model used as it
    is, e.g. the pipeline's own for a self-draft) or from the seeded init
    with a warning. It inherits the target's kernel switches. ``medusa`` (a
    ``medusa.npz`` path or a head dict) turns on Medusa decoding and wins
    over a draft; ``medusa_chains`` overrides its chain width.

    ``model_parallelism``: the mesh (see the module's docstring); a draft
    is sharded like the model."""

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
        draft_checkpoint: str | None = None,
        speculative_k: int = 4,
        draft_config=None,
        draft_params=None,
        medusa: str | dict | None = None,
        medusa_chains: int | None = None,
        model_parallelism: int = 1,
    ):
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
        self.mesh = auto_mesh(model_parallelism)
        if self.mesh is not None:
            self.model = shard_params(self.model, self.mesh)
        self.medusa = None
        if medusa is not None:
            self.medusa = (load_medusa(medusa, n_chains=medusa_chains)
                           if isinstance(medusa, str) else dict(medusa))
            if medusa_chains and not isinstance(medusa, str):
                self.medusa["n_chains"] = medusa_chains
        self.draft = self.draft_cfg = None
        self.speculative_k = speculative_k
        if draft_model or draft_config is not None:
            if isinstance(draft_params, Whisper):
                self.draft, self.draft_cfg = draft_params, draft_params.cfg
            else:
                self.draft, self.draft_cfg = load_draft(
                    draft_model, draft_checkpoint, dtype=dtype, overrides=overrides,
                    target_cfg=self.cfg, cfg=draft_config, params=draft_params,
                    device=self.device)
            if self.mesh is not None and self.draft.tp is None:  # not sharded yet
                self.draft = shard_params(self.draft, self.mesh)
        self.default_bias_words = bias_words
        self.default_bias_boost = bias_boost
        self.collator = SpeechSeq2SeqCollator(
            pad_token_id=self.tokenizer.pad_token_id,
            decoder_start_token_id=self.tokenizer.sot,
            bias_span_pad_id=self.tokenizer.eot,
        )
        # per-call times of the last short-form transcribe(): mel_ms,
        # encode_ms, prefill_ms, decode_ms (CUDA events on a card) and decode
        # steps (beam search adds reorder_ms on a card), and align_ms with
        # word timestamps; with window_buckets, the same per bucket under
        # "buckets" (keyed by the bucket's window in samples); empty after
        # long-form
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

    def mel(self, stacked: np.ndarray, n_mels: int | None = None) -> torch.Tensor:
        """(B, window) audio -> (B, n_mels, frames) features on the device
        (the model's ``n_mels`` by default), through the mel kernel on a
        card."""
        audio = torch.as_tensor(stacked, dtype=torch.float32, device=self.device)
        return select_mel_frontend()(audio, n_mels=n_mels or self.cfg.n_mels)

    def _long_form_draft(self, route: str):
        """The draft tuple for a long-form route, None with Medusa (it wins)
        or without a draft; a draft with another ``n_mels`` can't share the
        route's mel, so that route decodes plain with a warning."""
        if self.medusa is not None or self.draft is None:
            return None
        if self.draft_cfg.n_mels != self.cfg.n_mels:
            warnings.warn(f"{route} speculative decoding needs a draft with the target's n_mels "
                          f"({self.cfg.n_mels}); draft has {self.draft_cfg.n_mels} — "
                          f"decoding plain")
            return None
        return (self.draft, self.draft_cfg, self.speculative_k)

    @torch.no_grad()
    def _encode(self, mel: torch.Tensor) -> torch.Tensor:
        return encode_audio(self.model, mel)

    def _starts(self, n: int, mel_thunk, language, task, enc_out=None):
        """Start sequences for ``n`` clips; ``mel_thunk`` gives the detection
        mel, computed only when language detection runs."""
        return resolve_start_tokens(
            self.tokenizer, n, language=language, task=task,
            detect=lambda: self.detect_language(mel_thunk(), is_mel=True, enc_out=enc_out))

    def detect_language(self, audio, *, is_mel: bool = False, enc_out=None):
        """Per-clip ``(language_code, probability)``; multilingual models."""
        if is_mel:
            mel = audio
        else:
            clips = audio if isinstance(audio, (list, tuple)) else [audio]
            mel = self.mel(np.stack([pad_or_trim(self._load(a), self.window_samples)
                                     for a in clips]))
        return detect_language(self.model, self.tokenizer, mel, enc_out=enc_out)


    def stream(self, **kwargs) -> StreamingTranscriber:
        """An incremental transcriber on this pipeline's model and device
        (``decode/streaming.StreamingTranscriber``): ``feed()`` audio chunks,
        ``finish()`` the tail. The pipeline's bias defaults apply unless
        overridden; ``context`` may be text."""
        if "bias_spans" not in kwargs:
            spans = self._spans(kwargs.pop("bias_words", None), 1)
            if spans is not None:
                kwargs["bias_spans"] = spans
                kwargs.setdefault("bias_boost", self.default_bias_boost)
        ctx = kwargs.pop("context", None)
        if isinstance(ctx, str):
            kwargs["context"] = self.tokenizer.encode(ctx.lower(), add_special_tokens=False)
        elif ctx is not None:
            kwargs["context"] = ctx
        kwargs.setdefault("mel_fn", self.mel)
        kwargs.setdefault("window_samples", self.window_samples)
        # the session's accelerators carry into streaming (Medusa wins; a
        # draft with another mel frontend can't share the stream's mel_fn)
        if self.medusa is not None:
            kwargs.setdefault("medusa", self.medusa)
        elif (draft := self._long_form_draft("streaming")) is not None:
            kwargs.setdefault("draft", draft)
        return StreamingTranscriber(self.model, self.tokenizer, device=self.device, **kwargs)

    def _short_form(self, clips, idxs, win_samples, *, ctx, spans, boost, language, task,
                    num_beams, beam_early_stopping, max_tokens, word_timestamps,
                    alignment_heads):
        """Decode the clips at ``idxs`` padded or trimmed to one shared
        ``win_samples`` window: (hyps, word timings or None, langs, timings)."""
        clock = Clock(self.device)
        clock.mark("start")
        stacked = np.stack([pad_or_trim(clips[i], win_samples) for i in idxs])
        mel = self.mel(stacked)
        clock.mark("mel")
        need_lang = self.tokenizer.multilingual and (
            language == "auto" or (task == "translate" and not language))
        # one encoder pass shared by language id and the word alignment (the
        # decode encodes again inside its own call)
        enc = self._encode(mel) if (word_timestamps or need_lang) else None
        starts, langs = self._starts(len(idxs), lambda: mel, language, task, enc_out=enc)
        timings: dict = {}
        kwargs = dict(contexts=[ctx[i] for i in idxs] if ctx is not None else None,
                      max_new=max_tokens, bias_spans=spans[list(idxs)] if spans is not None
                      else None, bias_boost=boost, starts=starts, device=self.device,
                      timings=timings)
        if num_beams > 1:
            hyps = beam_decode_batch(self.model, self.tokenizer, mel, num_beams=num_beams,
                                     early_stopping=beam_early_stopping, mesh=self.mesh,
                                     **kwargs)
        elif self.medusa is not None:
            hyps = medusa_decode_batch(self.model, self.medusa, self.tokenizer, mel,
                                       pad_to_multiple=32, mesh=self.mesh, **kwargs)
        elif self.draft is not None:
            # a draft with another mel frontend gets its own mel
            mel_d = (None if self.draft_cfg.n_mels == self.cfg.n_mels
                     else self.mel(stacked, n_mels=self.draft_cfg.n_mels))
            hyps = speculative_decode_batch(self.draft, self.model, self.tokenizer, mel,
                                            k=self.speculative_k, pad_to_multiple=32,
                                            input_features_draft=mel_d, mesh=self.mesh,
                                            **kwargs)
        else:
            hyps = decode_batch(self.model, self.tokenizer, mel, pad_to_multiple=32,
                                mesh=self.mesh, **kwargs)
        words = None
        if word_timestamps:
            clock.mark("decoded")
            words = find_word_timestamps(
                self.model, self.tokenizer, mel, hyps, starts=starts,
                num_frames=[min(len(clips[i]), win_samples) // 320 for i in idxs],
                alignment_heads=alignment_heads, enc_out=enc)
            clock.mark("aligned")
            timings["align_ms"] = clock.ms("decoded", "aligned")
        return hyps, words, langs, dict(mel_ms=clock.ms("start", "mel"), **timings)

    @torch.no_grad()
    def transcribe(
        self,
        audio,
        *,
        context: str | None = None,
        bias_words: list[str] | None = None,
        bias_boost: float | None = None,
        language: str | None = None,
        task: str = "transcribe",
        num_beams: int = 1,
        beam_early_stopping: str = "off",
        max_tokens: int = 224,
        long_form: bool | str = "auto",
        chunked_batch: int = 64,
        vad: bool | dict | list = False,  # energy VAD gate / clip ranges (long-form)
        window_info: bool = False,  # long-form: per-window QC dicts on result.windows
        timestamps: bool = False,
        word_timestamps: bool = False,
        temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        window_buckets: tuple | list | None = None,  # short-form duration buckets (s)
        best_of: int = 1,           # sampled fallback rungs keep the best of n
        prompt_reset_on_temperature: float | None = 0.5,
        no_speech_threshold: float | None = 0.6,
        alignment_heads: list[tuple[int, int]] | None = None,
    ) -> list[TranscriptionResult] | TranscriptionResult:
        """Transcribe file paths and/or 16 kHz float arrays in one batch.

        ``long_form="auto"`` routes the batch through the sequential-window
        seek loop when any clip exceeds one window (``True`` forces it,
        ``False`` trims each clip to the window); ``long_form="chunked"``
        decodes all windows in parallel in padded batches of
        ``chunked_batch`` (overlap-merged, no history conditioning).
        ``timestamps`` adds absolute-time segments there (``result.srt()``,
        ``.vtt()``), and ``temperatures``, ``best_of``,
        ``prompt_reset_on_temperature``, ``no_speech_threshold``, ``vad`` and
        ``window_info`` drive their ladder and gates. ``word_timestamps``
        adds per-word times on every route (and, without ``timestamps``,
        caption segments grouped from them); ``alignment_heads`` overrides
        the published head set. ``window_buckets`` (seconds, e.g. (8, 15))
        decodes each short clip in the smallest bucket window that holds it,
        the full window always the last bucket. ``num_beams > 1`` decodes
        with beam search (short-form, and the long-form t=0 rung).
        ``language`` (a code or ``"auto"``) and ``task="translate"`` need a
        multilingual model."""
        single = not isinstance(audio, (list, tuple))
        clips = [self._load(a) for a in ([audio] if single else audio)]
        n = len(clips)
        boost = self.default_bias_boost if bias_boost is None else bias_boost
        spans = self._spans(bias_words, n)
        ctx = None
        if context:
            ctx = [self.tokenizer.encode(context.lower(), add_special_tokens=False)] * n
        win = self.window_samples
        chunked = long_form == "chunked"
        use_long = long_form is True or chunked or (
            long_form == "auto" and any(len(c) > win for c in clips))
        if window_buckets and use_long:
            # as in JAX: the long-form routes window at the full context
            warnings.warn("window_buckets applies to the short-form route only; this call "
                          "took a long-form path (a clip exceeds one window, or long_form "
                          "was forced) — buckets ignored.")
        if window_info and not use_long:
            warnings.warn("window_info=True reports long-form window QC; this call took the "
                          "short-form route (all clips <= one window) — result.windows stays "
                          "None. Pass long_form=True to force the windowed path.")

        if use_long:
            starts, langs = self._starts(
                n, lambda: self.mel(np.stack([pad_or_trim(c, win) for c in clips])),
                language, task)
            common = dict(
                mel_fn=self.mel, max_new=max_tokens, contexts=ctx, bias_spans=spans,
                bias_boost=boost, use_timestamps=timestamps, temperatures=tuple(temperatures),
                best_of=best_of, no_speech_threshold=no_speech_threshold, start_tokens=starts,
                return_segments=True, word_timestamps=word_timestamps,
                alignment_heads=alignment_heads, prefix_pad_to_multiple=32,
                window_samples=win, vad=vad, num_beams=num_beams,
                beam_early_stopping=beam_early_stopping, return_window_info=window_info,
                medusa=self.medusa, draft=self._long_form_draft("chunked" if chunked
                                                                else "long-form"),
                mesh=self.mesh, device=self.device)
            if chunked:
                # every window batch padded to chunked_batch rows
                out = transcribe_chunked(self.model, self.tokenizer, clips,
                                         max_batch=chunked_batch, pad_batches=True, **common)
            else:
                out = transcribe_long_batch(
                    self.model, self.tokenizer, clips,
                    prompt_reset_on_temperature=prompt_reset_on_temperature, **common)
            self.last_timings = {}
            hyps, segs, long_words, winfo = unpack_long_form(
                out, return_segments=True, word_timestamps=word_timestamps,
                return_window_info=window_info)
            results = []
            for i, h in enumerate(hyps):
                lw = long_words[i] if long_words is not None else None
                segments = close_open_segments(segs[i], clip_end=len(clips[i]) / 16000)
                if lw is not None and not timestamps:
                    segments = words_to_segments(lw)  # word cues beat whole-window ones
                results.append(TranscriptionResult(
                    text=self.tokenizer.decode(h, skip_special_tokens=True).strip(),
                    tokens=list(h), language=langs[i], segments=segments, words=lw,
                    windows=winfo[i] if winfo is not None else None))
            return results[0] if single else results

        opts = dict(ctx=ctx, spans=spans, boost=boost, language=language, task=task,
                    num_beams=num_beams, beam_early_stopping=beam_early_stopping,
                    max_tokens=max_tokens, word_timestamps=word_timestamps,
                    alignment_heads=alignment_heads)
        if window_buckets:
            # each clip decodes in the smallest bucket window that holds it;
            # windows round up to the 320-sample encoder hop, the full window
            # is always the last bucket
            sizes = sorted({-(-int(float(b) * 16000) // 320) * 320 for b in window_buckets})
            if not sizes or sizes[0] <= 0:
                raise ValueError(f"window_buckets must be positive seconds, "
                                 f"got {window_buckets!r}")
            sizes = [s for s in sizes if s < win] + [win]
            groups: dict[int, list[int]] = {}
            for i, c in enumerate(clips):
                s = next(sz for sz in sizes if len(c) <= sz or sz == win)
                groups.setdefault(s, []).append(i)
            hyps, words, langs = [None] * n, [None] * n if word_timestamps else None, [None] * n
            per_bucket = {}
            for s, idxs in sorted(groups.items()):
                # each bucket's batch padded to a power of two (at least 8)
                # with its first clip, as the JAX Pipeline does; the padding
                # rows are dropped below
                b = max(8, 1 << (len(idxs) - 1).bit_length())
                h, t, lg, tm = self._short_form(clips, idxs + [idxs[0]] * (b - len(idxs)), s,
                                                **opts)
                per_bucket[s] = dict(tm, clips=len(idxs), rows=b)
                for j, i in enumerate(idxs):
                    hyps[i], langs[i] = h[j], lg[j]
                    if words is not None:
                        words[i] = t[j]
            self.last_timings = {"buckets": per_bucket}
        else:
            hyps, words, langs, self.last_timings = self._short_form(
                clips, list(range(n)), win, **opts)
        results = [TranscriptionResult(
            text=self.tokenizer.decode(h, skip_special_tokens=True).strip(),
            tokens=list(h), language=langs[i],
            words=words[i] if words is not None else None,
            segments=words_to_segments(words[i]) if words is not None else None)
            for i, h in enumerate(hyps)]
        return results[0] if single else results
