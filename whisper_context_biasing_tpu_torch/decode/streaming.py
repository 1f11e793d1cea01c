"""Incremental (streaming) transcription.

The counterpart of the JAX package's ``decode/streaming.py``: the batch-1
incremental twin of ``transcribe_long_batch``. Audio arrives in chunks of
any size; whenever a whole window is buffered it decodes with the same
rules (history conditioning through ``<|startofprev|>``, the temperature
ladder, the no-speech rule, timestamp-conditioned seeking: a trailing open
segment stays in the buffer and decodes again, whole, once more audio has
come). ``finish()`` flushes the tail. Fed in any chunking, a stream gives
the tokens ``transcribe_long_batch`` gives for the same audio and decode
function.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..audio.mel import N_SAMPLES, SAMPLE_RATE
from .greedy import greedy_decode, pack_prefixes
from .speculative import t0_verified_decode
from .long_form import (
    DEFAULT_TEMPERATURES,
    MAX_PROMPT_TOKENS,
    _content_tokens,
    _np,
    compression_ratio,
    sample_best_of,
    timestamp_seek,
    window_quality_ok,
)


class StreamingTranscriber:
    """One audio stream -> incremental tokens and segments.

    ``feed(samples)`` buffers 16 kHz float32 audio and decodes every whole
    window, returning the segments it closed ``(abs_start_s, abs_end_s |
    None, text)``; ``finish()`` decodes the remaining tail and returns the
    last new segments. ``tokens``, ``segments``, ``words`` and ``text`` hold
    everything emitted so far. Sampling draws from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when None)."""

    def __init__(
        self,
        model,
        tokenizer,
        *,
        mel_fn=None,
        max_new: int = 224,
        context: list[int] | None = None,
        bias_spans: np.ndarray | None = None,   # (1, N, K)
        bias_boost: float = 0.0,
        condition_on_previous: bool = True,
        use_timestamps: bool = True,
        temperatures: tuple = DEFAULT_TEMPERATURES,
        best_of: int = 1,             # > 1: a sampled rung keeps the best of n
        prompt_reset_on_temperature: float | None = 0.5,
        compression_ratio_threshold: float | None = 2.4,
        logprob_threshold: float | None = -1.0,
        no_speech_threshold: float | None = 0.6,
        start_tokens: list[int] | None = None,
        language: str | None = None,   # a code, or "auto" (multilingual models)
        task: str = "transcribe",      # "translate" implies detection
        word_timestamps: bool = False,  # each window's words, absolute time
        alignment_heads: list[tuple[int, int]] | None = None,
        window_samples: int = N_SAMPLES,
        vad: bool | dict = False,     # buffered windows with no detected speech
                                      # are consumed without decoding
        prefix_pad_to_multiple: int | None = 32,
        decode_fn=None,
        generator: torch.Generator | None = None,
        draft: tuple | None = None,
        medusa: dict | None = None,
        device="cuda",
    ):
        self.tokenizer = tokenizer
        self.context = list(context) if context else []
        self.condition_on_previous = condition_on_previous
        self.use_timestamps = use_timestamps
        self.temperatures = tuple(temperatures) or (0.0,)
        self.best_of = int(best_of)
        self.prompt_reset_on_temperature = prompt_reset_on_temperature
        self._last_temp = 0.0  # the rung of the latest emitted row
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self._model = model
        self.device = resolve_device(device)
        self.language = None
        self._pending_lang = False
        self._task = task
        if start_tokens:
            self.start = list(start_tokens)
        else:
            from .language import resolve_start_tokens

            if language in (None, "auto") and (language == "auto" or task == "translate"):
                # check the model is multilingual now; detect on the first window
                resolve_start_tokens(tokenizer, 1, language, task, detect=lambda: [("en", 1.0)])
                self.start = [tokenizer.sot]
                self._pending_lang = True
            else:
                starts, langs = resolve_start_tokens(tokenizer, 1, language, task)
                self.start = starts[0] if starts else [tokenizer.sot]
                self.language = langs[0]
        self.window_samples = int(window_samples)
        if isinstance(vad, (list, tuple)) and len(vad) == 0:
            vad = False  # no ranges: no gating
        if isinstance(vad, (list, tuple)):
            raise ValueError(
                "clip ranges (vad=[(start_s, end_s), ...]) are not meaningful for a streaming "
                "session: windows are gated in stream time as they arrive; use vad=True or a "
                "speech_segments() option dict")
        self.vad = vad
        self.prefix_pad_to_multiple = prefix_pad_to_multiple
        if generator is None and any(t > 0 for t in self.temperatures):
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

        if mel_fn is None:
            from ..audio.mel import select_mel_frontend

            frontend, n_mels = select_mel_frontend(), model.cfg.n_mels
            mel_fn = lambda a: frontend(  # noqa: E731
                torch.as_tensor(a, dtype=torch.float32, device=self.device), n_mels=n_mels)
        self.mel_fn = mel_fn
        if decode_fn is None:
            outer = self
            # the draft is unreachable when Medusa is set (Medusa wins)
            if medusa is None and draft is not None and draft[1].n_mels != model.cfg.n_mels:
                raise ValueError("streaming speculative decoding needs a draft with the "
                                 "target's n_mels")

            def decode_fn(mel, ids, mask, temperature, gen):
                ns_id = tokenizer.no_speech if no_speech_threshold is not None else None
                if temperature == 0.0 and (medusa is not None or draft is not None):
                    return t0_verified_decode(
                        model, tokenizer, mel, ids, mask, max_new=max_new, spans=bias_spans,
                        bias_boost=bias_boost, no_speech_id=ns_id, sot_offset=len(outer.start),
                        medusa=medusa, draft=draft, device=outer.device)
                return greedy_decode(
                    model, mel, ids, mask, max_new=max_new, eot_id=tokenizer.eot,
                    bias_spans=bias_spans, bias_boost=bias_boost, span_pad_id=tokenizer.eot,
                    temperature=temperature, generator=gen, no_speech_id=ns_id,
                    # read at call time: detection may rewrite the start
                    sot_offset=len(outer.start),
                    # the timestamp rules on plain greedy only, as on the
                    # batch long-form routes
                    timestamp_begin=(tokenizer.timestamp_begin if use_timestamps
                                     and medusa is None and draft is None else None),
                    device=outer.device)

        self.decode_fn = decode_fn

        self.word_timestamps = word_timestamps
        self.alignment_heads = alignment_heads
        self._max_new = max_new
        self._buffer = np.zeros(0, np.float32)
        self._chunks: list[np.ndarray] = []   # fed, not yet concatenated
        self._pending = 0                     # samples in _chunks
        self._consumed = 0          # samples already seeked past
        self._started = False       # a stream with no audio still gets a window
        self._history: list[int] = []
        self.tokens: list[int] = []
        self.segments: list[tuple[float, float | None, str]] = []
        self.words: list = []       # WordTiming in absolute stream time
        self.window_info: list[dict] = []  # per decoded window: start_s,
                                    # temperature, avg_logprob, no_speech_prob,
                                    # compression_ratio, accepted
        self._finished = False

    # -- internals --------------------------------------------------------

    def _decode_window(self, chunk: np.ndarray, window_audio_len: int):
        """One window through the ladder: (kept tokens, samples to advance,
        the window's audio length)."""
        tok = self.tokenizer
        mel = self.mel_fn(chunk[None])
        self._last_mel = mel  # for the word alignment
        if self._pending_lang:
            # the first decoded window fixes the stream's language and task
            from .language import detect_language, resolve_start_tokens

            det = detect_language(self._model, tok, mel)
            starts, langs = resolve_start_tokens(tok, 1, "auto", self._task, detect=lambda: det)
            self.start = starts[0]
            self.language = langs[0]
            self._pending_lang = False
        ctx: list[int] = list(self.context)
        if self.condition_on_previous and self._history:
            room = MAX_PROMPT_TOKENS - len(ctx)
            if room > 0:
                ctx.extend(self._history[-room:])
        prefix = ([tok.sop] + ctx + self.start) if ctx else list(self.start)
        ids, mask = pack_prefixes([prefix], tok.eot, pad_to_multiple=self.prefix_pad_to_multiple)

        accepted = None
        last: list[int] = []
        last_avg_lp = None
        nsp = None
        for ti, temperature in enumerate(self.temperatures):
            if temperature > 0 and self.best_of > 1:
                res = sample_best_of(lambda t, g: self.decode_fn(mel, ids, mask, t, g),
                                     temperature, self.generator, self.best_of)
            else:
                res = self.decode_fn(mel, ids, mask, temperature, self.generator)
            row = _np(res.tokens)[0, : int(_np(res.lengths)[0])].tolist()
            last = row
            self._last_temp = float(temperature)
            slp = _np(res.sum_logprob)
            avg_lp = None if slp is None else float(slp[0]) / (len(row) + 1)
            last_avg_lp = avg_lp
            if ti == 0 and self.no_speech_threshold is not None and res.no_speech_prob is not None:
                nsp = float(_np(res.no_speech_prob)[0])
            text = tok.decode(row, skip_special_tokens=True)
            if window_quality_ok(text, avg_lp,
                                 compression_ratio_threshold=self.compression_ratio_threshold
                                 or 0.0, logprob_threshold=self.logprob_threshold):
                accepted = row
                break
        ladder_ok = accepted is not None  # before the silence rule
        # the ratio the ladder gated on: the final rung's whole row
        ladder_cr = round(compression_ratio(tok.decode(
            accepted if accepted is not None else last, skip_special_tokens=True)), 3)
        # OpenAI's silence rule, after the ladder
        if nsp is not None and nsp > self.no_speech_threshold:
            if not (self.logprob_threshold is not None and last_avg_lp is not None
                    and last_avg_lp > self.logprob_threshold):
                accepted = []  # silence: emit nothing, advance a window
        row = accepted if accepted is not None else last

        advance = self.window_samples
        if self.use_timestamps:
            kept, adv_s = timestamp_seek(row, tok)
            if adv_s is not None:
                advance = max(int(adv_s * SAMPLE_RATE), self.window_samples // 100)
                row = kept
        self.window_info.append({
            "start_s": round(self._consumed / SAMPLE_RATE, 3),
            "temperature": self._last_temp,
            "avg_logprob": last_avg_lp,
            "no_speech_prob": nsp,
            "compression_ratio": ladder_cr,
            "accepted": ladder_ok,
        })
        return row, advance, window_audio_len

    def _emit(self, row: list[int], span_samples: int):
        tok = self.tokenizer
        offset = self._consumed / SAMPLE_RATE
        new_segments: list[tuple[float, float | None, str]] = []
        if self.use_timestamps:
            for a, e, text in tok.split_timestamp_segments(row):
                new_segments.append((offset + a, None if e is None else offset + e, text))
        else:
            text = tok.decode(row, skip_special_tokens=True)
            if text.strip():
                new_segments.append((offset, offset + span_samples / SAMPLE_RATE, text))
        self.segments.extend(new_segments)
        self.tokens.extend(row)
        if (self.prompt_reset_on_temperature is not None
                and self._last_temp > self.prompt_reset_on_temperature):
            self._history = []  # a hot rung's text stays out of later prompts
        else:
            self._history = (self._history + _content_tokens(row, tok))[-MAX_PROMPT_TOKENS:]
        return new_segments

    def _drain(self, *, flush: bool) -> list:
        """Decode buffered windows. Without ``flush`` only whole windows (a
        short tail waits for more audio); with ``flush`` as the batch seek
        loop does: the zero-padded tail decodes until consumed, and a stream
        that never had audio still decodes one silent window."""
        out = []
        while True:
            avail = len(self._buffer) + self._pending
            if not flush and avail < self.window_samples:
                break
            if flush and avail == 0 and self._started:
                break
            if self._chunks:
                # one concatenate per consumed window, not per fed chunk
                self._buffer = np.concatenate([self._buffer] + self._chunks)
                self._chunks, self._pending = [], 0
            chunk = self._buffer[: self.window_samples]
            window_audio_len = len(chunk)
            if self.vad is not None and self.vad is not False:  # {} = defaults
                from ..audio.vad import resolve_vad

                if not resolve_vad(self.vad, chunk):
                    # no speech in this window: consumed without device work
                    self._buffer = self._buffer[self.window_samples:]
                    self._consumed += self.window_samples
                    self._started = True
                    continue
            if len(chunk) < self.window_samples:
                chunk = np.pad(chunk, (0, self.window_samples - len(chunk)))
            row, advance, span = self._decode_window(chunk, window_audio_len)
            if self.word_timestamps and row:
                from .word_timestamps import find_word_timestamps

                ws = find_word_timestamps(
                    self._model, self.tokenizer, self._last_mel, [row], starts=[self.start],
                    num_frames=[max(2, window_audio_len // 320)],
                    alignment_heads=self.alignment_heads, pad_to=self._max_new + 8)[0]
                offset = self._consumed / SAMPLE_RATE
                for w in ws:
                    w.start = round(w.start + offset, 3)
                    w.end = round(w.end + offset, 3)
                self.words.extend(ws)
            out.extend(self._emit(row, span))
            self._buffer = self._buffer[advance:]
            self._consumed += advance
            self._started = True
        return out

    # -- public surface ---------------------------------------------------

    def feed(self, samples) -> list[tuple[float, float | None, str]]:
        """Buffer more audio and decode any whole windows; returns the newly
        emitted segments in absolute stream time."""
        if self._finished:
            raise RuntimeError("stream already finished")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._chunks.append(samples)
        self._pending += len(samples)
        return self._drain(flush=False)

    def finish(self) -> list[tuple[float, float | None, str]]:
        """Decode the buffered tail (zero-padded to a window) and close the
        stream."""
        if self._finished:
            return []
        self._finished = True
        return self._drain(flush=True)

    @property
    def buffered_samples(self) -> int:
        return len(self._buffer) + self._pending

    @property
    def text(self) -> str:
        return self.tokenizer.decode(self.tokens, skip_special_tokens=True).strip()
