"""Long-form (> one window) transcription: sequential windows with seeking.

The counterpart of the JAX package's ``decode/long_form.py``: Whisper-style
sequential decoding with the robustness rules of OpenAI's long-form loop.

  * history conditioning: each window is conditioned on the previous
    windows' text (at most ``MAX_PROMPT_TOKENS``) through the same
    ``<|startofprev|>`` prompt the bias contexts use;
  * timestamp-conditioned seeking (``use_timestamps=True``): the window
    advances to the last timestamp, and the trailing partial segment is
    decoded again, whole, in the next window;
  * the temperature ladder: a window whose text is degenerate (zlib
    compression ratio over ``compression_ratio_threshold``) or
    low-confidence (average logprob under ``logprob_threshold``) is decoded
    again at the next temperature, with ``best_of`` samples a sampled rung;
  * the no-speech rule, the energy VAD gate (``audio/vad.py``) and clip
    ranges; beam search at the t=0 rung (``num_beams``); word timestamps
    (``decode/word_timestamps.py``), one alignment pass a window iteration.

The current windows of all files decode together as one batch; per-file
histories ride the left-padded prefixes. Sampling draws from one
``torch.Generator`` on the decode device (JAX splits one PRNG key): each
decode call draws its seed from it. Under a mesh each window call's file
batch shards over "data" and the ladder decides on the gathered result.
"""

from __future__ import annotations

import zlib
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..audio.mel import N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram_np
from ..models.whisper import Whisper
from .greedy import GreedyResult, greedy_decode, pack_prefixes
from .speculative import t0_verified_decode

MAX_PROMPT_TOKENS = 190  # the reference's desc-prompt truncation bound
DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def _np(x):
    """A result field as a numpy array (tensors come back from the device)."""
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def unpack_long_form(out, *, return_segments: bool = False, word_timestamps: bool = False,
                     return_window_info: bool = False):
    """Normalize ``transcribe_long_batch``'s flag-dependent return
    ``(outputs[, segments[, words]][, window_info])`` (bare ``outputs`` when
    no flag is set) into a fixed 4-tuple ``(outputs, segments, words,
    window_info)`` with ``None`` for what the flags did not ask for. Call
    with the flags the transcribe call used."""
    if not isinstance(out, tuple):
        return out, None, None, None
    parts = list(out)
    winfo = parts.pop() if return_window_info else None
    hyps = parts[0]
    segs = parts[1] if return_segments else None
    words = parts[2] if (return_segments and word_timestamps) else None
    return hyps, segs, words, winfo


def split_windows(audio: np.ndarray, window: int = N_SAMPLES) -> list[np.ndarray]:
    """Non-overlapping fixed windows; the tail is zero-padded."""
    audio = np.asarray(audio, dtype=np.float32)
    n = max(1, int(np.ceil(len(audio) / window)))
    out = []
    for i in range(n):
        chunk = audio[i * window: (i + 1) * window]
        if len(chunk) < window:
            chunk = np.pad(chunk, (0, window - len(chunk)))
        out.append(chunk)
    return out


def compression_ratio(text: str) -> float:
    """bytes(text) / bytes(zlib(text)): degenerate repetition compresses far
    better than natural language (the public Whisper repetition heuristic)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def window_quality_ok(text: str, avg_logprob: float | None, *,
                      compression_ratio_threshold: float = 2.4,
                      logprob_threshold: float | None = -1.0) -> bool:
    """Accept a decoded window unless it looks like a repetition loop or is
    uniformly low-confidence."""
    if compression_ratio_threshold and compression_ratio(text) > compression_ratio_threshold:
        return False
    if (logprob_threshold is not None and avg_logprob is not None
            and avg_logprob < logprob_threshold):
        return False
    return True


def timestamp_seek(tokens: list[int], tokenizer) -> tuple[list[int], float | None]:
    """Timestamp-conditioned window advance: ``(kept_tokens,
    advance_seconds)``, the tokens up to and including the last timestamp
    (the trailing partial segment is dropped, so the next window decodes it
    whole) and the seconds to advance by (None: no usable timestamp, advance
    a full window)."""
    last_idx = -1
    last_val = 0.0
    for i, t in enumerate(tokens):
        v = tokenizer.timestamp_value(int(t))
        if v is not None:
            last_idx, last_val = i, v
    if last_idx < 0 or last_val <= 0.0:
        return tokens, None
    return tokens[: last_idx + 1], last_val


def _best_beam_as_greedy(res, length_penalty: float, early_stopping: str = "off") -> GreedyResult:
    """A BeamResult on the ladder's GreedyResult contract: the best beam's
    tokens, length and score per row (chosen by the decoder's own rule for
    the mode, so it matches ``res.best``) and the no-speech probability. In
    the HF modes ``scores`` are already length-penalized."""
    toks, scores, lens = _np(res.tokens), _np(res.scores), _np(res.lengths)
    if early_stopping == "off":
        penal = scores / np.maximum(lens, 1).astype(np.float32) ** length_penalty
        sum_lp = scores
    else:
        penal = scores  # pool scores: penalized at insertion
        sum_lp = scores * np.maximum(lens, 1).astype(np.float32) ** length_penalty
    bi = penal.argmax(axis=1)
    rows = np.arange(toks.shape[0])
    return GreedyResult(toks[rows, bi], lens[rows, bi], sum_lp[rows, bi],
                        _np(res.no_speech_prob))


def _mel_rows(mel, rows: list[int]):
    """Rows ``rows`` of a batch mel (a tensor, or numpy from an injected
    ``mel_fn``)."""
    if isinstance(mel, torch.Tensor):
        return mel[torch.as_tensor(rows, device=mel.device)]
    return np.asarray(mel)[rows]


def window_frames(n_samples: int, start: int, window_samples: int) -> int:
    """Encoder frames the audio covers in the window at ``start`` (at least
    2): the alignment's clamp, as the JAX surfaces compute it."""
    return max(2, min(window_samples, max(n_samples - start, 0)) // 320)


def _content_tokens(tokens: list[int], tokenizer) -> list[int]:
    """Strip specials and timestamp tokens (prompt/history hygiene)."""
    return [t for t in tokens if not tokenizer.is_special(t) and t < tokenizer.timestamp_begin]


def sample_best_of(call, temperature: float, generator, n: int) -> GreedyResult:
    """OpenAI's ``best_of`` rule for a sampled rung: ``n`` samples of the
    whole batch, one after another from one generator (each call draws its
    own seed from it, so every rank of a mesh draws the same ones), keeping
    per row the candidate with the highest average token logprob
    (``sum/(len+1)``, the ladder's ranking). ``call(temperature, generator) -> GreedyResult`` must
    fill ``sum_logprob``; without it every sample ties at zero and the first
    one wins."""
    best: list | None = None
    for _ in range(max(1, n)):
        res = call(temperature, generator)
        toks, lens = _np(res.tokens), _np(res.lengths)
        slp = (_np(res.sum_logprob).astype(np.float32) if res.sum_logprob is not None
               else np.zeros(len(lens), np.float32))
        avg = slp / (lens + 1)
        if best is None:
            best = [toks.copy(), lens.copy(), slp.copy(), avg, _np(res.no_speech_prob)]
            continue
        if toks.shape[1] != best[0].shape[1]:
            # an injected decode_fn may size the token axis per call: pad both
            # to the wider (rows are read as toks[i, :lens[i]])
            w = max(toks.shape[1], best[0].shape[1])
            toks = np.pad(toks, ((0, 0), (0, w - toks.shape[1])))
            best[0] = np.pad(best[0], ((0, 0), (0, w - best[0].shape[1])))
        better = avg > best[3]
        if better.any():
            best[0][better] = toks[better]
            best[1][better] = lens[better]
            best[2][better] = slp[better]
            best[3][better] = avg[better]
    return GreedyResult(best[0], best[1], best[2], best[4])


def transcribe_long_batch(
    model: Whisper,
    tokenizer,
    audios: list[np.ndarray],
    *,
    mel_fn=None,
    max_new: int = 224,
    condition_on_previous: bool = True,
    prompt_reset_on_temperature: float | None = 0.5,  # a window from a rung
                                 # hotter than this clears the file's history
                                 # prompt; None disables
    contexts: list[list[int]] | None = None,   # static per-file context
    bias_spans: np.ndarray | None = None,       # (B, N, K) per file
    bias_boost: float = 0.0,
    use_timestamps: bool = False,
    temperatures: tuple[float, ...] = DEFAULT_TEMPERATURES,
    best_of: int = 1,            # > 1: each sampled rung keeps the best of n
    compression_ratio_threshold: float | None = 2.4,
    logprob_threshold: float | None = -1.0,
    no_speech_threshold: float | None = 0.6,
    decode_fn: Callable[..., GreedyResult] | None = None,
    generator: torch.Generator | None = None,  # on the decode device
    prefix_pad_to_multiple: int | None = None,
    return_segments: bool = False,
    return_window_info: bool = False,  # per-window QC dicts as the LAST
                                       # return element
    word_timestamps: bool = False,
    alignment_heads: list[tuple[int, int]] | None = None,
    start_tokens: list[list[int]] | None = None,  # per-file decode starts
    window_samples: int = N_SAMPLES,
    vad: bool | dict | list = False,  # energy VAD gate, or clip ranges
    draft: tuple | None = None,
    medusa: dict | None = None,
    num_beams: int = 1,          # > 1: beam search drives the t=0 rung
    length_penalty: float = 1.0,
    beam_early_stopping: str = "off",
    mesh=None,
    device="cuda",
) -> list[list[int]]:
    """Per-file token lists, concatenated over windows (timestamp tokens kept
    with ``use_timestamps``, for ``tokenizer.split_timestamp_segments``).

    ``return_segments=True`` returns ``(tokens, segments)``: per file a list
    of ``(start_s, end_s | None, text)`` in absolute file time; without
    timestamps each window is one segment spanning its audio.
    ``return_window_info=True`` appends per-window dicts: start_s,
    temperature, avg_logprob, no_speech_prob, compression_ratio, accepted
    (the ladder's verdict).

    ``no_speech_threshold``: a window whose ``P(<|nospeech|>)`` exceeds it
    and whose avg logprob is below ``logprob_threshold`` emits nothing and
    the seek advances a full window. ``vad=True`` (or a dict of
    ``speech_segments`` options) skips windows with no detected speech on the
    host and seeks to the next onset; a list of ``(start_s, end_s)`` ranges
    decodes only those ranges.

    ``decode_fn(mel, ids, mask, temperature, generator) -> GreedyResult`` can
    be injected; the default runs ``greedy_decode`` (``beam_decode`` at the
    t=0 rung when ``num_beams > 1``) with this call's bias arguments on
    ``device``. ``prefix_pad_to_multiple`` buckets the history-prompt length.

    ``word_timestamps=True`` with ``return_segments`` returns ``(tokens,
    segments, words)``: each window iteration's emitted rows align in one
    batched pass (``find_word_timestamps``), word times in absolute file time.

    ``medusa`` (a head dict) or ``draft`` (``(draft model, its config, k)``,
    the draft with the target's ``n_mels``: ``mel_fn`` is shared) drives the
    t=0 rung through ``t0_verified_decode`` (Medusa wins), with the same
    tokens as plain greedy; the timestamp rules are then off on every rung,
    as in JAX.

    ``mesh``: each window call's file batch shards over "data" (with its
    bias spans and per-row sot offsets; ``model`` and a draft are this
    rank's shards, ``parallel.shard_params``) and every rank gets the whole
    result, so every rank takes the ladder's decisions (quality, silence,
    seeks, the next prompts) on the same numbers and makes the same calls.
    Sampled rungs draw each row's uniforms by its index in the batch
    (``greedy.RowDraws``): the same tokens as without the mesh."""
    device = resolve_device(device)
    if mel_fn is None:
        n_mels = model.cfg.n_mels
        mel_fn = lambda a: np.stack([log_mel_spectrogram_np(x, n_mels) for x in a])  # noqa: E731
    if decode_fn is None:
        # per-row <|sot|> offsets: start sequences may differ per file
        sot_off = [len(st) for st in start_tokens] if start_tokens else 1
        ns_id = tokenizer.no_speech if no_speech_threshold is not None else None
        if draft is not None and draft[1].n_mels != model.cfg.n_mels:
            raise ValueError("long-form speculative decoding needs a draft with the target's "
                             "n_mels (mel_fn is shared)")
        # the timestamp rules stay off when Medusa or a draft drives t=0, so
        # the verified-equals-greedy contract holds on every rung
        ts_begin = (tokenizer.timestamp_begin
                    if use_timestamps and medusa is None and draft is None else None)

        def decode_fn(mel, ids, mask, temperature, gen):
            if num_beams > 1 and temperature == 0.0:
                from .beam import beam_decode

                res = beam_decode(
                    model, mel, ids, mask, num_beams=num_beams, max_new=max_new,
                    eot_id=tokenizer.eot, bias_spans=bias_spans, bias_boost=bias_boost,
                    span_pad_id=tokenizer.eot, length_penalty=length_penalty,
                    early_stopping=beam_early_stopping, no_speech_id=ns_id,
                    sot_offset=sot_off, timestamp_begin=ts_begin, device=device, mesh=mesh)
                return _best_beam_as_greedy(res, length_penalty, beam_early_stopping)
            if temperature == 0.0 and (medusa is not None or draft is not None):
                return t0_verified_decode(
                    model, tokenizer, mel, ids, mask, max_new=max_new, spans=bias_spans,
                    bias_boost=bias_boost, no_speech_id=ns_id, sot_offset=sot_off,
                    medusa=medusa, draft=draft, device=device, mesh=mesh)
            return greedy_decode(
                model, mel, ids, mask, max_new=max_new, eot_id=tokenizer.eot,
                bias_spans=bias_spans, bias_boost=bias_boost, span_pad_id=tokenizer.eot,
                temperature=temperature, generator=gen, no_speech_id=ns_id,
                sot_offset=sot_off, timestamp_begin=ts_begin, device=device, mesh=mesh)
    # the words are reachable only through (tokens, segments, words)
    word_timestamps = word_timestamps and return_segments
    if not temperatures:
        temperatures = (0.0,)
    if generator is None and any(t > 0 for t in temperatures):
        generator = torch.Generator(device=device).manual_seed(0)

    b = len(audios)
    audios = [np.asarray(a, np.float32) for a in audios]
    vad_segs = None
    if vad is not None and vad is not False:  # NB: vad={} means defaults
        from ..audio.vad import has_speech, next_onset, resolve_vad, vad_overlap_tol

        vad_segs = [resolve_vad(vad, a) for a in audios]
        if all(s is None for s in vad_segs):  # e.g. vad=[]: no gating
            vad_segs = None
        # pad-only overlap is not speech (clamped to a quarter window)
        vad_tol = min(vad_overlap_tol(vad), window_samples // 4)
    seek = [0] * b                      # sample offset of each file's window
    started = [False] * b               # zero-length audio still gets 1 window
    histories: list[list[int]] = [[] for _ in range(b)]
    outputs: list[list[int]] = [[] for _ in range(b)]
    segments: list[list[tuple[float, float | None, str]]] = [[] for _ in range(b)]
    words: list[list] = [[] for _ in range(b)]
    window_info: list[list[dict]] = [[] for _ in range(b)]

    def active(i):
        return not started[i] or seek[i] < len(audios[i])

    while any(active(i) for i in range(b)):
        if vad_segs is not None:
            # a window with no detected speech never reaches the device; the
            # seek jumps to the next speech onset (or the end of the file)
            for i in range(b):
                if active(i) and not has_speech(vad_segs[i], seek[i], seek[i] + window_samples,
                                                tol=vad_tol):
                    onset = next_onset(vad_segs[i], seek[i], tol=vad_tol)
                    started[i] = True
                    seek[i] = len(audios[i]) if onset is None else onset
            if not any(active(i) for i in range(b)):
                break
        chunk = np.zeros((b, window_samples), np.float32)
        for i in range(b):
            if active(i):
                part = audios[i][seek[i]: seek[i] + window_samples]
                chunk[i, : len(part)] = part
        mel = mel_fn(chunk)

        prefixes = []
        for i in range(b):
            ctx: list[int] = []
            if contexts is not None and contexts[i]:
                ctx.extend(contexts[i])
            if condition_on_previous and histories[i]:
                room = MAX_PROMPT_TOKENS - len(ctx)
                if room > 0:
                    ctx.extend(histories[i][-room:])
            start = list(start_tokens[i]) if start_tokens else [tokenizer.sot]
            prefixes.append([tokenizer.sop] + ctx + start if ctx else start)
        ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=prefix_pad_to_multiple)

        # the ladder: the first acceptable decode per row wins; rows that fail
        # every rung keep the last (hottest) one
        accepted: list[list[int] | None] = [None] * b
        last: list[list[int]] = [[] for _ in range(b)]
        last_avg_lp: list[float | None] = [None] * b
        last_temp: list[float] = [0.0] * b  # rung that produced each row
        nsp = None
        for ti, temperature in enumerate(temperatures):
            if temperature > 0 and best_of > 1:
                res = sample_best_of(lambda t, g: decode_fn(mel, ids, mask, t, g),
                                     temperature, generator, best_of)
            else:
                res = decode_fn(mel, ids, mask, temperature, generator)
            toks, lens = _np(res.tokens), _np(res.lengths)
            slp = _np(res.sum_logprob)
            if ti == 0 and no_speech_threshold is not None and res.no_speech_prob is not None:
                nsp = _np(res.no_speech_prob)  # from the prefill: the same at every rung
            pending = False
            for i in range(b):
                if not active(i) or accepted[i] is not None:
                    continue
                row = toks[i, : lens[i]].tolist()
                last[i] = row
                last_temp[i] = float(temperature)
                avg_lp = None if slp is None else float(slp[i]) / (int(lens[i]) + 1)
                last_avg_lp[i] = avg_lp
                text = tokenizer.decode(row, skip_special_tokens=True)
                if window_quality_ok(text, avg_lp,
                                     compression_ratio_threshold=compression_ratio_threshold or 0.0,
                                     logprob_threshold=logprob_threshold):
                    accepted[i] = row
                else:
                    pending = True
            if not pending:
                break

        # window_info reports the ladder's verdict and the compression ratio it
        # gated on: the final rung's full row, before the silence rule empties
        # it and before timestamp_seek trims the trailing segment
        ladder_ok = [accepted[i] is not None for i in range(b)]
        ladder_cr = (
            [round(compression_ratio(tokenizer.decode(
                accepted[i] if accepted[i] is not None else last[i],
                skip_special_tokens=True)), 3) for i in range(b)]
            if return_window_info else None)

        # OpenAI's silence rule, after the ladder: a high P(<|nospeech|>) drops
        # the window unless the (possibly retried) decode ended up confident
        if nsp is not None:
            for i in range(b):
                if not active(i) or nsp[i] <= no_speech_threshold:
                    continue
                if not (logprob_threshold is not None and last_avg_lp[i] is not None
                        and last_avg_lp[i] > logprob_threshold):
                    accepted[i] = []  # emit nothing, advance a full window

        kept_rows: dict[int, list[int]] = {}
        advances: dict[int, int] = {}
        for i in range(b):
            if not active(i):
                continue
            row = accepted[i] if accepted[i] is not None else last[i]
            advance = window_samples
            if use_timestamps:
                kept, adv_s = timestamp_seek(row, tokenizer)
                if adv_s is not None:
                    # never stall: a sub-frame advance would re-decode forever
                    advance = max(int(adv_s * SAMPLE_RATE), window_samples // 100)
                    row = kept
            kept_rows[i], advances[i] = row, advance

        if word_timestamps:
            # one batched alignment pass over this iteration's emitted rows
            from .word_timestamps import find_word_timestamps

            act = [i for i in kept_rows if kept_rows[i]]
            if act:
                timings = find_word_timestamps(
                    model, tokenizer, _mel_rows(mel, act), [kept_rows[i] for i in act],
                    starts=[start_tokens[i] for i in act] if start_tokens else None,
                    num_frames=[window_frames(len(audios[i]), seek[i], window_samples)
                                for i in act],
                    alignment_heads=alignment_heads, pad_to=max_new + 8)
                for i, ws in zip(act, timings):
                    offset = seek[i] / SAMPLE_RATE
                    for w in ws:
                        w.start = round(w.start + offset, 3)
                        w.end = round(w.end + offset, 3)
                    words[i].extend(ws)

        for i, row in kept_rows.items():
            if return_window_info:
                window_info[i].append({
                    "start_s": round(seek[i] / SAMPLE_RATE, 3),
                    "temperature": last_temp[i],
                    "avg_logprob": last_avg_lp[i],
                    "no_speech_prob": float(nsp[i]) if nsp is not None else None,
                    "compression_ratio": ladder_cr[i],
                    "accepted": ladder_ok[i],
                })
            if return_segments:
                offset = seek[i] / SAMPLE_RATE
                if use_timestamps:
                    for a, e, text in tokenizer.split_timestamp_segments(row):
                        segments[i].append((offset + a, None if e is None else offset + e, text))
                else:
                    span = min(window_samples, max(len(audios[i]) - seek[i], 0))
                    text = tokenizer.decode(row, skip_special_tokens=True)
                    if text.strip():
                        segments[i].append((offset, offset + span / SAMPLE_RATE, text))
            started[i] = True
            seek[i] += advances[i]
            if prompt_reset_on_temperature is not None and last_temp[i] > prompt_reset_on_temperature:
                # a hot rung made this window: keep its text out of later prompts
                histories[i] = []
            else:
                histories[i] = (histories[i] + _content_tokens(row, tokenizer))[-MAX_PROMPT_TOKENS:]
            outputs[i].extend(row)
    out: tuple = (outputs,)
    if return_segments:
        out += (segments,)
        if word_timestamps:
            out += (words,)
    if return_window_info:
        out += (window_info,)
    return out if len(out) > 1 else outputs


def transcribe_long(model: Whisper, tokenizer, audio: np.ndarray, **kwargs) -> str:
    """Single-file convenience: audio of any length -> text."""
    toks = transcribe_long_batch(model, tokenizer, [audio], **kwargs)
    toks = unpack_long_form(toks, return_segments=kwargs.get("return_segments", False),
                            return_window_info=kwargs.get("return_window_info", False))[0][0]
    return tokenizer.decode(toks, skip_special_tokens=True)
