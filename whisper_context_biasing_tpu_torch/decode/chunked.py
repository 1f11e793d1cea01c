"""Chunked long-form transcription: all windows of a file decode in one
batch, the throughput alternative to the sequential seek loop.

The counterpart of the JAX package's ``decode/chunked.py``. Windows overlap
by a stride and decode independently, so every window of every file lands
in a few large decode batches; the overlaps settle boundary artifacts when
the windows merge:

  * timestamp mode (the default): a segment belongs to the window in whose
    core (the part no neighbour's core covers) its absolute start falls, so
    each segment is emitted once;
  * token mode (``use_timestamps=False``): consecutive windows' tokens merge
    by a sliding longest-common-sequence alignment over the overlap.

The sequential loop's per-window rules stay batched: the temperature ladder
decodes again only the windows that failed (all of them in one call a rung),
and the no-speech rule drops silent windows. Bias spans, contexts and start
tokens apply to every window of their file.

Each call uploads the audio once, as one flat buffer with a window of zeros
after each file, and gathers every batch's windows from it on the device
(int16 PCM is normalised there, ``/ 32768``); the batch's windows then go
through ``mel_fn`` (the mel kernel on a card) and the ladder of
``greedy_decode`` calls, each of which encodes the batch (the flash kernel)
and decodes it (the int8 cross-attention kernel a step).
``device_windows=False`` is the JAX package's host path: each batch's
windows are cut in numpy and uploaded, then go through the same ``mel_fn``,
for the same tokens.

Under a (data, model) mesh every batch is padded with silent rows to a
multiple of "data", and each rank cuts (or gathers) and turns into mel only
its own share of the windows, so its mel kernel and encoder run on
B / "data" windows; the decode gathers every row's tokens on every rank
(``parallel.LocalRows``), and the ladder decides on them.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..audio.io import pcm_to_float32
from ..audio.mel import N_SAMPLES, SAMPLE_RATE, select_mel_frontend
from ..models.whisper import Whisper
from ..parallel.mesh import DATA_AXIS, axis_index, axis_size
from ..parallel.sharding import LocalRows, gather_rows
from .greedy import greedy_decode, pack_prefixes
from .speculative import t0_verified_decode
from .long_form import (
    DEFAULT_TEMPERATURES,
    MAX_PROMPT_TOKENS,
    _best_beam_as_greedy,
    _mel_rows,
    _np,
    compression_ratio,
    sample_best_of,
    window_frames,
    window_quality_ok,
)


def _flat_audio_buffer(audios: list[np.ndarray], window_samples: int, device
                       ) -> tuple[torch.Tensor, list[int], int]:
    """The files concatenated with ``window_samples`` of zeros after each, on
    ``device`` in one copy: (buffer, each file's base offset, the offset of a
    window of zeros for batch-padding rows). int16 stays int16."""
    parts, base, off = [], [], 0
    pad = np.zeros(window_samples, audios[0].dtype)
    for a in audios:
        base.append(off)
        parts += [a, pad]
        off += len(a) + window_samples
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    return buf, base, base[-1] + len(audios[-1])


def _gather_windows(buf: torch.Tensor, starts: list[int], window: int) -> torch.Tensor:
    """(nb,) start offsets into the flat buffer -> (nb, window) f32 windows,
    int16 PCM normalised by the ingest rule (i16 / 32768)."""
    idx = (torch.as_tensor(starts, dtype=torch.int64, device=buf.device)[:, None]
           + torch.arange(window, device=buf.device)[None, :])
    out = buf[idx]
    if out.dtype == torch.int16:
        out = out.to(torch.float32) * (1.0 / 32768.0)
    return out


def chunk_layout(n_samples: int, window_samples: int = N_SAMPLES,
                 stride_samples: int | None = None) -> list[tuple[int, int, int]]:
    """Overlapping windows ``[(start, core_start, core_end), ...]``: windows
    advance by ``window - 2*stride``; each owns the core ``[start+stride,
    start+window-stride)``, the first from 0 and the last to the end. The
    cores tile ``[0, n)`` exactly, and each interior core boundary is at
    least ``stride`` from its window's edge."""
    if stride_samples is None:
        stride_samples = window_samples // 6
    step = window_samples - 2 * stride_samples
    if step <= 0:
        raise ValueError("stride too large: window must exceed 2*stride")
    n = max(0, int(n_samples))
    if n <= window_samples:
        return [(0, 0, max(n, 1))]
    starts = list(range(0, n - window_samples, step))
    starts.append(n - window_samples)  # the last window is right-aligned
    out = []
    for k, s in enumerate(starts):
        first, last = k == 0, k == len(starts) - 1
        core_start = 0 if first else s + stride_samples
        core_end = n if last else s + window_samples - stride_samples
        # the right-aligned last window may start its core before the
        # previous core's end: the earlier window keeps the disputed region
        if not first:
            core_start = max(core_start, out[-1][2])
        out.append((s, core_start, core_end))
    return out


def split_token_segments(row, tokenizer):
    """The token twin of ``tokenizer.split_timestamp_segments``:
    ``[(start_s, end_s | None, tokens), ...]`` with the bounding timestamp
    tokens inside ``tokens``, so merged outputs stay timestamped."""
    segments = []
    start_t = None
    start_tok = None
    buf = []
    for raw in row:
        raw = int(raw)
        t = tokenizer.timestamp_value(raw)
        if t is None:
            if not tokenizer.is_special(raw) and raw >= 0:
                buf.append(raw)
            continue
        if start_t is None:
            start_t, start_tok = t, raw
        elif buf:
            segments.append((start_t, t, [start_tok] + buf + [raw]))
            buf, start_t, start_tok = [], None, None
        else:
            start_t, start_tok = t, raw  # consecutive timestamps: reset
    if buf:
        seg = ([start_tok] if start_tok is not None else []) + buf
        segments.append((start_t or 0.0, None, seg))
    return segments


def merge_longest_common_sequence(seqs: list[list[int]]) -> list[int]:
    """Merge consecutive token sequences by their best sliding overlap: for
    each pair, every equal-length split (left tail, right head) scores its
    match ratio plus a small length bonus; the winner keeps the left
    sequence to its cut and the right one from its cut."""
    if not seqs:
        return []
    merged = list(seqs[0])
    for nxt in seqs[1:]:
        nxt = list(nxt)
        if not merged:
            merged = nxt
            continue
        if not nxt:
            continue
        best = (0.0, len(merged), 0)  # (score, left_cut, right_cut)
        max_olap = min(len(merged), len(nxt))
        for k in range(1, max_olap + 1):
            left = merged[-k:]
            right = nxt[:k]
            matches = sum(1 for a, b in zip(left, right) if a == b)
            score = matches / k + k / 10000.0
            if matches > 1 and score > best[0]:
                m = (k + 1) // 2  # one split index for both sides: k tokens kept
                best = (score, len(merged) - k + m, m)
        _, lcut, rcut = best
        merged = merged[:lcut] + nxt[rcut:]
    return merged


def transcribe_chunked(
    model: Whisper,
    tokenizer,
    audios: list[np.ndarray],
    *,
    mel_fn=None,
    max_new: int = 224,
    window_samples: int = N_SAMPLES,
    stride_samples: int | None = None,        # window / 6 (5 s of 30 s)
    max_batch: int = 64,
    use_timestamps: bool = True,
    contexts: list[list[int]] | None = None,  # static per-file context
    bias_spans: np.ndarray | None = None,     # (B, N, K) per file
    bias_boost: float = 0.0,
    temperatures: tuple[float, ...] = DEFAULT_TEMPERATURES,
    best_of: int = 1,                         # > 1: a sampled rung keeps the best of n
    compression_ratio_threshold: float | None = 2.4,
    logprob_threshold: float | None = -1.0,
    no_speech_threshold: float | None = 0.6,
    start_tokens: list[list[int]] | None = None,  # per-file decode starts
    decode_fn: Callable | None = None,
    generator: torch.Generator | None = None,     # on the decode device
    prefix_pad_to_multiple: int | None = None,
    return_segments: bool = False,
    return_window_info: bool = False,         # per-window QC dicts, file by file,
                                              # as the LAST return element
    draft: tuple | None = None,
    pad_batches: bool = False,                # pad every call to max_batch with
                                              # silent rows
    medusa: dict | None = None,
    num_beams: int = 1,                       # > 1: beam search drives the t=0 rung
    length_penalty: float = 1.0,
    beam_early_stopping: str = "off",
    mesh=None,
    vad: bool | dict | list = False,          # energy VAD gate, or clip ranges
    word_timestamps: bool = False,            # one alignment pass a decode batch;
                                              # words owned by the segments' cores
    alignment_heads: list[tuple[int, int]] | None = None,
    phase_times: dict | None = None,          # filled with upload_s, decode_s,
                                              # merge_s, n_windows (host clock)
    device_windows: bool = True,              # gather windows on the device
                                              # (default) or cut them on the host
    device="cuda",
):
    """Per-file token lists; with ``return_segments`` ``(tokens, segments)``,
    and with ``word_timestamps`` too ``(tokens, segments, words)``; segment
    and word times are absolute file time, token streams keep the windows'
    own timestamp tokens.

    All windows of all files flatten into one work list decoded in batches of
    ``max_batch``, each window with its file's bias spans, context and start
    tokens. Padding rows (``pad_batches``) decode silence and never drive the
    ladder. ``decode_fn(mel, ids, mask, temperature, generator) ->
    GreedyResult`` can be injected; the default runs ``greedy_decode``
    (``beam_decode`` at the t=0 rung with ``num_beams > 1``) on ``device``.
    ``medusa`` (a head dict) or ``draft`` (``(draft model, its config, k)``
    with the target's ``n_mels``) drives the t=0 rung through
    ``t0_verified_decode`` (Medusa wins; beams win over both), with the same
    tokens as plain greedy; the timestamp rules are then off on every rung,
    as in JAX.

    ``mesh``: each rank decodes its share of every window batch (see the
    module docstring); ``model`` and a draft are this rank's shards
    (``parallel.shard_params``) and every rank returns the whole result.
    ``device_windows``: gather each batch's windows on the device from the
    buffer uploaded once, or, False, cut them in numpy and upload each
    batch (JAX's path under a mesh; the same tokens)."""
    device = resolve_device(device)
    if mel_fn is None:
        frontend, n_mels = select_mel_frontend(), model.cfg.n_mels
        mel_fn = lambda chunk: frontend(chunk, n_mels=n_mels)  # noqa: E731
    # the words are reachable only through (tokens, segments, words)
    word_timestamps = word_timestamps and return_segments
    if not temperatures:
        temperatures = (0.0,)
    if generator is None and any(t > 0 for t in temperatures):
        generator = torch.Generator(device=device).manual_seed(0)

    # int16 PCM crosses as int16 and is normalised on the device; a mix of
    # dtypes, or the host path, normalises on the host
    audios = [np.asarray(a) for a in audios]
    if not (device_windows and audios and all(a.dtype == np.int16 for a in audios)):
        audios = [pcm_to_float32(a) for a in audios]
    nfiles = len(audios)

    # the work list: (file, window start, core range); a window with no
    # detected speech never enters it (its core is silent too)
    vad_segs = None
    if vad is not None and vad is not False:  # NB: vad={} means defaults
        from ..audio.vad import has_speech, resolve_vad

        vad_segs = [resolve_vad(vad, a) for a in audios]
        if all(s is None for s in vad_segs):  # e.g. vad=[]: no gating
            vad_segs = None
    from ..audio.vad import vad_overlap_tol

    # overlap that is only the detector's word-edge pad is not speech
    # (clamped to a quarter window)
    vad_tol = min(vad_overlap_tol(vad), window_samples // 4)
    work: list[tuple[int, int, int, int]] = []
    for fi, a in enumerate(audios):
        for s, c0, c1 in chunk_layout(len(a), window_samples, stride_samples):
            if vad_segs is not None and not has_speech(vad_segs[fi], s, s + window_samples,
                                                       tol=vad_tol):
                continue
            work.append((fi, s, c0, c1))

    def prefix_for(fi: int) -> list[int]:
        # the context's tail on overflow, as the sequential loop's history
        ctx = list(contexts[fi])[-MAX_PROMPT_TOKENS:] if contexts and contexts[fi] else []
        start = list(start_tokens[fi]) if start_tokens else [tokenizer.sot]
        return ([tokenizer.sop] + ctx + start) if ctx else start

    results: list[list[int] | None] = [None] * len(work)
    window_words: list[list] = [[] for _ in range(len(work))]
    win_info: list[dict | None] = [None] * len(work)

    t_up = time.perf_counter()
    if work and device_windows:
        buf, base, zero_off = _flat_audio_buffer(audios, window_samples, device)
        if phase_times is not None and device.type == "cuda":
            torch.cuda.synchronize(device)  # the copy is this phase's
    if phase_times is not None:
        phase_times["upload_s"] = (time.perf_counter() - t_up
                                   if work and device_windows else 0.0)
        phase_times["n_windows"] = len(work)
    t_dec = time.perf_counter()
    ns_id = tokenizer.no_speech if no_speech_threshold is not None else None
    # the timestamp rules stay off when Medusa or a draft drives t=0, so the
    # verified-equals-greedy contract holds on every rung
    ts_begin = (tokenizer.timestamp_begin
                if use_timestamps and medusa is None and draft is None else None)

    dp = axis_size(mesh, DATA_AXIS)
    for lo in range(0, len(work), max_batch):
        batch = work[lo: lo + max_batch]
        nb_real = len(batch)
        nb = max_batch if pad_batches else nb_real
        nb = -(-nb // dp) * dp  # a share for each rank of "data"
        # this rank's windows: all of them without a mesh
        per, di = nb // dp, axis_index(mesh, DATA_AXIS)
        mine = range(di * per, (di + 1) * per)
        if device_windows:
            starts = [base[fi] + s for fi, s, _, _ in batch] + [zero_off] * (nb - nb_real)
            chunk = _gather_windows(buf, [starts[j] for j in mine], window_samples)
        else:
            host = np.zeros((len(mine), window_samples), np.float32)
            for r, j in enumerate(mine):
                if j < nb_real:
                    fi, s, _, _ = batch[j]
                    part = audios[fi][s: s + window_samples]
                    host[r, : len(part)] = part
            chunk = torch.from_numpy(host).to(device)
        mel = mel_fn(chunk)
        if mesh is not None:  # an injected decode_fn gets the whole batch
            mel = torch.as_tensor(mel, device=device)
            mel = LocalRows(mel) if decode_fn is None else gather_rows(mel, mesh)

        prefixes = [prefix_for(fi) for fi, _, _, _ in batch] + [[tokenizer.sot]] * (nb - nb_real)
        ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=prefix_pad_to_multiple)
        spans = None
        if bias_spans is not None:
            arr = np.asarray(bias_spans)
            spans = arr[[fi for fi, *_ in batch]]
            if nb > nb_real:  # padding rows carry no spans
                pad = np.full((nb - nb_real,) + arr.shape[1:], tokenizer.eot, arr.dtype)
                spans = np.concatenate([spans, pad])
        sot_off = ([len(start_tokens[fi]) for fi, *_ in batch] + [1] * (nb - nb_real)
                   if start_tokens else 1)

        def run(temperature, gen, mel=mel, ids=ids, mask=mask, spans=spans, sot_off=sot_off):
            if decode_fn is not None:
                return decode_fn(mel, ids, mask, temperature, gen)
            if num_beams > 1 and temperature == 0.0:
                from .beam import beam_decode

                res = beam_decode(
                    model, mel, ids, mask, num_beams=num_beams, max_new=max_new,
                    eot_id=tokenizer.eot, bias_spans=spans, bias_boost=bias_boost,
                    span_pad_id=tokenizer.eot, length_penalty=length_penalty,
                    early_stopping=beam_early_stopping, no_speech_id=ns_id,
                    sot_offset=sot_off, timestamp_begin=ts_begin, device=device, mesh=mesh)
                return _best_beam_as_greedy(res, length_penalty, beam_early_stopping)
            if temperature == 0.0 and (medusa is not None or draft is not None):
                if medusa is None and draft[1].n_mels != model.cfg.n_mels:
                    raise ValueError("chunked speculative decoding needs a draft with the "
                                     "target's n_mels")
                return t0_verified_decode(
                    model, tokenizer, mel, ids, mask, max_new=max_new, spans=spans,
                    bias_boost=bias_boost, no_speech_id=ns_id, sot_offset=sot_off,
                    medusa=medusa, draft=draft, device=device, mesh=mesh)
            return greedy_decode(
                model, mel, ids, mask, max_new=max_new, eot_id=tokenizer.eot,
                bias_spans=spans, bias_boost=bias_boost, span_pad_id=tokenizer.eot,
                temperature=temperature, generator=gen, no_speech_id=ns_id,
                sot_offset=sot_off, timestamp_begin=ts_begin, device=device, mesh=mesh)

        # the ladder over the whole batch; only failing real rows pend
        # (padding rows decode silence and must not drive retries)
        accepted: list[list[int] | None] = [None] * nb_real
        last: list[list[int]] = [[] for _ in range(nb_real)]
        last_avg_lp: list[float | None] = [None] * nb_real
        last_temp: list[float] = [0.0] * nb_real
        nsp = None
        for ti, temperature in enumerate(temperatures):
            if temperature > 0 and best_of > 1:
                res = sample_best_of(run, temperature, generator, best_of)
            else:
                res = run(temperature, generator)
            toks, lens, slp = _np(res.tokens), _np(res.lengths), _np(res.sum_logprob)
            if ti == 0 and no_speech_threshold is not None and res.no_speech_prob is not None:
                nsp = _np(res.no_speech_prob)
            pending = False
            for j in range(nb_real):
                if accepted[j] is not None:
                    continue
                row = toks[j, : lens[j]].tolist()
                last[j] = row
                last_temp[j] = float(temperature)
                avg_lp = None if slp is None else float(slp[j]) / (int(lens[j]) + 1)
                last_avg_lp[j] = avg_lp
                text = tokenizer.decode(row, skip_special_tokens=True)
                if window_quality_ok(text, avg_lp,
                                     compression_ratio_threshold=compression_ratio_threshold or 0.0,
                                     logprob_threshold=logprob_threshold):
                    accepted[j] = row
                else:
                    pending = True
            if not pending:
                break

        for j in range(nb_real):
            row = accepted[j] if accepted[j] is not None else last[j]
            if nsp is not None and nsp[j] > no_speech_threshold:
                if not (logprob_threshold is not None and last_avg_lp[j] is not None
                        and last_avg_lp[j] > logprob_threshold):
                    row = []  # a silent window
            results[lo + j] = row
            if return_window_info:
                win_info[lo + j] = {
                    "start_s": round(batch[j][1] / SAMPLE_RATE, 3),
                    "temperature": last_temp[j],
                    "avg_logprob": last_avg_lp[j],
                    "no_speech_prob": float(nsp[j]) if nsp is not None else None,
                    # the ratio the ladder gated on: the final rung's whole row,
                    # before the silence rule empties it
                    "compression_ratio": round(compression_ratio(tokenizer.decode(
                        accepted[j] if accepted[j] is not None else last[j],
                        skip_special_tokens=True)), 3),
                    "accepted": accepted[j] is not None,
                }

        if word_timestamps:
            # one alignment pass a decode batch over the whole decoded rows;
            # ownership picks the words at merge time, as it does segments
            from .word_timestamps import find_word_timestamps

            act = [j for j in range(nb_real) if results[lo + j]]
            if act:
                # every rank aligns every row: its own share's mel joined
                # with the other ranks'
                whole = gather_rows(mel.rows, mesh) if isinstance(mel, LocalRows) else mel
                timings = find_word_timestamps(
                    model, tokenizer, _mel_rows(whole, act), [results[lo + j] for j in act],
                    starts=([list(start_tokens[batch[j][0]]) for j in act]
                            if start_tokens else None),
                    num_frames=[window_frames(len(audios[batch[j][0]]), batch[j][1],
                                              window_samples) for j in act],
                    alignment_heads=alignment_heads, pad_to=max_new + 8)
                for j, ws in zip(act, timings):
                    window_words[lo + j] = ws

    # merge file by file
    t_merge = time.perf_counter()
    if phase_times is not None:
        phase_times["decode_s"] = t_merge - t_dec
    outputs: list[list[int]] = [[] for _ in range(nfiles)]
    segments: list[list[tuple[float, float | None, str]]] = [[] for _ in range(nfiles)]
    words: list[list] = [[] for _ in range(nfiles)]
    by_file: list[list] = [[] for _ in range(nfiles)]
    for (fi, s, c0, c1), row, ws in zip(work, results, window_words):
        by_file[fi].append((s, c0, c1, row or [], ws))

    for fi in range(nfiles):
        wins = sorted(by_file[fi], key=lambda w: w[0])
        if use_timestamps:
            for s, c0, c1, row, _ in wins:
                offset = s / SAMPLE_RATE
                core0, core1 = c0 / SAMPLE_RATE, c1 / SAMPLE_RATE
                for t0, t1, toks in split_token_segments(row, tokenizer):
                    abs0 = offset + (t0 or 0.0)
                    # ownership: the segment's start instant lies in exactly
                    # one core (the first core starts at 0)
                    if core0 <= abs0 < core1:
                        outputs[fi].extend(toks)
                        if return_segments:
                            text = tokenizer.decode(toks, skip_special_tokens=True)
                            if text.strip():
                                segments[fi].append(
                                    (abs0, None if t1 is None else offset + t1, text))
        else:
            merged = merge_longest_common_sequence([row for _, _, _, row, _ in wins])
            outputs[fi] = merged
            if return_segments:
                text = tokenizer.decode(merged, skip_special_tokens=True)
                if text.strip():
                    segments[fi].append((0.0, len(audios[fi]) / SAMPLE_RATE, text))
        if word_timestamps:
            # a word belongs to the window whose core holds its start
            for s, c0, c1, _, ws in wins:
                offset = s / SAMPLE_RATE
                core0, core1 = c0 / SAMPLE_RATE, c1 / SAMPLE_RATE
                for w in ws:
                    abs_start = w.start + offset
                    if core0 <= abs_start < core1:
                        w.start = round(abs_start, 3)
                        w.end = round(w.end + offset, 3)
                        words[fi].append(w)

    if phase_times is not None:
        phase_times["merge_s"] = time.perf_counter() - t_merge
    out: tuple = (outputs,)
    if return_segments:
        out += (segments,)
        if word_timestamps:
            out += (words,)
    if return_window_info:
        # the work list is file-major with ascending starts: each file's info
        # is already in start order
        info_by_file: list[list[dict]] = [[] for _ in range(nfiles)]
        for (fi, *_), info in zip(work, win_info):
            if info is not None:
                info_by_file[fi].append(info)
        out += (info_by_file,)
    return out if len(out) > 1 else outputs
