"""Host-side voice-activity detection: skip silent windows before device work.

A numpy copy of the JAX package's ``audio/vad.py``. A 30 s window of silence
costs the same encoder and decode work as one full of speech, and Whisper's
own silence rule (``P(<|nospeech|>)`` at the sot position,
``decode/long_form.py``) fires only after the encoder and the decoder
prefill have run; this gate drops such windows on the host first.

Adaptive-threshold energy VAD — the standard energy-gate recipe, no learned
model, no external dependency:

  1. frame RMS in dB (25 ms frames, 10 ms hop);
  2. speech threshold = ``max(floor_db, min(noise_floor + margin_db,
     peak - 6 dB))`` where the noise floor is the 10th-percentile frame.
     The ``peak - 6`` clamp keeps uniformly-loud audio classified as speech
     even when the percentile floor sits high (better to decode than clip);
     ``floor_db`` keeps electrical noise in digital silence below the gate;
  3. hangover smoothing: speech runs separated by less than
     ``min_silence_ms`` merge, runs shorter than ``min_speech_ms`` drop,
     and every kept segment is padded by ``pad_ms`` on both sides.

Defaults are deliberately conservative: the gate should *skip only obvious
silence*, never clip quiet speech — a missed skip costs one redundant
window decode, a false skip loses transcript.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000

#: kwargs accepted by :func:`speech_segments` (the ``vad=dict(...)`` surface)
VAD_OPTION_KEYS = (
    "frame_ms", "hop_ms", "margin_db", "floor_db",
    "min_speech_ms", "min_silence_ms", "pad_ms", "min_dynamic_range_db",
)


def frame_rms_db(
    audio: np.ndarray, sr: int = SAMPLE_RATE,
    frame_ms: float = 25.0, hop_ms: float = 10.0,
) -> np.ndarray:
    """Per-frame RMS energy in dBFS, clamped at -100 (digital silence).

    O(n) memory via a cumulative sum of squares — VAD targets
    meeting/podcast-length files, where a framed-gather matrix
    (n_frames x frame_len) would transiently allocate gigabytes."""
    from .io import pcm_to_float32

    # raw int16 PCM must read the same
    # dBFS as its float view — a plain float cast would shift every level
    # +90.3 dB and break all the absolute thresholds below
    audio = pcm_to_float32(audio)
    frame = max(1, int(sr * frame_ms / 1000.0))
    hop = max(1, int(sr * hop_ms / 1000.0))
    if len(audio) < frame:
        audio = np.pad(audio, (0, frame - len(audio)))
    n = 1 + (len(audio) - frame) // hop
    cs = np.concatenate(([0.0], np.cumsum(np.square(audio, dtype=np.float64))))
    starts = np.arange(n) * hop
    energy = cs[starts + frame] - cs[starts]
    rms = np.sqrt(np.maximum(energy / frame, 0.0))
    return 20.0 * np.log10(np.maximum(rms, 1e-5)).astype(np.float32)


def _merge_intervals(segs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge sorted, possibly-overlapping/touching intervals in place-order."""
    merged: list[tuple[int, int]] = []
    for s, e in segs:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def speech_segments(
    audio: np.ndarray,
    sr: int = SAMPLE_RATE,
    *,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    margin_db: float = 8.0,
    floor_db: float = -55.0,
    min_speech_ms: float = 100.0,
    min_silence_ms: float = 300.0,
    pad_ms: float = 150.0,
    min_dynamic_range_db: float = 35.0,
) -> list[tuple[int, int]]:
    """Speech regions as ``[(start_sample, end_sample), ...]``, sorted,
    non-overlapping. Empty list = no speech anywhere."""
    from .io import pcm_to_float32

    audio = pcm_to_float32(audio)  # int16 pass-through keeps its dBFS scale
    if len(audio) == 0:
        return []
    db = frame_rms_db(audio, sr, frame_ms, hop_ms)
    noise_floor = float(np.percentile(db, 10.0))
    peak = float(db.max())
    if peak <= floor_db:
        return []  # even the loudest frame is below the silence floor
    if peak - noise_floor < min_dynamic_range_db:
        # Not enough dynamic range for the percentile floor to be real
        # silence — it may be sitting on quiet SPEECH (a far-from-mic
        # talker under a loud one). Silence-vs-speech gaps in genuine
        # recordings run 35 dB+; below that, gate nothing: a missed skip
        # costs one window decode, a false skip loses transcript.
        return [(0, len(audio))]
    thr = max(floor_db, min(noise_floor + margin_db, peak - 6.0))
    speech = db > thr
    if not speech.any():
        return []

    hop = max(1, int(sr * hop_ms / 1000.0))
    frame = max(1, int(sr * frame_ms / 1000.0))
    # frame runs -> sample segments
    edges = np.flatnonzero(np.diff(np.concatenate(([0], speech.view(np.int8), [0]))))
    segs = [(int(edges[i]) * hop, (int(edges[i + 1]) - 1) * hop + frame)
            for i in range(0, len(edges), 2)]

    # merge runs separated by < min_silence_ms
    gap = int(sr * min_silence_ms / 1000.0)
    merged: list[list[int]] = []
    for s, e in segs:
        if merged and s - merged[-1][1] < gap:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    # drop runs shorter than min_speech_ms, pad, re-join touching neighbours
    min_len = int(sr * min_speech_ms / 1000.0)
    pad = int(sr * pad_ms / 1000.0)
    return _merge_intervals([(max(0, s - pad), min(len(audio), e + pad))
                             for s, e in merged if e - s >= min_len])


def has_speech(segments: list[tuple[int, int]], start: int, end: int,
               tol: int = 0) -> bool:
    """True when a speech segment overlaps ``[start, end)`` by more than
    ``tol`` samples.

    ``tol`` exists because :func:`speech_segments` pads every segment by
    ``pad_ms`` on each side (word-edge protection for the window that will
    decode it). A window whose only overlap with speech is that pad contains
    no speech frames at all — with the any-overlap rule (``tol=0``) the pad
    bleeds into both neighbouring windows and regularly-tiled audio never
    skips ANY window. Callers gating fixed windows should pass
    ``tol=vad_overlap_tol(vad)``; explicit clip ranges keep any-overlap
    semantics (their tol is 0 — user ranges are verbatim)."""
    return any(min(e, end) - max(s, start) > tol for s, e in segments)


def vad_overlap_tol(vad, sr: int = SAMPLE_RATE) -> int:
    """Overlap tolerance (samples) matching the boundary bleed
    :func:`resolve_vad` introduces around real speech: the explicit
    ``pad_ms`` plus the detection extent of one RMS frame (a frame whose
    tail clips the onset can already cross the threshold) plus one hop of
    quantization — honouring dict overrides. 0 for explicit clip ranges /
    no gating (user ranges are verbatim)."""
    if vad is None or vad is False or isinstance(vad, (list, tuple)):
        return 0
    pad_ms, frame_ms, hop_ms = 150.0, 25.0, 10.0
    if isinstance(vad, dict):
        pad_ms = float(vad.get("pad_ms", pad_ms))
        frame_ms = float(vad.get("frame_ms", frame_ms))
        hop_ms = float(vad.get("hop_ms", hop_ms))
    return int(sr * (pad_ms + frame_ms + hop_ms) / 1000.0)


def next_onset(segments: list[tuple[int, int]], pos: int,
               tol: int = 0) -> int | None:
    """Sample index of the first speech at or after ``pos`` (a segment
    already containing ``pos`` returns ``pos``); None = no speech left.

    With ``tol > 0``, segments whose remainder past ``pos`` is ``<= tol``
    samples are treated as exhausted — the :func:`has_speech` tolerance
    contract, without which a seek sitting ``tol`` samples before a segment
    end would be returned verbatim and the caller's skip loop would never
    advance."""
    for s, e in segments:
        if e - max(s, pos) > tol:
            return max(s, pos)
    return None


def resolve_vad(vad, audio: np.ndarray) -> list[tuple[int, int]] | None:
    """The ``vad=`` argument contract shared by the long-form entry points:
    ``False``/``None`` → no gating (returns None), ``True`` → default
    options, a dict → :func:`speech_segments` keyword overrides, a
    list/tuple of ``(start_s, end_s)`` second-ranges → used verbatim as the
    speech segments (the clip_timestamps idiom: decode ONLY those ranges,
    no energy detection at all)."""
    if vad is None or vad is False or (isinstance(vad, (list, tuple))
                                       and len(vad) == 0):
        return None
    if isinstance(vad, (list, tuple)):
        n = len(audio)
        segs = []
        for item in vad:
            s, e = item
            if e <= s:
                raise ValueError(f"clip range end must exceed start: {item}")
            s_i = max(0, int(float(s) * SAMPLE_RATE))
            e_i = min(n, int(float(e) * SAMPLE_RATE))
            if e_i > s_i:
                segs.append((s_i, e_i))
        segs.sort()
        return _merge_intervals(segs)
    opts = dict(vad) if isinstance(vad, dict) else {}
    unknown = set(opts) - set(VAD_OPTION_KEYS)
    if unknown:
        raise ValueError(f"unknown vad option(s): {sorted(unknown)}; "
                         f"valid: {list(VAD_OPTION_KEYS)}")
    return speech_segments(np.asarray(audio, np.float32), **opts)
