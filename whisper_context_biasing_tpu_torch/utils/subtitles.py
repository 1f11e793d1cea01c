"""Subtitle formatting (SRT / WebVTT) from timed segments.

A copy of the JAX package's ``utils/subtitles.py`` (it imports no JAX),
mirroring the writer surface of the openai-whisper CLI. Segments are
``(start_s, end_s, text)`` triples from long-form timestamp decoding
(``tokenizer.split_timestamp_segments``), or word timings grouped by
:func:`words_to_segments`.
"""

from __future__ import annotations


def _clock(t: float, decimal_sep: str) -> str:
    ms = int(round(max(t, 0.0) * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{decimal_sep}{ms:03d}"


def format_srt(segments: list[tuple[float, float, str]]) -> str:
    """SRT: 1-indexed cues, comma decimal separator, blank-line terminated."""
    lines = []
    for i, (start, end, text) in enumerate(segments, 1):
        lines.append(str(i))
        lines.append(f"{_clock(start, ',')} --> {_clock(end, ',')}")
        lines.append(text.strip())
        lines.append("")
    return "\n".join(lines)


def format_vtt(segments: list[tuple[float, float, str]]) -> str:
    """WebVTT: header + cues with dot decimal separator."""
    lines = ["WEBVTT", ""]
    for start, end, text in segments:
        lines.append(f"{_clock(start, '.')} --> {_clock(end, '.')}")
        lines.append(text.strip())
        lines.append("")
    return "\n".join(lines)


def words_to_segments(
    words,
    *,
    max_words: int = 12,
    max_duration: float = 6.0,
    max_gap: float = 1.0,
) -> list[tuple[float, float, str]]:
    """Group WordTiming-like objects (``.word``/``.start``/``.end``) into
    caption segments: a new cue starts on a silence gap > ``max_gap``, at
    ``max_words`` words, or past ``max_duration`` seconds."""
    segments: list[tuple[float, float, str]] = []
    cur: list = []
    for w in words:
        if cur and (
            len(cur) >= max_words
            or w.start - cur[-1].end > max_gap
            or w.end - cur[0].start > max_duration
        ):
            segments.append((cur[0].start, cur[-1].end,
                             " ".join(x.word.strip() for x in cur)))
            cur = []
        cur.append(w)
    if cur:
        segments.append((cur[0].start, cur[-1].end,
                         " ".join(x.word.strip() for x in cur)))
    return segments


def close_open_segments(
    segments, *, fallback_duration: float = 2.0, clip_end: float | None = None
) -> list[tuple[float, float, str]]:
    """Fill ``None`` end times (an un-closed trailing timestamp segment):
    use the next segment's start, else start + ``fallback_duration`` clamped
    to ``clip_end``."""
    out = []
    for i, (start, end, text) in enumerate(segments):
        if end is None:
            if i + 1 < len(segments):
                end = segments[i + 1][0]
            else:
                end = start + fallback_duration
                if clip_end is not None:
                    end = min(end, clip_end)
        out.append((start, max(end, start), text))
    return out
