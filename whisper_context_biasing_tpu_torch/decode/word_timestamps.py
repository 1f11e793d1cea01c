"""Word-level timestamps: DTW over cross-attention alignment matrices.

The counterpart of the JAX package's ``decode/word_timestamps.py``. Per
batch of clips:

  1. a teacher-forced decoder pass gives a (B, S, frames) alignment matrix
     (``models/alignment.py``) on the device;
  2. a monotonic DTW on the host through each clip's matrix maps every token
     to its start frame (a copy of the JAX host code, so ties resolve the
     same way);
  3. tokens group into words at space and punctuation boundaries.

One encoder state is 0.02 s (two 10 ms mel hops).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SECONDS_PER_FRAME = 0.02
SAMPLES_PER_FRAME = 320  # 16 kHz * 0.02 s


@dataclass
class WordTiming:
    word: str
    start: float  # seconds
    end: float    # seconds
    tokens: list
    probability: float | None = None  # mean P(token | context, audio) over the
                                      # word's tokens (teacher-forced)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through ``cost`` (N tokens, M frames) from (0, 0) to
    (N-1, M-1) with down, right and diagonal steps; returns the path as
    (text_indices, time_indices).

    The table fills row by row: ``c[j] = v[j] + min(a[j], c[j-1])`` (``a``
    the smaller upper predecessor) unrolls to ``c[j] = S[j] + min_{k<=j}(a[k]
    - S[k-1])`` over prefix sums S, a running minimum. The traceback always
    steps to a least-cost predecessor, the diagonal first on ties, then up."""
    n, m = cost.shape
    table = np.full((n + 1, m + 1), np.inf, np.float64)
    table[0, 0] = 0.0
    v_all = cost.astype(np.float64)
    for i in range(1, n + 1):
        v = v_all[i - 1]
        a = np.minimum(table[i - 1, 1:], table[i - 1, :-1])  # up, diagonal
        s = np.cumsum(v)
        shifted = np.concatenate(([0.0], s[:-1]))
        best = np.minimum.accumulate(a - shifted)
        table[i, 1:] = s + best
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 1 or j > 1:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        moves = ((table[i - 1, j - 1], 0), (table[i - 1, j], 1), (table[i, j - 1], 2))
        _, pick = min(moves, key=lambda t: (t[0], t[1]))
        if pick == 0:
            i, j = i - 1, j - 1
        elif pick == 1:
            i -= 1
        else:
            j -= 1
    text_idx.append(0)
    time_idx.append(0)
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


# the whisper punctuation conventions: opening marks attach to the following
# word, closing marks to the previous one
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(words: list[str], word_tokens: list[list[int]],
                       prepended: str = PREPEND_PUNCTUATIONS,
                       appended: str = APPEND_PUNCTUATIONS
                       ) -> tuple[list[str], list[list[int]]]:
    """Two-pass punctuation merge (openai-whisper's timing rules): a lone
    opening mark joins the word after it, a lone closing mark the word
    before it."""
    words = list(words)
    word_tokens = [list(t) for t in word_tokens]
    # prepended: backwards, so that chains ("¿(" + word) collapse fully
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        if words[i].startswith(" ") and words[i].strip() in prepended:
            words[j] = words[i] + words[j]
            word_tokens[j] = word_tokens[i] + word_tokens[j]
            words[i], word_tokens[i] = "", []
        else:
            j = i
        i -= 1
    # appended: forwards
    i, j = 0, 1
    while j < len(words):
        if not words[i].endswith(" ") and words[j] in appended:
            words[i] = words[i] + words[j]
            word_tokens[i] = word_tokens[i] + word_tokens[j]
            words[j], word_tokens[j] = "", []
        else:
            i = j
        j += 1
    keep = [k for k, w in enumerate(words) if w]
    return [words[k] for k in keep], [word_tokens[k] for k in keep]


def split_words(tokenizer, tokens: list[int]) -> tuple[list[str], list[list[int]]]:
    """Group text tokens into words: byte-level BPE pieces merge until they
    decode without a trailing replacement character, then into words at
    space boundaries; punctuation attaches by :func:`merge_punctuations`."""
    sub_texts, sub_tokens = [], []
    current: list[int] = []
    for tok in tokens:
        current.append(tok)
        decoded = tokenizer.decode(current, skip_special_tokens=True)
        if decoded and not decoded.endswith("�"):
            sub_texts.append(decoded)
            sub_tokens.append(current)
            current = []
    if current:
        sub_texts.append(tokenizer.decode(current, skip_special_tokens=True))
        sub_tokens.append(current)

    words: list[str] = []
    word_tokens: list[list[int]] = []
    for text, toks in zip(sub_texts, sub_tokens):
        if text.startswith(" ") or not words:
            words.append(text)
            word_tokens.append(list(toks))
        else:
            words[-1] += text
            word_tokens[-1].extend(toks)
    return merge_punctuations(words, word_tokens)


@torch.no_grad()
def find_word_timestamps(
    model,
    tokenizer,
    mel,                      # (B, n_mels, T_mel)
    hyps: list[list[int]],    # decoded token lists, without the prefix
    *,
    starts: list[list[int]] | None = None,      # per-clip decode start sequences
    num_frames: list[int] | int | None = None,  # per-clip content frames
    alignment_heads: list[tuple[int, int]] | None = None,
    medfilt_width: int = 7,
    pad_to: int | None = None,
    enc_out=None,             # (B, T, D) encoder states: no second encoder pass
) -> list[list[WordTiming]]:
    """Per-clip word timings for decoded hypotheses. ``num_frames``: frames
    the audio covers (``n_samples // 320``; the whole window by default);
    times are clamped to it. ``pad_to``: the token axis padded to this
    length, the frame axis then the whole encoder context (the shapes of
    the JAX package's one compiled program; the values are the same)."""
    from ..models.alignment import alignment_matrix, resolve_alignment_mask
    from ..models.whisper import encode_audio

    b = mel.shape[0]
    if starts is None:
        starts = [[tokenizer.sot]] * b
    head_mask = resolve_alignment_mask(model.cfg, alignment_heads)

    # specials that leaked into the hypotheses (timestamps etc.) are dropped
    text_hyps = [[t for t in h if not tokenizer.is_special(t)] for h in hyps]
    seqs = [list(st) + h + [tokenizer.eot] for st, h in zip(starts, text_hyps)]
    max_s = max(len(s) for s in seqs)
    if pad_to is not None:
        max_s = max(max_s, int(pad_to))
    toks = np.full((b, max_s), tokenizer.eot, np.int64)
    tok_mask = np.zeros((b, max_s), np.float32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
        tok_mask[i, : len(s)] = 1.0

    if enc_out is None:
        dev = next(model.parameters()).device
        enc_out = encode_audio(model, torch.as_tensor(mel, dtype=torch.float32, device=dev))
    total_frames = enc_out.shape[1]
    if num_frames is None:
        frames = [total_frames] * b
    elif isinstance(num_frames, int):
        frames = [num_frames] * b
    else:
        frames = list(num_frames)
    frames = [max(2, min(int(f), total_frames)) for f in frames]

    static_frames = total_frames if pad_to is not None else max(frames)
    matrix, tok_probs = alignment_matrix(
        model, torch.from_numpy(toks), enc_out, head_mask, torch.from_numpy(tok_mask),
        num_frames=static_frames, medfilt_width=medfilt_width, with_probs=True)
    matrix = matrix.cpu().numpy()        # (B, S, F)
    tok_probs = tok_probs.cpu().numpy()  # (B, S)

    out: list[list[WordTiming]] = []
    for i in range(b):
        n_prefix = len(starts[i])
        text = text_hyps[i]
        if not text:
            out.append([])
            continue
        # the text rows and the eot row: the last word ends where attention
        # leaves the content
        rows = matrix[i, n_prefix: n_prefix + len(text) + 1, : frames[i]]
        text_idx, time_idx = dtw_path(-rows)
        jumps = np.concatenate(([True], np.diff(text_idx) > 0))
        jump_times = time_idx[jumps] * SECONDS_PER_FRAME  # start frame per row
        words, word_tokens = split_words(tokenizer, text)
        timings: list[WordTiming] = []
        pos = 0
        clip_end = frames[i] * SECONDS_PER_FRAME
        for word, wtoks in zip(words, word_tokens):
            start_t = float(jump_times[pos]) if pos < len(jump_times) else clip_end
            nxt = pos + len(wtoks)
            end_t = float(jump_times[nxt]) if nxt < len(jump_times) else clip_end
            prob = float(np.mean(tok_probs[i, n_prefix + pos: n_prefix + nxt]))
            timings.append(WordTiming(word=word, start=round(start_t, 3),
                                      end=round(max(end_t, start_t), 3), tokens=list(wtoks),
                                      probability=round(prob, 6)))
            pos = nxt
        out.append(timings)
    return out
