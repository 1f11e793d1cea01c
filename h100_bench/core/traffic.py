"""One general generator for every traffic mix: a mix is a data file of
parameters (``traffic/<name>.json``) that these functions read.

Every seed gets the same set of sizes: a step or batch is always the same
multiset of row shapes (clip durations, token caps, context and label
lengths, bias-list sizes), drawn once by stratified quantiles from the
mix's distributions with the mix's own ``shape_seed``. The run's seed
decides the order of the rows and everything inside them: the audio, the
context and transcript token ids, the bias words. So the work of a batch
does not change with the seed, and two seeds differ only in content.

Clip lengths and transcript lengths follow the corpus-like rows of the
JAX-era ``bench.py`` (``_realistic_rows``): duration uniform on the mix's
range; a transcript of ``CORPUS_TOKEN_DECILES`` tokens a full 30 s clip,
scaled by duration / 30.
"""

from __future__ import annotations

import numpy as np


def _strata(n: int) -> np.ndarray:
    """n quantile levels (i + 0.5) / n."""
    return (np.arange(n) + 0.5) / n


def _spread(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    """n values stratified over [lo, hi], in an order from ``rng``."""
    return rng.permutation(lo + (hi - lo) * _strata(n))


def _int_spread(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n integers stratified over [lo, hi] (inclusive), in an order from
    ``rng``."""
    return np.floor(_spread(rng, lo, hi + 1, n)).astype(np.int64).clip(lo, hi)


def corpus_tokens(deciles, u: np.ndarray) -> np.ndarray:
    """Transcript tokens of a full 30 s clip at quantile ``u`` of the
    corpus deciles."""
    return np.interp(u * 10.0, np.arange(11), deciles)


def row_rng(seed: int, *path: int) -> np.random.Generator:
    """A generator for one (run seed, stream, index...) path: independent
    streams for every batch, row and purpose, the same on every machine."""
    return np.random.default_rng([seed % (2 ** 63), *path])


# ---------------------------------------------------------------------------
# serving: batches of clips with a context prompt and a bias list
# ---------------------------------------------------------------------------

def serve_shapes(tr: dict) -> list[dict]:
    """The fixed row shapes of every serving batch."""
    rng = np.random.default_rng(tr["shape_seed"])
    n = tr["batch"]
    dur = _spread(rng, *tr["duration_s"], n)
    u = rng.permutation(_strata(n))
    toks = corpus_tokens(tr["corpus_token_deciles"], u)
    caps = np.clip(np.floor((toks - 1.0) * dur / 30.0), 1, tr["max_new"] - 1).astype(np.int64)
    ctx = _int_spread(rng, *tr["context_tokens"], n)
    words = _int_spread(rng, *tr["bias_words"], n)
    shapes = []
    for i in range(n):
        wl = rng.integers(tr["bias_word_tokens"][0], tr["bias_word_tokens"][1] + 1, words[i])
        shapes.append(dict(samples=int(round(dur[i] * tr["sample_rate"])), cap=int(caps[i]),
                           ctx=int(ctx[i]), word_lens=[int(x) for x in wl]))
    return shapes


def audio_clip(seed: int, stream: int, index: int, samples: int, rms: float) -> np.ndarray:
    """A clip of ``samples`` f32 samples of noise at ``rms``."""
    rng = row_rng(seed, 1, stream, index)
    return rng.standard_normal(samples, dtype=np.float32) * np.float32(rms)


AUDIO_SETS = 4


def audio_sets(tr: dict, shapes: list[dict], seed: int) -> list[list[np.ndarray]]:
    """``AUDIO_SETS`` sets of one clip per row shape; batch k takes set k
    modulo their number."""
    return [[audio_clip(seed, s, i, sh["samples"], tr["audio_rms"])
             for i, sh in enumerate(shapes)] for s in range(AUDIO_SETS)]


def text_ids(rng: np.random.Generator, tr: dict, n: int) -> list[int]:
    lo, hi = tr["text_token_range"]
    return [int(x) for x in rng.integers(lo, hi, n)]


def serve_batch(tr: dict, shapes: list[dict], seed: int, k: int) -> dict:
    """Batch ``k``: its rows' order (a permutation of the shapes), and for
    each row the context ids, the bias words, the token cap and the audio
    set's clip index."""
    rng = row_rng(seed, 2, k)
    order = rng.permutation(len(shapes))
    rows = []
    for i in order:
        sh = shapes[i]
        rows.append(dict(shape=int(i), cap=sh["cap"], ctx=text_ids(rng, tr, sh["ctx"]),
                         words=[text_ids(rng, tr, n) for n in sh["word_lens"]]))
    return dict(index=k, audio_set=k % AUDIO_SETS, rows=rows)


def dense_spans(words_per_row: list[list[list[int]]], pad_id: int) -> np.ndarray | None:
    """(B, N, K) int32 bias spans padded with ``pad_id``: the collator's
    layout; None where no row has a bias word."""
    n = max(len(w) for w in words_per_row)
    if n == 0:
        return None
    k = max(len(x) for w in words_per_row for x in w)
    out = np.full((len(words_per_row), n, k), pad_id, np.int32)
    for b, words in enumerate(words_per_row):
        for j, w in enumerate(words):
            out[b, j, :len(w)] = w
    return out


# ---------------------------------------------------------------------------
# training: steps of labelled 30 s windows with bias spans in the label
# ---------------------------------------------------------------------------

def train_shapes(tr: dict) -> list[dict]:
    """The fixed row shapes of every training step."""
    rng = np.random.default_rng(tr["shape_seed"])
    n = tr["rows_per_step"]
    dur = _spread(rng, *tr["duration_s"], n)
    u = rng.permutation(_strata(n))
    trans = np.maximum(1, np.round(corpus_tokens(tr["corpus_token_deciles"], u) * dur / 30.0))
    ctx = _int_spread(rng, *tr["context_tokens"], n)
    spans = _int_spread(rng, *tr["bias_spans"], n)
    shapes = []
    for i in range(n):
        lens = rng.integers(tr["bias_span_tokens"][0], tr["bias_span_tokens"][1] + 1, spans[i])
        shapes.append(dict(samples=int(round(dur[i] * tr["sample_rate"])),
                           transcript=int(trans[i]), ctx=int(ctx[i]),
                           span_lens=[int(x) for x in lens]))
    return shapes


def train_rows(tr: dict, shapes: list[dict], seed: int, k: int, tokens: dict) -> list[dict]:
    """The rows of step ``k``, in the step's order: audio, the full label
    sequence ``<|startofprev|> ctx <start...> transcript <|endoftext|>``
    (cut at ``max_label``) and bias spans, each a run of the transcript."""
    rng = row_rng(seed, 3, k)
    order = rng.permutation(len(shapes))
    rows = []
    for j, i in enumerate(order):
        sh = shapes[i]
        ctx = text_ids(rng, tr, sh["ctx"])
        trans = text_ids(rng, tr, sh["transcript"])
        label = ([tokens["sop"]] + ctx + list(tokens["prompt_start"]) + trans
                 + [tokens["eot"]])[:tr["max_label"]]
        spans = []
        for n in sh["span_lens"]:
            n = min(n, len(trans))
            at = int(rng.integers(0, len(trans) - n + 1))
            spans.append(trans[at:at + n])
        rows.append(dict(shape=int(i), label=label, spans=spans,
                         audio=audio_clip(seed, 100 + k, j, sh["samples"], tr["audio_rms"])))
    return rows
