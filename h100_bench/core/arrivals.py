"""Open-loop arrivals and request payloads for the server kind, from a mix's
parameters (``traffic/<name>.json`` of ``"kind": "server"``).

The arrival schedule of each phase (the set-up's ramp, the window, the
traced segment) comes from the mix's ``shape_seed`` alone: every run seed
gets the same due times. Gaps are exponential at ``rate_per_s`` (Poisson
arrivals) or, with ``"arrivals": "gamma"``, Gamma-distributed of shape
``gamma_shape`` with the same mean (a coefficient of variation of
1 / sqrt(shape)).

Each arrival is one request of one of the serving mix's row shapes
(``core/traffic.py:serve_shapes``: clip duration, token cap, context and
bias-word lengths). Arrival j of a phase takes shape ``perm[j % n]`` of
the permutation drawn for its block ``j // n``, so every n consecutive
arrivals hold each shape once and the window's sizes hardly move with the
seed. The run seed orders the shapes and draws the text: a context of
``ctx`` lowercase letters and spaces, and bias words of ``word_lens``
lowercase letters. The offline byte-level vocabulary gives a byte one
token, so the reference's ids are the bytes themselves.
"""

from __future__ import annotations

import numpy as np

from .traffic import AUDIO_SETS, row_rng

PHASES = {"ramp": 0, "window": 1, "trace": 2, "warm": 3}
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
CONTEXT_BYTES = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)


def due_times(tr: dict, phase: str, seconds: float) -> np.ndarray:
    """Due offsets in [0, seconds) of ``phase``'s arrivals, from the mix's
    ``shape_seed``, its ``rate_per_s`` and its ``arrivals`` law."""
    rng = np.random.default_rng([tr["shape_seed"], 7, PHASES[phase]])
    rate = float(tr["rate_per_s"])
    n = int(seconds * rate * 2 + 64)
    if tr.get("arrivals", "poisson") == "gamma":
        k = float(tr["gamma_shape"])
        gaps = rng.gamma(k, 1.0 / (k * rate), n)
    else:
        gaps = rng.exponential(1.0 / rate, n)
    at = np.cumsum(gaps)
    if at[-1] < seconds:  # twice the expected count of gaps falls short
        raise ValueError(f"{n} gaps cover {at[-1]:.1f} s of {seconds} s")
    return at[at < seconds]


def _text(rng: np.random.Generator, alphabet: np.ndarray, n: int) -> str:
    return alphabet[rng.integers(0, len(alphabet), n)].tobytes().decode()


def request(tr: dict, shapes: list[dict], seed: int, phase: str, j: int,
            shape: int | None = None) -> dict:
    """Arrival ``j`` of ``phase``: its row shape, audio set, context and bias
    words (``shape`` forces a shape, for the set-up's warm requests)."""
    n = len(shapes)
    block = j // n
    if shape is None:
        perm = row_rng(seed, 20, PHASES[phase], block).permutation(n)
        shape = int(perm[j % n])
    sh = shapes[shape]
    rng = row_rng(seed, 21, PHASES[phase], j)
    context = _text(rng, CONTEXT_BYTES, sh["ctx"]) if sh["ctx"] else None
    words = [_text(rng, LETTERS, k) for k in sh["word_lens"]]
    return dict(phase=phase, index=j, shape=shape, audio_set=block % AUDIO_SETS,
                cap=sh["cap"], context=context, words=words)


def expected_prefix(req: dict, tok: dict) -> list[int]:
    """The decoder prefix of a request as the reference works it out:
    <|startofprev|> and the context's bytes where it has one, then
    <|startoftranscript|>."""
    ctx = list(req["context"].lower().encode()) if req["context"] else []
    return ([tok["sop"]] + ctx if ctx else []) + [tok["sot"]]


def expected_words(req: dict) -> list[list[int]]:
    """The request's bias words as byte ids, as the reference tokenizes them."""
    return [list(w.strip().lower().encode()) for w in req["words"] if w.strip()]


def expected_text(served: list[int], eot: int) -> str:
    """The text of served ids in the offline byte-level vocabulary: ids
    under 256 are bytes, ids up to <|endoftext|> are the vocabulary's
    unused fillers ``<unused_i>``, and the special and timestamp ids above
    are skipped; decoded as UTF-8 with replacement, stripped."""
    out = bytearray()
    for i in served:
        if i < 256:
            out.append(i)
        elif i < eot:
            out += f"<unused_{i}>".encode()
    return out.decode("utf-8", errors="replace").strip()
