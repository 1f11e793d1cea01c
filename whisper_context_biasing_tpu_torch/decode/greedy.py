"""Batched greedy decoding over a preallocated KV cache.

The counterpart of the JAX package's ``decode/greedy.py``: encode, precompute
(and optionally int8-quantize) the cross-attention K/V, prefill the
left-padded prefix (``<|startofprev|> ctx... <|sot|>``) into the cache, then
one cached decoder step per token with the bias-trie bonus, greedy argmax (or
temperature sampling) and a stop at <|endoftext|>. JAX runs the loop as one
``while_loop`` program; here it is a Python loop whose ``finished.all()``
check syncs with the host once per step. The cache has a static shape and is
written in place.

Each step's logits go through JAX's filter order: suppressed tokens, the
bias bonus, OpenAI's timestamp rules (``apply_timestamp_rules``), then the
pick, then the log-softmax of the filtered logits for ``sum_logprob``.
``no_speech_prob`` comes from the prefill logits at the ``<|sot|>`` position.

Under a (data, model) mesh the rows shard over "data" and the decode runs on
each rank's rows with its shard of the model (``decode_on_mesh``). The
collectives inside the loop are over "model" only: every rank of a model
group picks from the same gathered logits, so they agree on ``finished`` and
take the same steps. Ranks of "data" hold other rows and may stop at other
steps, so the gather over "data" comes once, after the loop.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.whisper import (
    Whisper,
    decode_tokens,
    encode_audio,
    init_kv_cache,
    kv_width,
    precompute_cross_kv,
    quantize_cross_kv,
)
from ..parallel.mesh import DATA_AXIS, axis_index
from ..parallel.sharding import gather_rows, shard_decode_inputs
from ..utils.compile_count import counted_jit
from .bias_processor import (
    advance_bias_state,
    bias_bonus,
    init_bias_state,
    sanitize_bias_spans,
    seed_bias_state_from_prefix,
)


NEG = torch.finfo(torch.float32).min


class GreedyResult(NamedTuple):
    tokens: torch.Tensor       # (B, max_new) int32, eot-padded after finish
    lengths: torch.Tensor      # (B,) int32 — tokens before (excl.) eot
    sum_logprob: torch.Tensor  # (B,) f32 — summed logprob of the emitted tokens
                               # (incl. the finishing eot); avg = sum/(length+1)
    no_speech_prob: torch.Tensor | None = None  # (B,) f32 — P(<|nospeech|>) at
                               # the <|sot|> input position (no_speech_id)
    margins: torch.Tensor | None = None  # (B, max_new) f32 — top-1 minus top-2
                               # logit at each pick (return_margins=True)
    spec_rounds: int | None = None  # verify rounds of a speculative or Medusa
                               # decode (decode/speculative.py, decode/medusa.py)


def pack_prefixes(
    prefixes: list[list[int]], pad_id: int, pad_to_multiple: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad variable-length decoder prefixes to a common length.
    Returns (ids (B, P), mask (B, P)); mask False marks pads.
    ``pad_to_multiple`` buckets the length."""
    p = max(len(x) for x in prefixes)
    if pad_to_multiple:
        p = ((p + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    ids = np.full((len(prefixes), p), pad_id, dtype=np.int32)
    mask = np.zeros((len(prefixes), p), dtype=bool)
    for i, x in enumerate(prefixes):
        ids[i, p - len(x):] = x
        mask[i, p - len(x):] = True
    return ids, mask


def apply_timestamp_rules(
    lg: torch.Tensor,        # (B, V) f32 logits, post-suppress/bias
    prev1: torch.Tensor,     # (B,) last GENERATED token (-1 = none yet)
    prev2: torch.Tensor,     # (B,) token before that (-1 = none)
    last_ts: torch.Tensor,   # (B,) most recent timestamp token (0 = none)
    *,
    timestamp_begin: int,
    eot_id: int,
    is_first: bool,
    max_initial_timestamp_index: int | None,
) -> torch.Tensor:
    """OpenAI Whisper's ApplyTimestampRules as pure masks (the JAX package's
    ``apply_timestamp_rules``): timestamps come in pairs (a lone timestamp
    is followed by another or by <|endoftext|>, a closed pair by text), never
    decrease, the first generated token is a timestamp no later than
    ``max_initial_timestamp_index``, and when the probability mass on
    timestamps beats every text token the step must pick a timestamp."""
    v = lg.shape[1]
    col = torch.arange(v, device=lg.device)
    ts_cols = col >= timestamp_begin
    lg = lg.clone()
    # <|notimestamps|> sits right below <|0.00|>; never emit it here
    lg[:, timestamp_begin - 1] = NEG
    if is_first:
        lg = lg.masked_fill(~ts_cols, NEG)
        if max_initial_timestamp_index is not None:
            lg = lg.masked_fill(col > timestamp_begin + max_initial_timestamp_index, NEG)
    else:
        last_was = prev1 >= timestamp_begin
        # "fewer than two generated tokens" counts as a timestamp
        pen_was = (prev2 < 0) | (prev2 >= timestamp_begin)
        # closed pair -> text next; lone timestamp -> timestamp or eot
        lg = lg.masked_fill((last_was & pen_was)[:, None] & ts_cols, NEG)
        lg = lg.masked_fill((last_was & ~pen_was)[:, None] & (col < eot_id), NEG)
        # monotonic: completing a pair may repeat the value, else increase
        has_ts = last_ts >= timestamp_begin
        bound = torch.where(last_was & ~pen_was, last_ts, last_ts + 1)
        lg = lg.masked_fill(has_ts[:, None] & ts_cols & (col < bound[:, None]), NEG)
    # probability rule (OpenAI masks everything below timestamp_begin, eot too)
    logprobs = torch.log_softmax(lg, dim=-1)
    ts_lp = torch.logsumexp(logprobs[:, timestamp_begin:], dim=-1)
    max_txt = logprobs[:, :timestamp_begin].max(dim=-1).values
    return lg.masked_fill((ts_lp > max_txt)[:, None] & ~ts_cols, NEG)


def sample_tokens(lg: torch.Tensor, temperature: float, u: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(lg / temperature)``, by the inverse
    CDF of ``u`` (B,), uniforms in [0, 1) (``RowDraws``). A token of
    probability 0 is never drawn. The draws are torch's, so for one seed
    they differ from ``jax.random.categorical``'s; the distribution is the
    same."""
    probs = torch.softmax(lg / temperature, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    # the first token whose CDF passes u: never a zero-probability one
    pick = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None].contiguous(), right=True)[:, 0]
    last = probs.shape[-1] - 1 - (probs > 0).flip(-1).to(torch.int32).argmax(dim=-1)
    return torch.minimum(pick, last)


def call_seed(generator: torch.Generator | None) -> int:
    """The seed of one sampled decode call, drawn from the caller's
    generator (0 without one): one draw a call, so every rank of a mesh
    draws the same seed however long its loops ran."""
    if generator is None:
        return 0
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))


class RowDraws:
    """The uniforms of a sampled decode: at step t, the t-th draw of
    ``n_global`` values from a generator seeded with the call's seed, of
    which the rows ``row_offset ..`` are this call's (rows past the global
    batch, a mesh's padding, take the last row's). So a row's draw depends on
    the seed, the step and its index in the whole batch, never on the rank
    that holds it; rows do not share uniforms."""

    def __init__(self, seed: int, b: int, row_offset: int, n_global: int | None, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.n = n_global or b
        self.rows = torch.clamp(torch.arange(b, device=device) + row_offset, max=self.n - 1)
        self.device = device

    def next(self) -> torch.Tensor:
        return torch.rand(self.n, generator=self.gen, device=self.device)[self.rows]


def sot_offsets(sot_offset, b: int, device) -> torch.Tensor:
    """``sot_offset`` (an int or per-row ints) as a (B,) int64 tensor."""
    off = sot_offset if isinstance(sot_offset, torch.Tensor) else torch.as_tensor(
        np.asarray(sot_offset))
    return torch.broadcast_to(off.to(device=device, dtype=torch.int64), (b,))


class Clock:
    """Named time marks: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: dict = {}

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        else:
            self.marks[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        if self.cuda:
            self.marks[b].synchronize()
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def decode_on_mesh(decode, mesh, model, input_features, prefix_ids, prefix_mask, kw: dict,
                   draws: bool = False):
    """``decode(model, feats, ids, mask, **kw)`` on this rank's rows: the
    batch (and every per-row argument of ``kw``: bias spans, forced-eot
    caps, per-row sot offsets, a draft's own mel) padded to a multiple of
    "data" by repeating its first row and split (``shard_decode_inputs``;
    an input given as ``LocalRows`` is already split); each tensor of the
    result gathered over "data" on every rank and the padding stripped.
    ``draws``: ``decode`` takes ``row_offset`` and ``global_rows``, the
    rank's first row and the batch size, for its random draws."""
    rows = {k: kw[k] for k in ("bias_spans", "forced_eot_at", "sot_offset",
                               "input_features_draft")
            if kw.get(k) is not None and np.ndim(kw[k]) >= 1}
    (feats, ids, mask, *local), b = shard_decode_inputs(
        mesh, input_features, prefix_ids, prefix_mask, *rows.values())
    kw = {**kw, **dict(zip(rows, local))}
    if draws:
        kw.update(row_offset=axis_index(mesh, DATA_AXIS) * ids.shape[0], global_rows=b)
    res = decode(model, feats, ids, mask, **kw)
    return type(res)(*(gather_rows(f, mesh, b) if isinstance(f, torch.Tensor) else f
                       for f in res))


@counted_jit
def greedy_decode(
    model: Whisper,
    input_features,
    prefix_ids,
    prefix_mask,
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,
    bias_boost: float = 0.0,
    span_pad_id: int = 50256,
    forced_eot_at=None,
    temperature: float = 0.0,
    suppress_tokens: tuple[int, ...] = (),
    generator: torch.Generator | None = None,
    no_speech_id: int | None = None,
    sot_offset=1,
    timestamp_begin: int | None = None,
    max_initial_timestamp_index: int | None = 50,
    device="cuda",
    timings: dict | None = None,
    return_margins: bool = False,
    mesh=None,
) -> GreedyResult:
    """Batched greedy decode (``_greedy_decode`` has the arguments).
    ``mesh``: the rows shard over its "data" axis and ``model`` is this
    rank's shard (``parallel.shard_params``); the result is the whole
    batch's on every rank. The call signatures are counted
    (``greedy_decode.cache_size()``), as the JAX package counts its
    programs."""
    kw = {k: v for k, v in locals().items()
          if k not in ("model", "input_features", "prefix_ids", "prefix_mask", "mesh")}
    if mesh is not None:
        return decode_on_mesh(_greedy_decode, mesh, model, input_features, prefix_ids,
                              prefix_mask, kw, draws=True)
    return _greedy_decode(model, input_features, prefix_ids, prefix_mask, **kw)


@torch.no_grad()
def _greedy_decode(
    model: Whisper,
    input_features,              # (B, n_mels, 2*n_audio_ctx) f32
    prefix_ids,                  # (B, P) int, left-padded
    prefix_mask,                 # (B, P) bool
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,             # (B, N, K) int32 or None
    bias_boost: float = 0.0,
    span_pad_id: int = 50256,
    forced_eot_at=None,          # (B,) int — generation index >= it emits eot
    temperature: float = 0.0,
    suppress_tokens: tuple[int, ...] = (),
    generator: torch.Generator | None = None,  # on the decode device
    no_speech_id: int | None = None,
    sot_offset=1,                # int or (B,) — <|sot|> position from the end
    timestamp_begin: int | None = None,   # OpenAI's timestamp rules on
    max_initial_timestamp_index: int | None = 50,  # <= 1.0 s, OpenAI default
    device="cuda",
    timings: dict | None = None,  # filled with encode_ms, prefill_ms,
                                  # decode_ms and steps when given
    return_margins: bool = False,
    row_offset: int = 0,          # under a mesh: this rank's first row and
    global_rows: int | None = None,  # the whole batch (decode_on_mesh)
) -> GreedyResult:
    """Batched greedy decode. The prefix must end with the token the model
    should continue from (``[<|sot|>]``, or ``[<|sop|>, ctx..., <|sot|>]``
    for prompted decode). Returns tokens, lengths and summed logprobs.

    ``temperature > 0`` samples from ``softmax(logits / temperature)``: the
    call draws its seed from ``generator`` (a ``torch.Generator``; seed 0
    when None) and each step's uniforms from it (``RowDraws``), so a row's
    draw does not depend on how a mesh shards the batch; the draws differ
    from ``jax.random``'s for one seed.
    ``suppress_tokens`` are masked every step. ``no_speech_id`` adds
    ``no_speech_prob`` from the prefill logits ``sot_offset`` tokens from the
    end of the prefix (1 for ``[<|sot|>]``, 3 for ``[sot, lang, task]``; a
    (B,) value when rows start differently). ``timestamp_begin`` turns on the
    timestamp rules."""
    device = resolve_device(device)
    if next(model.parameters()).device != device:
        raise ValueError(f"model is on {next(model.parameters()).device}, decode asked for {device}")
    cfg = model.cfg
    feats = _as_tensor(input_features, device, torch.float32)
    ids = _as_tensor(prefix_ids, device, torch.int64)
    mask = _as_tensor(prefix_mask, device, torch.bool)
    b, p = ids.shape
    # prompt + new tokens share the n_text_ctx window
    max_new = min(max_new, cfg.n_text_ctx - p)
    if max_new < 1:
        raise ValueError(f"prefix length {p} leaves no room to generate "
                         f"(n_text_ctx {cfg.n_text_ctx})")
    clock = Clock(device) if timings is not None else None
    if clock:
        clock.mark("start")

    enc_out = encode_audio(model, feats)
    if clock:
        clock.mark("encoded")
    cross_kv = precompute_cross_kv(model, enc_out)
    if cfg.quantize_cross_kv:
        cross_kv = quantize_cross_kv(cross_kv, tp=model.tp)
    cache = init_kv_cache(cfg, b, p + max_new, device, width=kv_width(model))

    # positions: pads don't advance the position counter (left-pad support)
    prefix_pos = torch.clamp(torch.cumsum(mask.to(torch.int64), dim=1) - 1, min=0)
    key_mask = torch.cat([mask, torch.ones((b, max_new), dtype=torch.bool, device=device)], 1)
    logits, cache = decode_tokens(model, ids, cross_kv=cross_kv, cache=cache, pos_offset=0,
                                  token_positions=prefix_pos, self_mask=key_mask)
    pos = prefix_pos[:, -1] + 1  # (B,)

    no_speech_prob = None
    if no_speech_id is not None:
        sot_lg = logits[torch.arange(b, device=device), p - sot_offsets(sot_offset, b, device)]
        no_speech_prob = torch.softmax(sot_lg.float(), dim=-1)[:, no_speech_id]

    use_bias = bias_spans is not None and bias_boost != 0.0
    spans = (torch.zeros((b, 1, 1), dtype=torch.int32, device=device) if bias_spans is None
             else _as_tensor(bias_spans, device, torch.int32))
    bias_state = init_bias_state(spans, span_pad_id)
    if use_bias:
        # the conditioning context may end mid-bias-word: warm-start the trie
        bias_state = seed_bias_state_from_prefix(bias_state, spans, ids, mask)
    forced_at = None if forced_eot_at is None else _as_tensor(forced_eot_at, device, torch.int64)

    margins = (torch.zeros((b, max_new), dtype=torch.float32, device=device)
               if return_margins else None)
    suppress = (torch.as_tensor(suppress_tokens, dtype=torch.int64, device=device)
                if suppress_tokens else None)
    row_draws = (RowDraws(call_seed(generator), b, row_offset, global_rows, device)
                 if temperature > 0.0 else None)

    def pick(lg, state, t, ts_state):
        lg = lg.float()
        if suppress is not None:
            lg = lg.index_fill(1, suppress, NEG)
        if use_bias:
            lg = lg + bias_bonus(state, spans, cfg.n_vocab, bias_boost)
        if timestamp_begin is not None:
            lg = apply_timestamp_rules(
                lg, *ts_state, timestamp_begin=timestamp_begin, eot_id=eot_id, is_first=t == 0,
                max_initial_timestamp_index=max_initial_timestamp_index)
        if temperature > 0.0:
            nxt = sample_tokens(lg, temperature, row_draws.next())
        else:
            nxt = torch.argmax(lg, dim=-1)
        logp = torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None])[:, 0]
        if margins is not None:
            top2 = lg.topk(2, dim=-1).values
            margins[:, t] = top2[:, 0] - top2[:, 1]
        return nxt, logp

    none = torch.full((b,), -1, dtype=torch.int64, device=device)  # no generated token yet
    cur, sum_lp = pick(logits[:, -1], bias_state, 0, (none, none, torch.zeros_like(none)))
    if forced_at is not None:
        # the cap overrides the model's pick and its logprob doesn't count
        forced0 = forced_at <= 0
        cur = torch.where(forced0, eot_id, cur)
        sum_lp = torch.where(forced0, 0.0, sum_lp)
    out = torch.full((b, max_new), eot_id, dtype=torch.int64, device=device)
    out[:, 0] = cur
    finished = cur == eot_id
    if use_bias:
        bias_state = advance_bias_state(bias_state, spans, cur)
    # timestamp-rule row state: the generated token before cur, the last timestamp
    prev = none
    last_ts = torch.zeros_like(none)
    if timestamp_begin is not None:
        last_ts = torch.where(cur >= timestamp_begin, cur, last_ts)
    if clock:
        clock.mark("prefilled")

    t = 1
    while t < max_new and not bool(finished.all()):
        lg, cache = decode_tokens(model, cur[:, None], cross_kv=cross_kv, cache=cache,
                                  pos_offset=p - 1 + t, token_positions=pos[:, None],
                                  self_mask=key_mask)
        nxt, lp = pick(lg[:, -1], bias_state, t, (cur, prev, last_ts))
        if forced_at is not None:
            forced = t >= forced_at
            nxt = torch.where(forced, eot_id, nxt)
            lp = torch.where(forced, 0.0, lp)
        nxt = torch.where(finished, eot_id, nxt)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        out[:, t] = nxt
        finished = finished | (nxt == eot_id)
        if use_bias:
            bias_state = advance_bias_state(bias_state, spans, nxt)
        if timestamp_begin is not None:
            last_ts = torch.where(nxt >= timestamp_begin, nxt, last_ts)
        prev, cur, pos, t = cur, nxt, pos + 1, t + 1

    lengths = torch.cumprod((out != eot_id).to(torch.int32), dim=1).sum(dim=1)
    if clock:
        clock.mark("done")
        timings.update(encode_ms=clock.ms("start", "encoded"),
                       prefill_ms=clock.ms("encoded", "prefilled"),
                       decode_ms=clock.ms("prefilled", "done"), steps=t - 1)
    return GreedyResult(out.to(torch.int32), lengths.to(torch.int32), sum_lp, no_speech_prob,
                        margins=margins)


def build_prefixes(tokenizer, b: int, contexts=None, starts=None,
                   include_notimestamps: bool = False) -> list[list[int]]:
    """Per-row decoder prefixes: the start sequence (``[<|sot|>]``, the
    tokenizer's prefix with ``include_notimestamps``, or ``starts[i]``),
    after ``<|sop|> + context`` where a row has a context (an empty context
    means unprompted for that row)."""
    if starts is None:
        starts = [tokenizer.prefix_tokens if include_notimestamps else [tokenizer.sot]] * b
    if contexts is None:
        return [list(st) for st in starts]
    return [([tokenizer.sop] + list(c) + list(st)) if c else list(st)
            for c, st in zip(contexts, starts)]


def decode_batch(
    model: Whisper,
    tokenizer,
    input_features,
    contexts: list[list[int]] | None = None,
    max_new: int = 224,
    bias_spans=None,
    bias_boost: float = 0.0,
    include_notimestamps: bool = False,
    pad_to_multiple: int | None = None,
    device="cuda",
    timings: dict | None = None,
    starts: list[list[int]] | None = None,
    mesh=None,
) -> list[list[int]]:
    """Host-side convenience: build prefixes (``[<|sot|>]`` start, with
    ``<|sop|> + context`` conditioning where a row has a context), run the
    greedy loop, and strip to finished token lists (without the prefix).
    ``starts``: per-row start sequences in place of the default (e.g.
    ``[sot, <|fr|>, <|transcribe|>]`` after language detection). ``mesh``
    shards the rows over "data" (``greedy_decode``)."""
    b = input_features.shape[0]
    prefixes = build_prefixes(tokenizer, b, contexts, starts, include_notimestamps)
    ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=pad_to_multiple)
    res = greedy_decode(
        model, input_features, ids, mask, max_new=max_new, eot_id=tokenizer.eot,
        bias_spans=sanitize_bias_spans(bias_spans), bias_boost=bias_boost,
        span_pad_id=tokenizer.eot, device=device, timings=timings, mesh=mesh)
    toks = res.tokens.cpu().numpy()
    lens = res.lengths.cpu().numpy()
    return [toks[i, : lens[i]].tolist() for i in range(b)]
