"""Beam-search decoding over a preallocated KV cache.

The counterpart of the JAX package's ``decode/beam.py``. Beams are
flattened into the batch axis for the cached decoder step, so K3 runs on
B x K rows. Cross-attention K/V are projected (and int8-quantized) once per
utterance, then repeated K times. After each top-k the (L, B*K, T, D)
self-attention cache is gathered along its row axis into a twin buffer and
the two swap, so the gather never reads what it writes. Finished beams are
frozen (forced <|endoftext|> at zero cost); the bias trie advances per beam
with its score-exact adjustment added before the top-k; OpenAI's timestamp
rules apply per beam before the log-softmax.

``early_stopping="off"`` is the frozen-pool scorer; ``"true"``, ``"false"``
and ``"never"`` follow HF ``BeamSearchScorer`` (``_hf_beam_loop``). Top-k
breaks ties as ``jax.lax.top_k`` does, the lower index first (``top_k``).
Under a mesh the rows shard over "data" as in ``greedy_decode``
(``decode_on_mesh``): the model group's ranks expand beams from the same
gathered logits, so they take the same steps.
"""

from __future__ import annotations

from typing import NamedTuple

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
from ..utils.compile_count import counted_jit
from ..utils.profiling import Clock
from .bias_processor import (
    BiasTrieState,
    advance_bias_state,
    bias_score_adjust,
    init_bias_state,
    sanitize_bias_spans,
    seed_bias_state_from_prefix,
)
from .greedy import (
    _as_tensor,
    apply_timestamp_rules,
    build_prefixes,
    decode_on_mesh,
    pack_prefixes,
    sot_offsets,
)

NEG_INF = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, K, max_new) int32, eot-padded
    scores: torch.Tensor   # (B, K) cumulative logprob (HF modes: the pool's penalized scores)
    lengths: torch.Tensor  # (B, K) tokens before eot (HF modes: generated, eot included)
    best: torch.Tensor     # (B, max_new) best beam per batch row
    no_speech_prob: torch.Tensor | None = None  # (B,) f32, as GreedyResult's


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of f32 ``x``: the k largest in
    descending order, equal values lower index first. ``torch.topk`` leaves
    the order of ties open, so the topk runs on int64 keys that order by value
    (the f32 bits mapped to a monotonic int32) and then by lower index."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + (0xFFFFFFFF - idx)
    sel = torch.topk(keys, k, dim=-1).indices
    return x.gather(-1, sel), sel


class _Beams:
    """Per-row shapes and the reorder of everything that lives per beam;
    with a ``clock`` each cache reorder is timed (CUDA events on a card)."""

    def __init__(self, b: int, k: int, cache: dict, clock: Clock | None):
        self.cache = cache
        self.spare = {n: torch.empty_like(t) for n, t in cache.items()}
        self.base = torch.arange(b, device=cache["k"].device)[:, None] * k
        self.clock = clock
        self.reorders = 0

    def flat(self, beam_idx: torch.Tensor) -> torch.Tensor:
        return (self.base + beam_idx).reshape(-1)

    def gather_bk(self, a: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
        """Gather a (B*K, ...) per-beam tensor by the (B, K) parent selection."""
        return a.index_select(0, self.flat(beam_idx))

    def reorder(self, state: BiasTrieState, pos: torch.Tensor, beam_idx: torch.Tensor):
        """Cache rows into the twin buffer (then swap), trie state and positions."""
        flat = self.flat(beam_idx)
        if self.clock:
            self.clock.mark(f"reorder{self.reorders}")
        for n, t in self.cache.items():
            torch.index_select(t, 1, flat, out=self.spare[n])
        self.cache, self.spare = self.spare, self.cache
        if self.clock:
            self.clock.mark(f"reordered{self.reorders}")
        self.reorders += 1
        state = BiasTrieState(state.matched.index_select(0, flat),
                              state.span_len.index_select(0, flat))
        return state, pos.index_select(0, flat)

    def reorder_ms(self) -> float:
        return sum(self.clock.ms(f"reorder{i}", f"reordered{i}") for i in range(self.reorders))


@counted_jit
def beam_decode(
    model: Whisper,
    input_features,
    prefix_ids,
    prefix_mask,
    num_beams: int = 5,
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,
    bias_boost: float = 0.0,
    length_penalty: float = 1.0,
    span_pad_id: int = 50256,
    early_stopping: str = "off",
    no_speech_id: int | None = None,
    sot_offset=1,
    timestamp_begin: int | None = None,
    max_initial_timestamp_index: int | None = 50,
    device="cuda",
    timings: dict | None = None,
    mesh=None,
) -> BeamResult:
    """Beam search (``_beam_decode`` has the arguments). ``mesh``: the rows
    shard over its "data" axis and ``model`` is this rank's shard; the
    result is the whole batch's on every rank. The call signatures are
    counted (``beam_decode.cache_size()``)."""
    kw = {k: v for k, v in locals().items()
          if k not in ("model", "input_features", "prefix_ids", "prefix_mask", "mesh")}
    if mesh is not None:
        return decode_on_mesh(_beam_decode, mesh, model, input_features, prefix_ids,
                              prefix_mask, kw)
    return _beam_decode(model, input_features, prefix_ids, prefix_mask, **kw)


@torch.no_grad()
def _beam_decode(
    model: Whisper,
    input_features,              # (B, n_mels, frames)
    prefix_ids,                  # (B, P) int, left-padded
    prefix_mask,                 # (B, P) bool
    num_beams: int = 5,
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,             # (B, N, Kspan)
    bias_boost: float = 0.0,
    length_penalty: float = 1.0,
    span_pad_id: int = 50256,
    early_stopping: str = "off",
    no_speech_id: int | None = None,
    sot_offset=1,                # int or (B,) — <|sot|> position from the prefix end
    timestamp_begin: int | None = None,  # OpenAI's timestamp rules per beam
    max_initial_timestamp_index: int | None = 50,
    device="cuda",
    timings: dict | None = None,  # filled with encode_ms, prefill_ms, decode_ms,
                                  # reorder_ms (the cache reorders) and steps
) -> BeamResult:
    """``early_stopping="off"`` (default): finished beams stay in the pool
    frozen at zero incremental cost until every beam has finished.
    ``"true"``/``"false"``/``"never"``: HF ``generate(num_beams=k)`` semantics
    (``_hf_beam_loop``); then ``scores`` are the pool's length-penalized
    scores and ``lengths`` count generated tokens including <|eot|>."""
    if early_stopping not in ("off", "true", "false", "never"):
        raise ValueError(f"early_stopping must be off/true/false/never, got {early_stopping!r}")
    device = resolve_device(device)
    if next(model.parameters()).device != device:
        raise ValueError(f"model is on {next(model.parameters()).device}, decode asked for {device}")
    cfg = model.cfg
    feats = _as_tensor(input_features, device, torch.float32)
    ids = _as_tensor(prefix_ids, device, torch.int64)
    mask = _as_tensor(prefix_mask, device, torch.bool)
    b, p = ids.shape
    k, v = num_beams, cfg.n_vocab
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
    # project once per utterance, then repeat across beams
    ck, cv = precompute_cross_kv(model, enc_out)
    if cfg.quantize_cross_kv:
        cross_kv = {n: t.repeat_interleave(k, dim=1)
                    for n, t in quantize_cross_kv((ck, cv), tp=model.tp).items()}
    else:
        cross_kv = (ck.repeat_interleave(k, dim=1), cv.repeat_interleave(k, dim=1))
    ids_t = ids.repeat_interleave(k, dim=0)
    mask_t = mask.repeat_interleave(k, dim=0)
    beams = _Beams(b, k, init_kv_cache(cfg, b * k, p + max_new, device, width=kv_width(model)),
                   clock)
    prefix_pos = torch.clamp(torch.cumsum(mask_t.to(torch.int64), dim=1) - 1, min=0)
    key_mask = torch.cat([mask_t, torch.ones((b * k, max_new), dtype=torch.bool,
                                             device=device)], 1)
    logits, _ = decode_tokens(model, ids_t, cross_kv=cross_kv, cache=beams.cache, pos_offset=0,
                              token_positions=prefix_pos, self_mask=key_mask)
    pos = prefix_pos[:, -1] + 1  # (B*K,)

    no_speech_prob = None
    if no_speech_id is not None:
        # beam 0 of each row (the k copies are identical)
        rows = torch.arange(b, device=device) * k
        sot_lg = logits[rows, p - sot_offsets(sot_offset, b, device)]
        no_speech_prob = torch.softmax(sot_lg.float(), dim=-1)[:, no_speech_id]

    use_bias = bias_spans is not None and bias_boost != 0.0
    spans = (torch.zeros((b, 1, 1), dtype=torch.int32, device=device) if bias_spans is None
             else _as_tensor(bias_spans, device, torch.int32))
    spans_t = spans.repeat_interleave(k, dim=0)
    state = init_bias_state(spans_t, span_pad_id)
    if use_bias:
        # seeded credit is deliberate: a span begun in the context nets
        # boost*(len - seeded) when completed (JAX beam.py)
        state = seed_bias_state_from_prefix(state, spans_t, ids_t, mask_t)

    def step_logprobs(step_logits, state, frozen_rows, ts_state, is_first=False):
        """(B*K, V) log-probs for candidate expansion: timestamp rules on the
        logits, log-softmax, the score-exact bias adjustment; frozen rows may
        only emit eot, at zero cost."""
        lg = step_logits.float()
        if timestamp_begin is not None:
            lg = apply_timestamp_rules(
                lg, *ts_state, timestamp_begin=timestamp_begin, eot_id=eot_id,
                is_first=is_first, max_initial_timestamp_index=max_initial_timestamp_index)
        lp = torch.log_softmax(lg, dim=-1)
        if use_bias:
            lp = lp + bias_score_adjust(state, spans_t, v, bias_boost)
        frozen = torch.full_like(lp, NEG_INF)
        frozen[:, eot_id] = 0.0
        return torch.where(frozen_rows[:, None], frozen, lp)

    def step(cur, pos, t):
        lg, _ = decode_tokens(model, cur[:, None], cross_kv=cross_kv, cache=beams.cache,
                              pos_offset=p - 1 + t, token_positions=pos[:, None],
                              self_mask=key_mask)
        return lg[:, -1]

    def update_ts(token_flat, last_ts):
        if timestamp_begin is None:
            return last_ts
        return torch.where(token_flat >= timestamp_begin, token_flat, last_ts)

    none = torch.full((b * k,), -1, dtype=torch.int64, device=device)
    ts0 = torch.zeros_like(none)
    init_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    init_scores[:, 0] = 0.0  # first expansion: only beam 0 contributes
    lp0 = step_logprobs(logits[:, -1], state, torch.zeros(b * k, dtype=torch.bool, device=device),
                        (none, none, ts0), is_first=True)
    if clock:
        clock.mark("prefilled")
    if early_stopping != "off":
        res, t = _hf_beam_loop(beams, step, step_logprobs, update_ts, lp0, init_scores, state,
                               pos, spans_t, use_bias, none, ts0, b=b, k=k, v=v,
                               max_new=max_new, eot_id=eot_id, length_penalty=length_penalty,
                               early_stopping=early_stopping)
    else:
        res, t = _frozen_pool_loop(beams, step, step_logprobs, update_ts, lp0, init_scores,
                                   state, pos, spans_t, use_bias, none, ts0, b=b, k=k, v=v,
                                   max_new=max_new, eot_id=eot_id,
                                   length_penalty=length_penalty)
    res = res._replace(no_speech_prob=no_speech_prob)
    if clock:
        clock.mark("done")
        timings.update(encode_ms=clock.ms("start", "encoded"),
                       prefill_ms=clock.ms("encoded", "prefilled"),
                       decode_ms=clock.ms("prefilled", "done"), steps=t - 1,
                       reorder_ms=beams.reorder_ms())
    return res


def _frozen_pool_loop(beams, step, step_logprobs, update_ts, lp0, init_scores, state, pos,
                      spans_t, use_bias, none, ts0, *, b, k, v, max_new, eot_id,
                      length_penalty):
    """The in-pool frozen-beam search: finished beams compete in the top-k at
    zero incremental cost until every beam has finished."""
    device = lp0.device
    cand = init_scores.reshape(b * k, 1) + lp0
    scores, flat_idx = top_k(cand.reshape(b, k * v), k)  # (B, K)
    beam_idx = flat_idx // v
    token = flat_idx % v
    state, pos = beams.reorder(state, pos, beam_idx)
    cur = token.reshape(b * k)
    finished = cur == eot_id
    out = torch.full((b, k, max_new), eot_id, dtype=torch.int64, device=device)
    out[:, :, 0] = token
    if use_bias:
        state = advance_bias_state(state, spans_t, cur)
    prev, last_ts = none, update_ts(cur, ts0)

    t = 1
    while t < max_new and not bool(finished.all()):
        lp = step_logprobs(step(cur, pos, t), state, finished, (cur, prev, last_ts))
        cand = scores.reshape(b * k, 1) + lp
        scores, flat_idx = top_k(cand.reshape(b, k * v), k)
        beam_idx = flat_idx // v
        token = flat_idx % v
        state, pos = beams.reorder(state, pos, beam_idx)
        fin = finished.reshape(b, k).gather(1, beam_idx)
        out = out.gather(1, beam_idx[:, :, None].expand(-1, -1, max_new))
        out[:, :, t] = token
        token_flat = token.reshape(b * k)
        finished = fin.reshape(b * k) | (token_flat == eot_id)
        if use_bias:
            state = advance_bias_state(state, spans_t, token_flat)
        # timestamp state follows the selected parent beam
        prev = beams.gather_bk(cur, beam_idx)
        last_ts = update_ts(token_flat, beams.gather_bk(last_ts, beam_idx))
        cur, pos, t = token_flat, pos + 1, t + 1

    lengths = torch.cumprod((out != eot_id).to(torch.int32), dim=2).sum(dim=2)
    penal = scores / torch.clamp(lengths, min=1).to(torch.float32) ** length_penalty
    best_idx = torch.argmax(penal, dim=1)
    best = out.gather(1, best_idx[:, None, None].expand(-1, 1, max_new))[:, 0]
    return BeamResult(out.to(torch.int32), scores, lengths.to(torch.int32),
                      best.to(torch.int32)), t


def _hf_beam_loop(beams, step, step_logprobs, update_ts, lp0, init_scores, state, pos,
                  spans_t, use_bias, none, ts0, *, b, k, v, max_new, eot_id, length_penalty,
                  early_stopping):
    """HF ``BeamSearchScorer.process``/``finalize`` semantics: 2k candidates
    per step; <|eot|> candidates ranked within the top k enter a k-slot
    finished pool with score ``cum_logprob / gen_len**length_penalty``
    (gen_len counts the <|eot|>); live beams refill from the leading non-eot
    candidates; a row is done per the early-stopping rule, checked after
    insertion against the step's best raw score. At ``max_new`` the live
    beams of unfinished rows merge into the pool."""
    device = lp0.device
    lp_f = float(length_penalty)
    rank = torch.arange(2 * k, device=device)

    def select(cand, t, out, fin_scores, fin_out, fin_len, done):
        """One scorer.process step over (B*K, V) cumulative scores."""
        s2, flat = top_k(cand.reshape(b, k * v), 2 * k)
        beam_idx = flat // v
        token = flat % v
        is_eot = token == eot_id
        # live refill: the first k non-eot candidates in rank order
        order = torch.argsort(is_eot.to(torch.int64) * (2 * k) + rank, dim=1)[:, :k]
        live_scores = s2.gather(1, order)
        live_beam = beam_idx.gather(1, order)
        live_tok = token.gather(1, order)

        gen_len = float(t + 1)
        eligible = is_eot & (rank[None, :] < k) & ~done[:, None]
        cand_pen = torch.where(eligible, s2 / gen_len ** lp_f, NEG_INF)
        # hypothesis = tokens so far; eot-padded, so it reads "sequence + <|eot|>"
        cand_out = out.gather(1, beam_idx[:, :, None].expand(-1, -1, max_new))
        all_scores = torch.cat([fin_scores, cand_pen], dim=1)
        all_out = torch.cat([fin_out, cand_out], dim=1)
        all_len = torch.cat([fin_len, torch.full((b, 2 * k), t + 1, dtype=fin_len.dtype,
                                                 device=device)], dim=1)
        # on ties existing pool entries win (lower index), matching the
        # scorer's strict score > worst_score insertion test
        new_scores, sel = top_k(all_scores, k)
        new_out = all_out.gather(1, sel[:, :, None].expand(-1, -1, max_new))
        new_len = all_len.gather(1, sel)
        keep = done[:, None]
        fin_scores = torch.where(keep, fin_scores, new_scores)
        fin_out = torch.where(keep[:, :, None], fin_out, new_out)
        fin_len = torch.where(keep, fin_len, new_len)

        pool_full = (fin_scores > NEG_INF / 2).all(dim=1)
        worst = fin_scores.min(dim=1).values
        best_running = s2[:, 0]
        if early_stopping == "true":
            row_done = pool_full
        elif early_stopping == "false":
            row_done = pool_full & (worst >= best_running / gen_len ** lp_f)
        else:  # "never": the bound at the longest generation
            denom = float(max_new) ** lp_f if lp_f > 0.0 else gen_len ** lp_f
            row_done = pool_full & (worst >= best_running / denom)
        return live_scores, live_beam, live_tok, fin_scores, fin_out, fin_len, done | row_done

    out0 = torch.full((b, k, max_new), eot_id, dtype=torch.int64, device=device)
    scores, live_beam, live_tok, fin_scores, fin_out, fin_len, done = select(
        init_scores.reshape(b * k, 1) + lp0, 0, out0,
        torch.full((b, k), NEG_INF, dtype=torch.float32, device=device), out0,
        torch.zeros((b, k), dtype=torch.int64, device=device),
        torch.zeros(b, dtype=torch.bool, device=device))
    state, pos = beams.reorder(state, pos, live_beam)
    cur = live_tok.reshape(b * k)
    out = out0.clone()
    out[:, :, 0] = live_tok
    if use_bias:
        state = advance_bias_state(state, spans_t, cur)
    prev, last_ts = none, update_ts(cur, ts0)

    t = 1
    while t < max_new and not bool(done.all()):
        done_bk = done.repeat_interleave(k)
        lp = step_logprobs(step(cur, pos, t), state, done_bk, (cur, prev, last_ts))
        scores, live_beam, live_tok, fin_scores, fin_out, fin_len, done = select(
            scores.reshape(b * k, 1) + lp, t, out, fin_scores, fin_out, fin_len, done)
        state, pos = beams.reorder(state, pos, live_beam)
        out = out.gather(1, live_beam[:, :, None].expand(-1, -1, max_new))
        out[:, :, t] = live_tok
        token_flat = live_tok.reshape(b * k)
        if use_bias:
            state = advance_bias_state(state, spans_t, token_flat)
        prev = beams.gather_bk(cur, live_beam)
        last_ts = update_ts(token_flat, beams.gather_bk(last_ts, live_beam))
        cur, pos, t = token_flat, pos + 1, t + 1

    # finalize: unfinished rows merge their live beams into the pool
    live_pen = torch.where(done[:, None], NEG_INF, scores / float(t) ** lp_f)
    all_scores = torch.cat([fin_scores, live_pen], dim=1)
    all_out = torch.cat([fin_out, out], dim=1)
    all_len = torch.cat([fin_len, torch.full((b, k), t, dtype=fin_len.dtype, device=device)], 1)
    fin_scores, sel = top_k(all_scores, k)
    fin_out = all_out.gather(1, sel[:, :, None].expand(-1, -1, max_new))
    fin_len = all_len.gather(1, sel)
    best_idx = torch.argmax(fin_scores, dim=1)
    best = fin_out.gather(1, best_idx[:, None, None].expand(-1, 1, max_new))[:, 0]
    return BeamResult(fin_out.to(torch.int32), fin_scores, fin_len.to(torch.int32),
                      best.to(torch.int32)), t


def beam_decode_batch(
    model: Whisper, tokenizer, input_features, contexts=None, num_beams: int = 5,
    max_new: int = 224, bias_spans=None, bias_boost: float = 0.0,
    length_penalty: float = 1.0, starts=None, early_stopping: str = "off",
    timestamp_begin: int | None = None, device="cuda", timings: dict | None = None,
    mesh=None,
) -> list[list[int]]:
    """Host-side convenience mirroring ``decode_batch``: the best beam's
    tokens per row, without the prefix and up to (excluding) <|eot|>.
    ``mesh`` shards the rows over "data" (``beam_decode``)."""
    prefixes = build_prefixes(tokenizer, input_features.shape[0], contexts, starts)
    ids, mask = pack_prefixes(prefixes, tokenizer.eot)
    res = beam_decode(
        model, input_features, ids, mask, num_beams=num_beams, max_new=max_new,
        eot_id=tokenizer.eot, bias_spans=sanitize_bias_spans(bias_spans),
        bias_boost=bias_boost, length_penalty=length_penalty, span_pad_id=tokenizer.eot,
        early_stopping=early_stopping, timestamp_begin=timestamp_begin, device=device,
        timings=timings, mesh=mesh)
    outs = []
    for row in res.best.cpu().tolist():
        outs.append(row[: row.index(tokenizer.eot)] if tokenizer.eot in row else row)
    return outs
