"""Speculative greedy decoding: draft-model lookahead with verification,
exactly equal to the target model's greedy decode.

The counterpart of the JAX package's ``decode/speculative.py``: a small draft
model proposes ``k`` tokens a round and the target scores all ``k + 1``
positions in one cached forward, so the target advances ``accepted + 1``
tokens per read of its weights. Rows advance at different rates through the
per-row cache offsets of ``models.whisper.decode_tokens``. JAX runs the rounds
in one ``while_loop`` program; here each round is a host loop iteration
whose ``finished.all()`` check syncs once per round.

Exactness: the emitted sequence is by construction the target's greedy
sequence (an accepted draft token equals the target's argmax at its
position; the first mismatch is replaced by that argmax), for any draft and
any acceptance rate, bias-boosted decoding included (the trie state
advances along the chunk in the verify pass). With random weights the
acceptance is about 0 and this is slower than plain greedy.

Numerics caveat (as in JAX): "exact" means given identical target logits.
Plain greedy scores one position a step (through the int8 cross-attention
kernel on the serving path), the verify scores k + 1 at once (the plain int8
path), so on a card in bf16 a near-tie between the top two logits can flip
an argmax. On the CPU both run the plain versions and the tokens match.
"""

from __future__ import annotations

import sys

import torch

from .._device import resolve_device
from ..models.whisper import (
    Whisper,
    decode_tokens,
    encode_audio,
    init_kv_cache,
    precompute_cross_kv,
    quantize_cross_kv,
)
from .bias_processor import (
    BiasTrieState,
    advance_bias_state,
    bias_bonus,
    init_bias_state,
    sanitize_bias_spans,
    seed_bias_state_from_prefix,
)
from .greedy import (
    Clock,
    GreedyResult,
    _as_tensor,
    build_prefixes,
    greedy_decode,
    pack_prefixes,
    sot_offsets,
)


class _Prefill:
    """One model's cross K/V (int8 when its config says so), its KV cache of
    ``cache_len`` slots holding the left-padded prefix, and that prefill's
    logits (and final-LN states with ``hidden``)."""

    def __init__(self, model: Whisper, feats, ids, mask, cache_len: int, pos_fn=None,
                 hidden: bool = False):
        cfg = model.cfg
        b, p = ids.shape
        dev = ids.device
        self.cross = precompute_cross_kv(model, encode_audio(model, feats))
        if cfg.quantize_cross_kv:
            self.cross = quantize_cross_kv(self.cross)
        # positions: pads don't advance the position counter (left-pad support)
        self.prefix_pos = torch.clamp(torch.cumsum(mask.to(torch.int64), dim=1) - 1, min=0)
        self.key_mask = torch.cat(
            [mask, torch.ones((b, cache_len - p), dtype=torch.bool, device=dev)], 1)
        pos = self.prefix_pos if pos_fn is None else pos_fn(self.prefix_pos)
        out = decode_tokens(model, ids, cross_kv=self.cross,
                            cache=init_kv_cache(cfg, b, cache_len, dev), pos_offset=0,
                            token_positions=pos, self_mask=self.key_mask, return_hidden=hidden)
        self.logits, self.cache = out[0], out[1]
        self.hidden = out[2] if hidden else None


class _Bias:
    """The bias-trie bonus of one decode: the spans, whether they are on,
    and the prefix-seeded start state."""

    def __init__(self, bias_spans, bias_boost: float, span_pad_id: int, ids, mask,
                 n_vocab: int):
        b = ids.shape[0]
        dev = ids.device
        self.on = bias_spans is not None and bias_boost != 0.0
        self.spans = (torch.zeros((b, 1, 1), dtype=torch.int32, device=dev)
                      if bias_spans is None else _as_tensor(bias_spans, dev, torch.int32))
        self.boost, self.v = bias_boost, n_vocab
        self.state0 = init_bias_state(self.spans, span_pad_id)
        if self.on:
            # the conditioning context may end mid-bias-word: warm-start the trie
            self.state0 = seed_bias_state_from_prefix(self.state0, self.spans, ids, mask)

    def bonused(self, lg, state: BiasTrieState, spans=None) -> torch.Tensor:
        lg = lg.float()
        if self.on:
            lg = lg + bias_bonus(state, self.spans if spans is None else spans, self.v,
                                 self.boost)
        return lg

    def advance(self, state: BiasTrieState, tok, spans=None) -> BiasTrieState:
        return advance_bias_state(state, self.spans if spans is None else spans,
                                  tok) if self.on else state


def _pick(lg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy token and its log-probability under ``lg`` (B, V) f32."""
    t = torch.argmax(lg, dim=-1)
    return t, torch.log_softmax(lg, dim=-1).gather(1, t[:, None])[:, 0]


def _no_speech(logits, no_speech_id, sot_offset, p: int):
    if no_speech_id is None:
        return None
    b = logits.shape[0]
    dev = logits.device
    sot_lg = logits[torch.arange(b, device=dev), p - sot_offsets(sot_offset, b, dev)]
    return torch.softmax(sot_lg.float(), dim=-1)[:, no_speech_id]


class _Rounds:
    """The loop state shared by speculative and Medusa decoding: each row's
    emitted count ``n`` (incl. ``cur``), last emitted (target-verified) token
    ``cur`` and its position id ``pos_cur``, the output buffer with a scratch
    column, the finished flags, the bias-trie state after every emitted
    token, the summed logprob and the verify rounds."""

    def __init__(self, bias: _Bias, first_logits, prefix_pos, max_new: int, eot_id: int):
        b = first_logits.shape[0]
        dev = first_logits.device
        # first emitted token: the target's (biased) greedy pick on the
        # prefill logits, as greedy_decode's first token
        self.cur, self.sum_lp = _pick(bias.bonused(first_logits, bias.state0))
        self.state = bias.advance(bias.state0, self.cur)
        self.pos_cur = prefix_pos[:, -1] + 1
        self.out = torch.full((b, max_new + 1), eot_id, dtype=torch.int64, device=dev)
        self.out[:, 0] = self.cur
        self.n = torch.ones(b, dtype=torch.int64, device=dev)
        self.finished = (self.cur == eot_id) | (max_new == 1)
        self.rounds = 0
        self.bias, self.max_new, self.eot_id = bias, max_new, eot_id

    def commit(self, proposed, t_seq, lp_seq, a) -> torch.Tensor:
        """Emit each row's ``a`` accepted proposals (B, k) and the correction
        ``t_seq[a]`` (t_seq, lp_seq: (B, k + 1) the target's picks and their
        logprobs), stopping at the first eot, the capacity and finished rows;
        returns the previous finished flags."""
        b, k1 = t_seq.shape
        dev = t_seq.device
        correction = t_seq.gather(1, a[:, None])[:, 0]
        jidx = torch.arange(k1, device=dev)[None, :]
        chunk_out = torch.cat([proposed, correction[:, None]], dim=1)
        chunk_out = torch.where(jidx == a[:, None], correction[:, None], chunk_out)
        in_chunk = jidx <= a[:, None]
        # stop at the first eot within the emitted part (inclusive)
        is_eot = (chunk_out == self.eot_id) & in_chunk
        eot_before = torch.cumsum(torch.cat(
            [torch.zeros((b, 1), dtype=torch.int64, device=dev),
             is_eot[:, :-1].to(torch.int64)], dim=1), dim=1) > 0
        capacity = (self.n[:, None] + jidx) < self.max_new
        valid = in_chunk & ~eot_before & capacity & ~self.finished[:, None]
        # valid tokens into the output buffer, the rest into its scratch column
        write_idx = torch.where(valid, self.n[:, None] + jidx, self.max_new)
        rows = torch.arange(b, device=dev)[:, None].expand(b, k1)
        self.out[rows.reshape(-1), write_idx.reshape(-1)] = chunk_out.reshape(-1)
        emitted = valid.sum(dim=1)
        was_finished = self.finished
        self.n = self.n + emitted
        # each emitted token at chunk position j is t_seq[j]: its logprob counts
        self.sum_lp = self.sum_lp + torch.where(valid, lp_seq, 0.0).sum(dim=1)
        self.finished = (was_finished | (is_eot & valid).any(dim=1)
                         | (self.n >= self.max_new))
        self.cur = torch.where(was_finished, self.cur, correction)
        self.pos_cur = self.pos_cur + emitted
        if self.bias.on:  # the carried trie state over the valid emitted tokens only
            state = self.state
            for j in range(k1):
                new = self.bias.advance(state, chunk_out[:, j])
                state = BiasTrieState(torch.where(valid[:, j, None], new.matched, state.matched),
                                      state.span_len)
            self.state = state
        self.rounds += 1
        return was_finished

    def result(self, no_speech_prob) -> GreedyResult:
        tokens = self.out[:, :self.max_new]
        lengths = torch.cumprod((tokens != self.eot_id).to(torch.int32), dim=1).sum(dim=1)
        return GreedyResult(tokens.to(torch.int32), lengths.to(torch.int32), self.sum_lp,
                            no_speech_prob, spec_rounds=self.rounds)


def accept_run(proposed: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Accepted run length (...,): proposals accepted while each equals the
    target's pick at its position."""
    return torch.cumprod((proposed == targets).to(torch.int64), dim=-1).sum(dim=-1)


@torch.no_grad()
def speculative_greedy_decode(
    params_draft: Whisper,
    params_target: Whisper,
    input_features,               # (B, n_mels, T) f32, shared by both models
    prefix_ids,                   # (B, P) int, left-padded
    prefix_mask,                  # (B, P) bool
    k: int = 4,
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,              # (B, N, Ks) int32 or None
    bias_boost: float = 0.0,
    span_pad_id: int = 50256,
    input_features_draft=None,    # the draft's own mel when its n_mels differs
    no_speech_id: int | None = None,
    sot_offset=1,
    device="cuda",
    timings: dict | None = None,  # filled with encode_ms (both prefills),
                                  # decode_ms and rounds when given
) -> GreedyResult:
    """Batched speculative greedy decode (see the module docstring). The
    models carry their configs (the JAX signature's ``cfg_draft`` and
    ``cfg_target``). Returns a ``GreedyResult`` whose tokens and lengths
    equal ``greedy_decode(params_target, ...)``'s, with the same
    ``sum_logprob`` and ``no_speech_prob`` semantics and ``spec_rounds``."""
    device = resolve_device(device)
    cfg_d, cfg_t = params_draft.cfg, params_target.cfg
    if cfg_d.n_vocab != cfg_t.n_vocab:
        raise ValueError("draft and target must share the vocabulary")
    feats = _as_tensor(input_features, device, torch.float32)
    ids = _as_tensor(prefix_ids, device, torch.int64)
    mask = _as_tensor(prefix_mask, device, torch.bool)
    b, p = ids.shape
    # clamp by the target's context only (greedy parity); a draft with a
    # smaller decoder context proposes with its position ids saturated at
    # its table's edge, which lowers acceptance, never the output
    max_new = min(max_new, cfg_t.n_text_ctx - p)
    if max_new < 1:
        raise ValueError(f"prefix length {p} leaves no room to generate")

    def dpos(pos):
        return torch.clamp(pos, max=cfg_d.n_text_ctx - 1)

    cache_len = p + max_new + k + 1  # chunk overshoot margin
    feats_d = (feats if input_features_draft is None
               else _as_tensor(input_features_draft, device, torch.float32))
    clock = Clock(device) if timings is not None else None
    if clock:
        clock.mark("start")
    tgt = _Prefill(params_target, feats, ids, mask, cache_len)
    drf = _Prefill(params_draft, feats_d, ids, mask, cache_len, pos_fn=dpos)
    key_mask = tgt.key_mask
    no_speech_prob = _no_speech(tgt.logits, no_speech_id, sot_offset, p)
    bias = _Bias(bias_spans, bias_boost, span_pad_id, ids, mask, cfg_t.n_vocab)
    st = _Rounds(bias, tgt.logits[:, -1], tgt.prefix_pos, max_new, eot_id)
    if clock:
        clock.mark("prefilled")
    ar = torch.arange(k + 1, device=device)

    while not bool(st.finished.all()):
        slot_cur = p + st.n - 1  # (B,) cache slot of cur
        # draft: k productive single-token steps + 1 write-only step (so a
        # fully accepted chunk's last token has its K/V in the draft cache)
        ds = torch.zeros((b, k + 2), dtype=torch.int64, device=device)
        ds[:, 0] = st.cur
        dstate = st.state
        for j in range(k + 1):
            lg, _ = decode_tokens(params_draft, ds[:, j, None], cross_kv=drf.cross,
                                  cache=drf.cache, pos_offset=slot_cur + j,
                                  token_positions=dpos(st.pos_cur + j)[:, None],
                                  self_mask=key_mask)
            nxt = torch.argmax(bias.bonused(lg[:, -1], dstate), dim=-1)
            dstate = bias.advance(dstate, nxt)
            ds[:, j + 1] = nxt
        drafted = ds[:, 1:k + 1]
        # verify: one target forward over k + 1 positions (position ids
        # clamped to the table, as JAX's gather clamps them)
        lg, _ = decode_tokens(params_target, ds[:, :k + 1], cross_kv=tgt.cross, cache=tgt.cache,
                              pos_offset=slot_cur,
                              token_positions=torch.clamp(st.pos_cur[:, None] + ar[None, :],
                                                          max=cfg_t.n_text_ctx - 1),
                              self_mask=key_mask)
        # the target's pick t_j at each position, with the trie state
        # advanced along the chunk (state_j has consumed cur and d_1..d_j)
        state, dp = st.state, drafted_pad(ds, k)
        picks = []
        for j in range(k + 1):
            picks.append(_pick(bias.bonused(lg[:, j], state)))
            state = bias.advance(state, dp[:, j])
        t_seq = torch.stack([t for t, _ in picks], dim=1)    # (B, k+1): t_0..t_k
        lp_seq = torch.stack([lp for _, lp in picks], dim=1)
        st.commit(drafted, t_seq, lp_seq, accept_run(drafted, t_seq[:, :k]))

    if clock:
        clock.mark("done")
        timings.update(encode_ms=clock.ms("start", "prefilled"),
                       decode_ms=clock.ms("prefilled", "done"), rounds=st.rounds)
    return st.result(no_speech_prob)


def speculative_decode_batch(
    params_draft: Whisper,
    params_target: Whisper,
    tokenizer,
    input_features,
    contexts: list[list[int]] | None = None,
    max_new: int = 224,
    bias_spans=None,
    bias_boost: float = 0.0,
    k: int = 4,
    include_notimestamps: bool = False,
    pad_to_multiple: int | None = None,
    starts: list[list[int]] | None = None,
    input_features_draft=None,
    device="cuda",
    timings: dict | None = None,
) -> list[list[int]]:
    """Host-side convenience mirroring ``greedy.decode_batch``: build the
    prefixes, run the speculative loop, strip to finished token lists. The
    lists are identical to ``decode_batch``'s with the target model."""
    b = input_features.shape[0]
    prefixes = build_prefixes(tokenizer, b, contexts, starts, include_notimestamps)
    ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=pad_to_multiple)
    res = speculative_greedy_decode(
        params_draft, params_target, input_features, ids, mask, k=k, max_new=max_new,
        eot_id=tokenizer.eot, bias_spans=sanitize_bias_spans(bias_spans),
        bias_boost=bias_boost, span_pad_id=tokenizer.eot,
        input_features_draft=input_features_draft, device=device, timings=timings)
    toks = res.tokens.cpu().numpy()
    lens = res.lengths.cpu().numpy()
    return [toks[i, : lens[i]].tolist() for i in range(b)]


_DRAFT_OVERRIDE_KEYS = ("flash_attention", "flash_block_q",
                        "quantize_cross_kv", "fused_quant_cross",
                        "gelu_approx")


def load_draft(
    model: str,
    checkpoint: str | None = None,
    *,
    dtype: str = "bfloat16",
    overrides: dict | None = None,
    target_cfg=None,
    cfg=None,
    params: dict | None = None,
    device="cuda",
):
    """The draft loader shared by Pipeline and the CLIs: the draft config
    from its family name with the caller's serving overrides (the kernel
    and quantization keys only, so the draft runs the target's fast path),
    ``params`` (a JAX params tree), ``checkpoint``'s weights or the seeded
    init (seed 0) with a warning, and the shared vocabulary checked
    against ``target_cfg``. Returns ``(model, cfg)`` on ``device``. A draft
    with another ``n_mels`` is allowed here: short-form decoding feeds it
    its own mel; the long-form routes check."""
    from ..models import (
        build_model,
        get_config,
        load_checkpoint_or_safetensors,
        params_from_jax,
    )

    if cfg is None:
        ov = {km: vv for km, vv in (overrides or {}).items() if km in _DRAFT_OVERRIDE_KEYS}
        cfg = get_config(model, dtype=dtype, **ov)
    state = None
    if params is not None:
        state = params_from_jax(params, cfg)
    elif checkpoint:
        state, cfg = load_checkpoint_or_safetensors(checkpoint, cfg)
    else:
        print("warning: random draft weights (no draft checkpoint): acceptance ~0, "
              "speculative decode will be slower than plain greedy", file=sys.stderr)
    if target_cfg is not None and cfg.n_vocab != target_cfg.n_vocab:
        raise ValueError(f"draft {model} vocab {cfg.n_vocab} != target vocab "
                         f"{target_cfg.n_vocab}")
    return build_model(cfg, state, seed=0, device=device), cfg


def drafted_pad(ds: torch.Tensor, k: int) -> torch.Tensor:
    """Chunk tokens the verify pass advances the trie state by: positions
    0..k hold [d1..dk, <unused>] (position k's token never forms an accepted
    state: the correction's advance happens in the carried-state pass)."""
    return ds[:, 1: k + 2]


def t0_verified_decode(
    params: Whisper,
    tokenizer,
    mel,
    ids,
    mask,
    *,
    max_new: int,
    spans=None,
    bias_boost: float = 0.0,
    no_speech_id=None,
    sot_offset=1,
    medusa: dict | None = None,
    draft: tuple | None = None,     # (draft model, its config, k)
    device="cuda",
) -> GreedyResult:
    """The temperature-0 accelerator of the long-form, chunked and streaming
    ladders: Medusa heads win over a draft model, and without either plain
    greedy runs; every branch returns a GreedyResult with the same tokens."""
    common = dict(max_new=max_new, eot_id=tokenizer.eot, bias_spans=spans,
                  bias_boost=bias_boost, span_pad_id=tokenizer.eot,
                  no_speech_id=no_speech_id, sot_offset=sot_offset, device=device)
    if medusa is not None:
        from ..models.medusa import split_medusa
        from .medusa import medusa_greedy_decode

        heads, n_chains = split_medusa(medusa)
        return medusa_greedy_decode(params, heads, mel, ids, mask, n_chains=n_chains, **common)
    if draft is not None:
        dmodel, _, dk = draft
        return speculative_greedy_decode(dmodel, params, mel, ids, mask, k=dk, **common)
    return greedy_decode(params, mel, ids, mask, **common)
