"""Medusa self-speculative greedy decoding: multi-token heads, one model.

The counterpart of the JAX package's ``decode/medusa.py``. K small heads on
the decoder's final hidden state (``models/medusa.py``) propose tokens
t+2..t+K+1, so each round is one cached forward over ``1 + n_chains * K``
positions that both verifies the previous proposal and, through the hidden
state at the last accepted position, produces the next one. No draft model.

Exactness is that of ``speculative_greedy_decode``: the emitted sequence is
the model's greedy sequence for any head quality, untrained heads included
(they set only the speed); the bias trie advances along each chain in the
verify pass. Head proposals are unbiased, which can lower acceptance, never
change the output.

With ``n_chains`` s > 1 the round branches on head 1's top-s candidates
(``decode.beam.top_k``: ties to the lower index, as ``lax.top_k``; deeper
depths take each head's argmax, shared by the chains). Each query attends to
the committed cache, ``cur`` and its own chain's earlier slots only (the
tree mask), the best chain is the first with the longest accepted run, and
its K slots are moved to the front of the tail so that the committed tokens
stay contiguous in the cache.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..models.medusa import medusa_logits, split_medusa
from ..models.whisper import Whisper, decode_tokens
from ..utils.compile_count import counted_jit
from .beam import top_k
from .bias_processor import BiasTrieState, sanitize_bias_spans
from .greedy import Clock, GreedyResult, _as_tensor, build_prefixes, pack_prefixes
from .speculative import _Bias, _no_speech, _pick, _Prefill, _Rounds, accept_run


@counted_jit
@torch.no_grad()
def medusa_greedy_decode(
    params: Whisper,
    medusa: dict,                 # models/medusa.py heads {"w": (K, d, d), "b": (K, d)}
    input_features,               # (B, n_mels, T) f32
    prefix_ids,                   # (B, P) int, left-padded
    prefix_mask,                  # (B, P) bool
    max_new: int = 224,
    eot_id: int = 50256,
    bias_spans=None,
    bias_boost: float = 0.0,
    span_pad_id: int = 50256,
    no_speech_id: int | None = None,
    sot_offset=1,
    n_chains: int = 1,
    device="cuda",
    timings: dict | None = None,  # filled with encode_ms, decode_ms and rounds
) -> GreedyResult:
    """Returns a ``GreedyResult`` whose tokens and lengths equal
    ``greedy_decode(params, ...)``'s, with the same ``sum_logprob`` and
    ``no_speech_prob`` semantics; ``spec_rounds`` counts verify rounds."""
    device = resolve_device(device)
    cfg = params.cfg
    k = int(medusa["w"].shape[0])
    s_ch = int(n_chains)
    if s_ch < 1:
        raise ValueError(f"n_chains must be >= 1, got {n_chains}")
    feats = _as_tensor(input_features, device, torch.float32)
    ids = _as_tensor(prefix_ids, device, torch.int64)
    mask = _as_tensor(prefix_mask, device, torch.bool)
    b, p = ids.shape
    v = cfg.n_vocab
    max_new = min(max_new, cfg.n_text_ctx - p)
    if max_new < 1:
        raise ValueError(f"prefix length {p} leaves no room to generate")
    cache_len = p + max_new + 1 + s_ch * k  # chunk overshoot margin
    heads = {name: medusa[name].to(device) for name in ("w", "b")}
    clock = Clock(device) if timings is not None else None
    if clock:
        clock.mark("start")
    pre = _Prefill(params, feats, ids, mask, cache_len, hidden=True)
    no_speech_prob = _no_speech(pre.logits, no_speech_id, sot_offset, p)
    bias = _Bias(bias_spans, bias_boost, span_pad_id, ids, mask, v)
    st = _Rounds(bias, pre.logits[:, -1], pre.prefix_pos, max_new, eot_id)
    hid = pre.hidden[:, -1]  # (B, D): the hidden that proposes from cur
    cache = pre.cache
    if clock:
        clock.mark("prefilled")

    chunk_len = 1 + s_ch * k
    rows = torch.arange(b, device=device)
    # per-depth position ids (a chain's token at depth d shares it with the
    # other chains' depth-d tokens) and each query's chain (-2 for cur)
    depth = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                       torch.arange(1, k + 1, device=device).repeat(s_ch)])
    qi = torch.arange(chunk_len, device=device)
    c_q = torch.where(qi > 0, torch.div(qi - 1, k, rounding_mode="floor"), -2)
    t_idx = torch.arange(cache_len, device=device)
    ar_k = torch.arange(k, device=device)
    if bias.on:
        spans_t = torch.repeat_interleave(bias.spans, s_ch, dim=0)

    while not bool(st.finished.all()):
        slot_cur = p + st.n - 1  # (B,) cache slot of cur
        # propose: s chains branching on head 1's top-s, deeper depths each
        # head's argmax shared across the chains
        md = medusa_logits(params, heads, hid[:, None, :])[:, :, 0, :].float()  # (K, B, V)
        first = top_k(md[0], s_ch)[1][:, :, None]                               # (B, s, 1)
        chains = first
        if k > 1:
            deep = torch.argmax(md[1:], dim=-1)                                 # (K-1, B)
            chains = torch.cat([first, deep.T[:, None, :].expand(b, s_ch, k - 1)], dim=2)
        chunk_in = torch.cat([st.cur[:, None], chains.reshape(b, s_ch * k)], dim=1)

        # the tree mask over cache slots: a chain token sees the committed
        # cache, cur and its own chain's earlier slots, no sibling's
        rel = t_idx[None, :] - (slot_cur[:, None] + 1)                          # (B, T)
        in_tail = (rel >= 0) & (rel < s_ch * k)
        c_t = torch.where(in_tail, torch.div(rel, k, rounding_mode="floor"), -1)
        allow = ~in_tail[:, None, :] | (c_t[:, None, :] == c_q[None, :, None])
        sm = pre.key_mask[:, None, :] & allow                                   # (B, S, T)
        lg, _, hid_all = decode_tokens(
            params, chunk_in, cross_kv=pre.cross, cache=cache, pos_offset=slot_cur,
            token_positions=torch.clamp(st.pos_cur[:, None] + depth[None, :],
                                        max=cfg.n_text_ctx - 1),
            self_mask=sm, return_hidden=True)
        lg = lg.float()

        # depth 0: cur's logits under the carried trie state
        t0, lp0 = _pick(bias.bonused(lg[:, 0], st.state))
        # each chain's picks: chains flattened into the batch, the trie state
        # tiled and advanced by the chain token before scoring its logits
        flat_lg = lg[:, 1:].reshape(b * s_ch, k, v)
        flat_chains = chains.reshape(b * s_ch, k)
        state = (BiasTrieState(torch.repeat_interleave(st.state.matched, s_ch, dim=0),
                               torch.repeat_interleave(st.state.span_len, s_ch, dim=0))
                 if bias.on else None)
        picks = []
        for j in range(k):
            if bias.on:
                state = bias.advance(state, flat_chains[:, j], spans_t)
            picks.append(_pick(bias.bonused(flat_lg[:, j], state, spans_t)
                               if bias.on else flat_lg[:, j]))
        t_c = torch.stack([t for t, _ in picks], dim=1).reshape(b, s_ch, k)
        lp_c = torch.stack([lp for _, lp in picks], dim=1).reshape(b, s_ch, k)

        # acceptance per chain: depth d's target is t0 (d = 1), else t_c[d-2]
        targets = torch.cat([t0[:, None, None].expand(b, s_ch, 1), t_c[:, :, :k - 1]], dim=2)
        a_ch = accept_run(chains, targets)                                      # (B, s)
        best = torch.argmax(a_ch, dim=1)                                        # first max
        a = a_ch[rows, best]
        t_seq = torch.cat([t0[:, None], t_c[rows, best]], dim=1)                # (B, K+1)
        lp_seq = torch.cat([lp0[:, None], lp_c[rows, best]], dim=1)
        # the hidden at the last accepted input position proposes next round
        hpos = torch.where(a == 0, 0, 1 + best * k + (a - 1))
        hid_new = hid_all[rows, hpos]

        if s_ch > 1:
            # relocate: the best chain's K slots move to the front of the
            # tail, so the committed tokens stay contiguous (slots past the
            # accept point are overwritten next round)
            src = slot_cur[:, None] + 1 + best[:, None] * k + ar_k[None, :]
            dst = slot_cur[:, None] + 1 + ar_k[None, :]
            for name in ("k", "v"):
                cache[name][:, rows[:, None], dst] = cache[name][:, rows[:, None], src]

        was_finished = st.commit(chains[rows, best], t_seq, lp_seq, a)
        hid = torch.where(was_finished[:, None], hid, hid_new)

    if clock:
        clock.mark("done")
        timings.update(encode_ms=clock.ms("start", "prefilled"),
                       decode_ms=clock.ms("prefilled", "done"), rounds=st.rounds)
    return st.result(no_speech_prob)


def medusa_decode_batch(
    params: Whisper,
    medusa: dict,
    tokenizer,
    input_features,
    contexts: list[list[int]] | None = None,
    max_new: int = 224,
    bias_spans=None,
    bias_boost: float = 0.0,
    pad_to_multiple: int | None = None,
    starts: list[list[int]] | None = None,
    device="cuda",
    timings: dict | None = None,
) -> list[list[int]]:
    """Host-side convenience mirroring ``greedy.decode_batch``; the heads'
    ``n_chains`` setting (``load_medusa``) picks the chain width."""
    b = input_features.shape[0]
    prefixes = build_prefixes(tokenizer, b, contexts, starts)
    ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=pad_to_multiple)
    heads, n_chains = split_medusa(medusa)
    res = medusa_greedy_decode(
        params, heads, input_features, ids, mask, max_new=max_new, eot_id=tokenizer.eot,
        n_chains=n_chains, bias_spans=sanitize_bias_spans(bias_spans), bias_boost=bias_boost,
        span_pad_id=tokenizer.eot, device=device, timings=timings)
    toks = res.tokens.cpu().numpy()
    lens = res.lengths.cpu().numpy()
    return [toks[i, : lens[i]].tolist() for i in range(b)]
