"""The greedy decoder's step function (``decode_step`` on a ``StepState``),
which the card captures as a CUDA graph, against the loop it replaced, on
the CPU: ``decode_tokens`` with a 0-dim device ``pos_offset`` against the int
path, the eager steps against a copy of the former loop (tokens, lengths,
summed logprobs and margins identical), the rule that decides when a call
may capture, and the per-model cache of captured signatures.

The capture and the replay themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu_torch.decode import greedy, pack_prefixes
from whisper_context_biasing_tpu_torch.decode.bias_processor import (
    advance_bias_state,
    bias_bonus,
    init_bias_state,
    seed_bias_state_from_prefix,
)
from whisper_context_biasing_tpu_torch.decode.greedy import (
    NEG,
    apply_timestamp_rules,
    greedy_decode,
)
from whisper_context_biasing_tpu_torch.models import build_model, tiny_test_config
from whisper_context_biasing_tpu_torch.models.whisper import (
    decode_tokens,
    encode_audio,
    init_kv_cache,
    kv_width,
    precompute_cross_kv,
    quantize_cross_kv,
)

KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
EOT, TB = 50256, 50363


@pytest.fixture(scope="module")
def model():
    return build_model(tiny_test_config(**KERNELS), seed=0, device="cpu")


@pytest.fixture(scope="module")
def mel():
    return (np.random.default_rng(0).standard_normal((3, 80, 128)) * 0.5).astype(np.float32)


@torch.no_grad()
def _former_loop(model, mel, ids, mask, max_new, bias_spans=None, bias_boost=0.0,
                 forced_eot_at=None, suppress_tokens=(), timestamp_begin=None,
                 return_margins=False):
    """The greedy loop as it stood before the step function: Python-int
    slots, a fresh state every step."""
    cfg = model.cfg
    feats, ids, mask = torch.as_tensor(mel), torch.as_tensor(ids).long(), torch.as_tensor(mask)
    b, p = ids.shape
    max_new = min(max_new, cfg.n_text_ctx - p)
    enc_out = encode_audio(model, feats)
    use_bias = bias_spans is not None and bias_boost != 0.0
    spans = (torch.zeros((b, 1, 1), dtype=torch.int32) if bias_spans is None
             else torch.as_tensor(bias_spans, dtype=torch.int32))
    forced_at = None if forced_eot_at is None else torch.as_tensor(forced_eot_at).long()
    margins = torch.zeros((b, max_new)) if return_margins else None
    suppress = torch.as_tensor(suppress_tokens).long() if suppress_tokens else None

    def pick(lg, state, t, ts_state):
        lg = lg.float()
        if suppress is not None:
            lg = lg.index_fill(1, suppress, NEG)
        if use_bias:
            lg = lg + bias_bonus(state, spans, cfg.n_vocab, bias_boost)
        if timestamp_begin is not None:
            lg = apply_timestamp_rules(lg, *ts_state, timestamp_begin=timestamp_begin,
                                       eot_id=EOT, is_first=t == 0,
                                       max_initial_timestamp_index=50)
        nxt = torch.argmax(lg, dim=-1)
        logp = torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None])[:, 0]
        if margins is not None:
            top2 = lg.topk(2, dim=-1).values
            margins[:, t] = top2[:, 0] - top2[:, 1]
        return nxt, logp

    def advance(state, tok):
        return advance_bias_state(state, spans, tok) if use_bias else state

    cross_kv = quantize_cross_kv(precompute_cross_kv(model, enc_out))
    cache = init_kv_cache(cfg, b, p + max_new, "cpu", width=kv_width(model))
    prefix_pos = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
    key_mask = torch.cat([mask, torch.ones((b, max_new), dtype=torch.bool)], 1)
    logits, cache = decode_tokens(model, ids, cross_kv=cross_kv, cache=cache, pos_offset=0,
                                  token_positions=prefix_pos, self_mask=key_mask)
    pos = prefix_pos[:, -1] + 1
    bias_state = init_bias_state(spans, EOT)
    if use_bias:
        bias_state = seed_bias_state_from_prefix(bias_state, spans, ids, mask)
    none = torch.full((b,), -1, dtype=torch.int64)
    cur, sum_lp = pick(logits[:, -1], bias_state, 0, (none, none, torch.zeros_like(none)))
    if forced_at is not None:
        forced0 = forced_at <= 0
        cur = torch.where(forced0, EOT, cur)
        sum_lp = torch.where(forced0, 0.0, sum_lp)
    out = torch.full((b, max_new), EOT, dtype=torch.int64)
    out[:, 0] = cur
    finished = cur == EOT
    bias_state = advance(bias_state, cur)
    prev, last_ts = none, torch.zeros_like(none)
    if timestamp_begin is not None:
        last_ts = torch.where(cur >= timestamp_begin, cur, last_ts)
    live, t = b - int(finished.sum()), 1
    while t < max_new and live:
        lg, cache = decode_tokens(model, cur[:, None], cross_kv=cross_kv, cache=cache,
                                  pos_offset=p - 1 + t, token_positions=pos[:, None],
                                  self_mask=key_mask)
        nxt, lp = pick(lg[:, -1], bias_state, t, (cur, prev, last_ts))
        if forced_at is not None:
            forced = t >= forced_at
            nxt = torch.where(forced, EOT, nxt)
            lp = torch.where(forced, 0.0, lp)
        nxt = torch.where(finished, EOT, nxt)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        out[:, t] = nxt
        finished = finished | (nxt == EOT)
        bias_state = advance(bias_state, nxt)
        if timestamp_begin is not None:
            last_ts = torch.where(nxt >= timestamp_begin, nxt, last_ts)
        prev, cur, pos, t = cur, nxt, pos + 1, t + 1
        if t < max_new:
            live = b - int(finished.sum())
    lengths = torch.cumprod((out != EOT).to(torch.int32), dim=1).sum(dim=1)
    return out.to(torch.int32), lengths.to(torch.int32), sum_lp, margins, t - 1


# ---------------------------------------------------------------------------
# decode_tokens at a device slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot,s", [(0, 1), (5, 1), (9, 3)])
def test_decode_tokens_device_slot_matches_int_slot(model, mel, slot, s):
    """A 0-dim ``pos_offset`` tensor writes the same cache slots and returns
    the same logits as the int offset, bit for bit."""
    enc = encode_audio(model, torch.as_tensor(mel))
    kv = quantize_cross_kv(precompute_cross_kv(model, enc))
    rng = np.random.default_rng(slot)
    toks = torch.as_tensor(rng.integers(0, 50000, (3, s)))
    mask = torch.as_tensor(rng.random((3, 16)) > 0.2)
    out = []
    for off in (slot, torch.tensor(slot)):
        cache = init_kv_cache(model.cfg, 3, 16, "cpu")
        cache["k"].normal_(generator=torch.Generator().manual_seed(1))
        lg, cache = decode_tokens(model, toks, cross_kv=kv, cache=cache, pos_offset=off,
                                  self_mask=mask)
        out.append((lg, cache))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["k"], out[1][1]["k"])
    assert torch.equal(out[0][1]["v"], out[1][1]["v"])


# ---------------------------------------------------------------------------
# the step function against the former loop
# ---------------------------------------------------------------------------

def _spans():
    """Bias spans (3, 3, 3): a row with three words, one with a single
    one-token word, one with none."""
    s = np.full((3, 3, 3), EOT, np.int32)
    s[0, 0, :2] = [220, 11]
    s[0, 1, :3] = [40, 41, 42]
    s[0, 2, :1] = [13]
    s[1, 0, :1] = [50]
    return s


CASES = {
    "plain": dict(),
    "bias": dict(bias_spans=_spans(), bias_boost=2.0),
    "caps": dict(forced_eot_at=np.array([3, 0, 7])),
    "bias_caps_margins": dict(bias_spans=_spans(), bias_boost=5.0,
                              forced_eot_at=np.array([9, 4, 1]), return_margins=True),
    "suppress": dict(suppress_tokens=(220, 11, 13, 50257)),
    "timestamps": dict(timestamp_begin=TB, return_margins=True),
    "all": dict(bias_spans=_spans(), bias_boost=2.0, forced_eot_at=np.array([6, 2, 10]),
                suppress_tokens=(220,), timestamp_begin=TB, return_margins=True),
}


@pytest.mark.parametrize("prefixes", [[[50257], [50257], [50257]],
                                      [[50360, 40, 41, 50257], [50257], [50360, 7, 50257]]],
                         ids=["aligned", "left_padded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_function_matches_former_loop(model, mel, case, prefixes):
    """``greedy_decode``'s eager steps give the former loop's tokens,
    lengths, summed logprobs, margins and step count exactly."""
    kw = CASES[case]
    ids, mask = pack_prefixes(prefixes, EOT)
    want = _former_loop(model, mel, ids, mask, 12, **kw)
    timings = {}
    got = greedy_decode(model, mel, ids, mask, max_new=12, eot_id=EOT, span_pad_id=EOT,
                        device="cpu", timings=timings, **kw)
    assert torch.equal(got.tokens, want[0])
    assert torch.equal(got.lengths, want[1])
    assert torch.equal(got.sum_logprob, want[2])
    if kw.get("return_margins"):
        assert torch.equal(got.margins, want[3])
    assert timings["steps"] == want[4]


# ---------------------------------------------------------------------------
# when a call captures, and the cache of captured signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,tp,temperature,row_offset,global_rows,want", [
    ("cuda", None, 0.0, 0, None, True),
    ("cpu", None, 0.0, 0, None, False),
    ("cuda", "tp", 0.0, 0, None, False),
    ("cuda", None, 0.7, 0, None, False),
    ("cuda", None, 0.0, 4, 8, False),
    ("cuda", None, 0.0, 0, 8, False),
], ids=["cuda_greedy", "cpu", "tensor_parallel", "sampling", "mesh_rows", "mesh_first_rows"])
def test_capture_engages_only_where_the_step_is_capturable(model, device, tp, temperature,
                                                           row_offset, global_rows, want):
    class Sharded:
        pass

    m = model
    if tp is not None:
        m = Sharded()
        m.tp = object()
    assert greedy._capturable(m, torch.device(device), temperature, row_offset,
                              global_rows) is want


def test_cpu_decode_keeps_no_captured_signature(model, mel):
    ids, mask = pack_prefixes([[50257]] * 3, EOT)
    greedy_decode(model, mel, ids, mask, max_new=4, device="cpu")
    assert model not in greedy._graphs


def test_graph_cache_is_bounded_and_reused():
    """One entry a signature, reused by later calls; at most ``MAX_GRAPHS``
    a model, the least recently used dropped first; a signature held by a
    running call is not handed out twice."""
    owner = torch.nn.Linear(2, 2)
    first = greedy._claim_graph(owner, "a")
    assert first is not None and greedy._claim_graph(owner, "a") is None  # still busy
    first.busy = False
    assert greedy._claim_graph(owner, "a") is first
    first.busy = False
    for k in "bcdefg":
        greedy._claim_graph(owner, k).busy = False
        assert len(greedy._graphs[owner]) <= greedy.MAX_GRAPHS
    assert list(greedy._graphs[owner]) == list("defg"[-greedy.MAX_GRAPHS:])


def test_signature_follows_the_weights(model):
    """A weight updated in place gives another signature, so no capture
    replays a stale derived weight (the cached vocab projection)."""
    rule = greedy._Rule(4, EOT, 51864, 2.0, None, 50, 0.0)
    key = greedy._signature(model, rule, 3, 12)
    assert greedy._signature(model, rule, 3, 12) == key
    m = build_model(tiny_test_config(**KERNELS), seed=0, device="cpu")
    k0 = greedy._signature(m, rule, 3, 12)
    with torch.no_grad():
        m.decoder.token_emb.mul_(1.0)
    assert greedy._signature(m, rule, 3, 12) != k0
    assert greedy._signature(model, rule, 3, 13) != key
