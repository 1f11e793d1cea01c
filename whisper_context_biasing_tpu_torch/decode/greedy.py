"""Batched greedy decoding over a preallocated KV cache.

The counterpart of the JAX package's ``decode/greedy.py``: encode, precompute
(and optionally int8-quantize) the cross-attention K/V, prefill the
left-padded prefix (``<|startofprev|> ctx... <|sot|>``) into the cache, then
one cached decoder step per token with the bias-trie bonus, greedy argmax (or
temperature sampling) and a stop at <|endoftext|>. JAX runs the loop as one
``while_loop`` program; here it is a Python loop whose count of the rows
still running syncs with the host once per step. The cache has a static
shape and is written in place. A step (``decode_step``) reads and writes
only the tensors of a ``StepState``, at device indices, so on a card a call
signature's step is captured once as a CUDA graph and then replayed, one
launch a step in place of the step's hundreds of ops (``_StepGraph``).
While a ``torch.profiler`` session is active the call is traced
(``utils/profiling.py``): a ``decode`` span with ``decode.encode``,
``decode.prefill`` and a ``decode.step`` a step (each with its
``decode.sync`` and, when it runs eagerly, its ``decode.bias`` spans), and
the counters ``decode.rows``, ``decode.live_rows``, ``decode.graph_steps``
(steps run by a replay) and ``decode.graph_captures``.

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

import collections
import dataclasses
import itertools
import threading
import weakref
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
from ..ops import _build
from ..parallel.mesh import DATA_AXIS, axis_index
from ..parallel.sharding import gather_rows, shard_decode_inputs
from ..utils.compile_count import counted_jit
from ..utils.profiling import Clock, count, span
from .bias_processor import (
    BiasTrieState,
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


class _Rule(NamedTuple):
    """The Python values a decode call bakes into its steps."""
    p: int                     # prefix length: step t writes cache slot p - 1 + t
    eot_id: int
    n_vocab: int
    bias_boost: float | None   # None: no biasing
    timestamp_begin: int | None
    max_initial_timestamp_index: int | None
    temperature: float


@dataclasses.dataclass
class StepState:
    """Every tensor one cached decode step reads or writes, so that a step
    is a function of this state alone (``decode_step``) and can be recorded
    once as a CUDA graph and replayed on the same buffers."""
    cur: torch.Tensor          # (B,) int64: the token the step feeds
    pos: torch.Tensor          # (B,) int64: its position id
    t: torch.Tensor            # () int64: the generation index the step writes
    finished: torch.Tensor     # (B,) bool
    sum_lp: torch.Tensor       # (B,) f32
    out: torch.Tensor          # (B, max_new) int64
    prev: torch.Tensor         # (B,) int64: the generated token before cur (-1 = none)
    last_ts: torch.Tensor      # (B,) int64: the last timestamp token (0 = none)
    matched: torch.Tensor      # (B, N) int32: the bias trie's matched lengths
    span_len: torch.Tensor     # (B, N) int32
    spans: torch.Tensor        # (B, N, K) int32
    key_mask: torch.Tensor     # (B, P + max_new) bool
    forced_at: torch.Tensor | None   # (B,) int64
    suppress: torch.Tensor | None    # (S,) int64
    margins: torch.Tensor | None     # (B, max_new) f32
    cache: dict                # self-attention k, v (L, B, P + max_new, D)
    cross_kv: object           # the int8 dict or (k, v)

    def _tensors(self) -> list[str]:
        return [f.name for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def owned(self) -> "StepState":
        """A copy whose tensors share no memory with the call's inputs (a
        signature's buffers); the cache and the cross K/V stay shared."""
        return dataclasses.replace(self, **{k: getattr(self, k).clone() for k in self._tensors()})

    def load(self, other: "StepState") -> None:
        """Copy ``other``'s per-call tensors into these buffers (the cache
        and the cross K/V are written in place by the prefill)."""
        for k in self._tensors():
            getattr(self, k).copy_(getattr(other, k))


def _pick(lg, rule: _Rule, st: StepState, ts_state, *, is_first: bool, row_draws=None):
    """The filtered pick of one step from logits (B, V): suppression, the
    bias bonus, the timestamp rules, then argmax (or a draw); returns the
    token and its logprob, and writes the margin at ``st.t``."""
    lg = lg.float()
    if st.suppress is not None:
        lg = lg.index_fill(1, st.suppress, NEG)
    if rule.bias_boost is not None:
        with span("decode.bias"):
            lg = lg + bias_bonus(BiasTrieState(st.matched, st.span_len), st.spans,
                                 rule.n_vocab, rule.bias_boost)
    if rule.timestamp_begin is not None:
        lg = apply_timestamp_rules(
            lg, *ts_state, timestamp_begin=rule.timestamp_begin, eot_id=rule.eot_id,
            is_first=is_first, max_initial_timestamp_index=rule.max_initial_timestamp_index)
    if rule.temperature > 0.0:
        nxt = sample_tokens(lg, rule.temperature, row_draws.next())
    else:
        nxt = torch.argmax(lg, dim=-1)
    logp = torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None])[:, 0]
    if st.margins is not None:
        top2 = lg.topk(2, dim=-1).values
        st.margins.index_copy_(1, st.t.view(1), (top2[:, 0] - top2[:, 1])[:, None])
    return nxt, logp


def _advance_trie(rule: _Rule, st: StepState, tok) -> None:
    if rule.bias_boost is not None:
        with span("decode.bias"):
            st.matched.copy_(advance_bias_state(BiasTrieState(st.matched, st.span_len),
                                                st.spans, tok).matched)


def decode_step(model: Whisper, st: StepState, rule: _Rule, row_draws=None) -> None:
    """One cached S = 1 decoder step at generation index ``st.t`` (>= 1),
    in place on ``st``: the token at ``out[:, t]``, the rows finished, the
    summed logprob, the trie, the timestamp state, the cache slot
    ``p - 1 + t``; then ``t`` and the positions advance. Every index is a
    device value, so the host reads nothing: the eager loop calls this, and
    the captured graph is this function recorded."""
    lg, _ = decode_tokens(model, st.cur[:, None], cross_kv=st.cross_kv, cache=st.cache,
                          pos_offset=st.t + (rule.p - 1), token_positions=st.pos[:, None],
                          self_mask=st.key_mask)
    nxt, lp = _pick(lg[:, -1], rule, st, (st.cur, st.prev, st.last_ts), is_first=False,
                    row_draws=row_draws)
    if st.forced_at is not None:
        forced = st.t >= st.forced_at
        nxt = torch.where(forced, rule.eot_id, nxt)
        lp = torch.where(forced, 0.0, lp)
    nxt = torch.where(st.finished, rule.eot_id, nxt)
    st.sum_lp.add_(torch.where(st.finished, 0.0, lp))
    st.out.index_copy_(1, st.t.view(1), nxt[:, None])
    st.finished.logical_or_(nxt == rule.eot_id)
    _advance_trie(rule, st, nxt)
    if rule.timestamp_begin is not None:
        st.last_ts.copy_(torch.where(nxt >= rule.timestamp_begin, nxt, st.last_ts))
    st.prev.copy_(st.cur)
    st.cur.copy_(nxt)
    st.pos.add_(1)
    st.t.add_(1)


# Captured decode steps (``_StepGraph``) kept per model, least recently used
# out first: each holds its own cross K/V, cache and graph memory.
MAX_GRAPHS = 4
# eager steps, on the capture's side stream, before a signature's capture
WARMUP_STEPS = 2
_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_graphs_lock = threading.Lock()


class _StepGraph:
    """One call signature's captured step: the static ``StepState`` its
    graph reads and writes, the graph once captured, and the kernel
    launches (``ops._build.launches``) that one replay makes."""

    def __init__(self):
        self.state: StepState | None = None
        self.graph = None
        self.launches: dict[str, int] = {}
        self.stream = None
        self.busy = True
        self.keep = None  # the cached vocab weight the graph reads

    def step(self, model: Whisper, rule: _Rule, t: int) -> None:
        """Step ``t`` (1-based): eager on the side stream for the first
        ``WARMUP_STEPS`` of a signature not yet captured, then one capture,
        then a replay a step."""
        st = self.state
        if self.stream is None:
            self.stream = torch.cuda.Stream(st.out.device)
        if self.graph is None and t <= WARMUP_STEPS:
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                decode_step(model, st, rule)
            cur.wait_stream(self.stream)
            return
        if self.graph is None:
            before = dict(_build.launches)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                decode_step(model, st, rule)
            # a capture launches nothing: its counts move to each replay
            self.launches = {k: n - before.get(k, 0) for k, n in _build.launches.items()
                             if n != before.get(k, 0)}
            _build.count_launches({k: -n for k, n in self.launches.items()})
            self.graph, self.keep = graph, model.decoder._vocab_acc
            count("decode.graph_captures")
        self.graph.replay()
        _build.count_launches(self.launches)
        count("decode.graph_steps")


def _capturable(model: Whisper, device: torch.device, temperature: float, row_offset: int,
                global_rows) -> bool:
    """Whether a call's steps can run as one captured graph: a CUDA model
    not sharded over "model", all of the batch's rows (no mesh), greedy
    picks (a draw reads a host generator)."""
    return (device.type == "cuda" and model.tp is None and row_offset == 0
            and global_rows is None and temperature == 0.0)


def _claim_graph(model: Whisper, key) -> _StepGraph | None:
    """The signature ``key``'s ``_StepGraph`` for ``model``, marked busy
    (a new one, the least recently used dropped beyond ``MAX_GRAPHS``);
    None while another call holds it."""
    with _graphs_lock:
        kept = _graphs.setdefault(model, collections.OrderedDict())
        entry = kept.get(key)
        if entry is not None:
            if entry.busy:
                return None
            kept.move_to_end(key)
            entry.busy = True
            return entry
        idle = [k for k, e in kept.items() if not e.busy]
        for old in idle[:max(0, len(kept) + 1 - MAX_GRAPHS)]:
            del kept[old]
        entry = kept[key] = _StepGraph()
        return entry


def _signature(model: Whisper, rule: _Rule, *shape) -> tuple:
    """What a captured step depends on beyond its state's values: the
    baked-in values, the shapes and which optional parts run (``shape``),
    the compute dtype, and the address and version of every weight (a
    weight replaced or updated in place makes another signature, so no
    graph reads a stale derived weight)."""
    weights = tuple((w.data_ptr(), w._version)
                    for w in itertools.chain(model.parameters(), model.buffers()))
    return rule, shape, model.cfg.compute_dtype, weights


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
    timestamp rules.

    Each step is ``decode_step`` on a ``StepState``. Where the call allows
    it (``_capturable``: greedy on a CUDA model holding all the rows), the
    steps of a call signature run as one CUDA graph, captured once after
    ``WARMUP_STEPS`` eager steps and replayed once a step on the
    signature's buffers, into which each call's prefill writes; everywhere
    else the same function runs eagerly."""
    device = resolve_device(device)
    if next(model.parameters()).device != device:
        raise ValueError(f"model is on {next(model.parameters()).device}, decode asked for {device}")
    with span("decode"):
        cfg = model.cfg
        feats = _as_tensor(input_features, device, torch.float32)
        ids = _as_tensor(prefix_ids, device, torch.int64)
        mask = _as_tensor(prefix_mask, device, torch.bool)
        b, p = ids.shape
        count("decode.rows", b)
        # prompt + new tokens share the n_text_ctx window
        max_new = min(max_new, cfg.n_text_ctx - p)
        if max_new < 1:
            raise ValueError(f"prefix length {p} leaves no room to generate "
                             f"(n_text_ctx {cfg.n_text_ctx})")
        clock = Clock(device) if timings is not None else None
        if clock:
            clock.mark("start")

        with span("decode.encode"):
            enc_out = encode_audio(model, feats)
        if clock:
            clock.mark("encoded")
        use_bias = bias_spans is not None and bias_boost != 0.0
        rule = _Rule(p, eot_id, cfg.n_vocab, float(bias_boost) if use_bias else None,
                     timestamp_begin, max_initial_timestamp_index, float(temperature))
        spans = (torch.zeros((b, 1, 1), dtype=torch.int32, device=device) if bias_spans is None
                 else _as_tensor(bias_spans, device, torch.int32))
        row_draws = (RowDraws(call_seed(generator), b, row_offset, global_rows, device)
                     if temperature > 0.0 else None)
        graph = None
        if _capturable(model, device, temperature, row_offset, global_rows):
            graph = _claim_graph(model, _signature(
                model, rule, b, max_new, spans.shape, enc_out.shape[1],
                forced_eot_at is not None, tuple(suppress_tokens), return_margins))
        try:
            # a captured signature's buffers: the prefill writes the cross
            # K/V and the cache into them, and they take the call's state
            fixed = None if graph is None else graph.state
            with span("decode.prefill", device):
                kept = None if fixed is None else fixed.cross_kv
                if cfg.quantize_cross_kv:
                    cross_kv = quantize_cross_kv(precompute_cross_kv(model, enc_out),
                                                 tp=model.tp, out=kept)
                else:
                    cross_kv = precompute_cross_kv(model, enc_out, out=kept)
                if fixed is None:
                    cache = init_kv_cache(cfg, b, p + max_new, device, width=kv_width(model))
                else:
                    cache = fixed.cache
                    for c in cache.values():
                        c.zero_()

                # positions: pads don't advance the position counter (left-pad support)
                prefix_pos = torch.clamp(torch.cumsum(mask.to(torch.int64), dim=1) - 1, min=0)
                key_mask = torch.cat(
                    [mask, torch.ones((b, max_new), dtype=torch.bool, device=device)], 1)
                logits, cache = decode_tokens(model, ids, cross_kv=cross_kv, cache=cache,
                                              pos_offset=0, token_positions=prefix_pos,
                                              self_mask=key_mask)

                no_speech_prob = None
                if no_speech_id is not None:
                    at = p - sot_offsets(sot_offset, b, device)
                    sot_lg = logits[torch.arange(b, device=device), at]
                    no_speech_prob = torch.softmax(sot_lg.float(), dim=-1)[:, no_speech_id]

                trie = init_bias_state(spans, span_pad_id)
                if use_bias:
                    # the conditioning context may end mid-bias-word: warm-start the trie
                    trie = seed_bias_state_from_prefix(trie, spans, ids, mask)

                none = torch.full((b,), -1, dtype=torch.int64, device=device)  # no token yet
                st = StepState(
                    cur=None, pos=prefix_pos[:, -1] + 1,
                    t=torch.zeros((), dtype=torch.int64, device=device), finished=None,
                    sum_lp=None,
                    out=torch.full((b, max_new), eot_id, dtype=torch.int64, device=device),
                    prev=none, last_ts=torch.zeros_like(none), matched=trie.matched,
                    span_len=trie.span_len, spans=spans, key_mask=key_mask,
                    forced_at=(None if forced_eot_at is None
                               else _as_tensor(forced_eot_at, device, torch.int64)),
                    suppress=(torch.as_tensor(suppress_tokens, dtype=torch.int64, device=device)
                              if suppress_tokens else None),
                    margins=(torch.zeros((b, max_new), dtype=torch.float32, device=device)
                             if return_margins else None),
                    cache=cache, cross_kv=cross_kv)
                cur, sum_lp = _pick(logits[:, -1], rule, st, (none, none, st.last_ts),
                                    is_first=True, row_draws=row_draws)
                if st.forced_at is not None:
                    # the cap overrides the model's pick and its logprob doesn't count
                    forced0 = st.forced_at <= 0
                    cur = torch.where(forced0, eot_id, cur)
                    sum_lp = torch.where(forced0, 0.0, sum_lp)
                st.cur, st.sum_lp, st.finished = cur, sum_lp, cur == eot_id
                st.out[:, 0] = cur
                _advance_trie(rule, st, cur)
                # timestamp-rule row state: the generated token before cur, the last timestamp
                if timestamp_begin is not None:
                    st.last_ts = torch.where(cur >= timestamp_begin, cur, st.last_ts)
                st.t += 1
                if fixed is not None:
                    fixed.load(st)
                    st = fixed
                elif graph is not None:
                    st = graph.state = st.owned()
                if clock:
                    clock.mark("prefilled")
                # the host's one wait a step: the rows still running
                live = b - int(st.finished.sum())

            t = 1
            while t < max_new and live:
                with span("decode.step"):
                    count("decode.live_rows", live)
                    if graph is None:
                        decode_step(model, st, rule, row_draws)
                    else:
                        graph.step(model, rule, t)
                    t += 1
                    if t < max_new:
                        with span("decode.sync"):
                            live = b - int(st.finished.sum())

            lengths = torch.cumprod((st.out != eot_id).to(torch.int32), dim=1).sum(dim=1)
            if clock:
                clock.mark("done")
                timings.update(encode_ms=clock.ms("start", "encoded"),
                               prefill_ms=clock.ms("encoded", "prefilled"),
                               decode_ms=clock.ms("prefilled", "done"), steps=t - 1)
            # copies: a signature's buffers are the next call's
            return GreedyResult(st.out.to(torch.int32), lengths.to(torch.int32),
                                st.sum_lp.clone(), no_speech_prob,
                                margins=None if st.margins is None else st.margins.clone())
        finally:
            if graph is not None:
                graph.busy = False


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
