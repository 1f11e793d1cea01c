"""The port's CUDA kernels against their plain torch versions, at edge
shapes the main path does not reach (ragged tiles, kv_len < Tk, Tq != Tk,
causal, strided views, every layer offset, 128 mels, the int8
cross-attention at every batch, head count and split of T_pad, the fused
LayerNorm+matmul at every model width's d, row count and column count), plus
a small end-to-end decode, beam
search on the int8 cross-attention kernel against the plain path, seeded
sampling with a CUDA generator, and small training steps (unfused and fused) with the kernels on and off.

These need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and skip
elsewhere. On a machine with the card (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.audio.mel import log_mel_spectrogram_np, log_mel_tail
from whisper_context_biasing_tpu_torch.decode import beam_decode, greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import attention, build_model, tiny_test_config
from whisper_context_biasing_tpu_torch.ops.quant_cross_attention import pick_splits
from whisper_context_biasing_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("batch,n_samples,n_mels", [(3, 3217, 80), (3, 48000, 128),
                                                    (8, 480000, 80), (1, 480000, 80),
                                                    (2, 160 * 203 + 37, 80)])
def test_mel_kernel(dev, batch, n_samples, n_mels):
    rng = np.random.default_rng(0)
    t = np.arange(n_samples) / 16000.0
    audio = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal((batch, n_samples))
    x = torch.from_numpy(audio.astype(np.float32)).to(dev)
    ops.reset_launch_counts()
    kern = ops.mel_energies(x, n_mels)
    assert ops.launches["mel"] == 1
    plain = ops.mel_energies_plain(x, n_mels)
    assert kern.shape == (batch, n_samples // 160, n_mels)
    torch.testing.assert_close(log_mel_tail(kern), log_mel_tail(plain), atol=1e-4, rtol=0)


@pytest.mark.parametrize("level", [1.0, 1e-3])
def test_mel_kernel_matches_float64_reference(dev, level):
    """A loud and a quiet 30 s clip against the float64 numpy frontend."""
    rng = np.random.default_rng(1)
    t = np.arange(480000) / 16000.0
    clip = level * (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
                    + 0.05 * rng.standard_normal(t.size))
    clip = clip.astype(np.float32)
    got = log_mel_tail(ops.mel_energies(torch.from_numpy(clip[None]).to(dev), 80))[0]
    np.testing.assert_allclose(got.cpu().numpy(), log_mel_spectrogram_np(clip, 80), atol=1e-4,
                               rtol=0)


# shapes that straddle the kernels' tiles (f32: 64 query rows x 64 keys;
# bf16: 128 x 64 forward, 64 x 64 backward, worked 16 rows a warp), with
# kv_len inside the first and the last key tile
FLASH_SHAPES = [(100, 100, 100), (100, 100, 77), (40, 300, 300), (129, 65, 1), (1, 1, 1),
                (15, 8, 8), (127, 63, 63), (128, 65, 65), (129, 300, 300), (257, 300, 300),
                (1, 300, 300), (257, 8, 3), (128, 300, 17), (257, 300, 290), (15, 65, 64)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq,tk,kv_len", FLASH_SHAPES)
def test_flash_kernel(dev, dtype, atol, tq, tk, kv_len):
    rng = np.random.default_rng(tq + tk + kv_len)
    q = _rand(rng, (2, tq, 3, 64), dev, dtype)
    k, v = _rand(rng, (2, tk, 3, 64), dev, dtype), _rand(rng, (2, tk, 3, 64), dev, dtype)
    o, lse = ops.flash_attention_fwd(q, k, v, kv_len)
    po, plse = ops.flash_attention_fwd_plain(q, k, v, kv_len)
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


def test_flash_kernel_reads_merged_heads_in_place(dev):
    rng = np.random.default_rng(1)
    qkv = _rand(rng, (2, 70, 3 * 128), dev)  # q | k | v side by side, 2 heads each
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]  # strided views
    got = ops.flash_attention(q, k, v, 2)
    want, _ = ops.flash_attention_fwd_plain(*(x.reshape(2, 70, 2, 64) for x in (q, k, v)))
    torch.testing.assert_close(got, want.reshape(2, 70, 128), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_quant_cross_kernel_every_layer(dev, dtype, atol):
    rng = np.random.default_rng(2)
    shape = (3, 2, 192, 128)
    k_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    v_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    sc = rng.uniform(0.005, 0.05, (2, 3, 2, 1, 192)).astype(np.float32)
    sc[..., 150:] = 0.0
    k_s, v_s = (torch.from_numpy(s).to(dev) for s in sc)
    q = _rand(rng, (2, 1, 128), dev, dtype)
    for layer in range(3):
        got = ops.quant_cross_attention_step_indexed(q, k_q, k_s, v_q, v_s, layer, 2)
        want = ops.quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s, layer, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_quant_cross_one_layer_step(dev, dtype, atol):
    """``quant_cross_attention_step`` on one layer's (B, T_pad, D) K/V
    launches K3 once and gives its plain version's result."""
    rng = np.random.default_rng(4)
    k_q, k_s, v_q, v_s = (x[0] for x in _quant_kv(rng, dev, 1, 2, 1536, 512, 1500))
    q = _rand(rng, (2, 1, 512), dev, dtype)
    ops.reset_launch_counts()
    got = ops.quant_cross_attention_step(q, k_q, k_s, v_q, v_s, 8)
    assert ops.launches["quant_cross_attention"] == 1
    want = ops.quant_cross_attention_plain(q, k_q, k_s, v_q, v_s, 8)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x.float().abs().max().item())) - 7)


def _quant_kv(rng, dev, n_layers, b, t_pad, d, t_real):
    shape = (n_layers, b, t_pad, d)
    k_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    v_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    sc = rng.uniform(0.005, 0.05, (2, n_layers, b, 1, t_pad)).astype(np.float32)
    sc[..., t_real:] = 0.0  # zero scale marks the padding
    k_s, v_s = (torch.from_numpy(x).to(dev) for x in sc)
    return k_q, k_s, v_q, v_s


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads", [6, 8, 20])
@pytest.mark.parametrize("t_pad,t_real", [(128, 100), (1536, 1500)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_quant_cross_kernel_shapes(dev, b, t_pad, t_real, heads, dtype, atol):
    """Every layer of a 2-layer stack at the family's head counts, from one
    row (8 blocks share a head's keys) to 64 (3 do), against the plain
    version; and the same bits from 4 runs on the same inputs. f32: scores
    of up to 64 terms and outputs of up to 1,500 summed in another order,
    1e-5 of the largest output (|out| reaches ~4 over 82,000 outputs). bf16:
    the output's last rounding may go either way, so the limit is 1e-2 or,
    over 100 keys where |out| reaches ~4, one bf16 ulp of the largest output."""
    rng = np.random.default_rng(b + t_pad + heads)
    d = 64 * heads
    kv = _quant_kv(rng, dev, 2, b, t_pad, d, t_real)
    q = _rand(rng, (b, 1, d), dev, dtype)
    for layer in range(2):
        ops.reset_launch_counts()
        got = ops.quant_cross_attention_step_indexed(q, *kv, layer, heads)
        assert ops.launches["quant_cross_attention"] == 1
        want = ops.quant_cross_attention_step_indexed_plain(q, *kv, layer, heads)
        if dtype == torch.bfloat16:
            atol = max(atol, _bf16_ulp(want))
        else:
            atol = max(atol, 1e-5 * want.abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
        for _ in range(3):
            assert torch.equal(got, ops.quant_cross_attention_step_indexed(q, *kv, layer, heads))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t_real", [1500, 1000, 1])
@pytest.mark.parametrize("b,splits", [(22, 3), (17, 4), (11, 6), (3, 8)])
def test_quant_cross_kernel_every_split(dev, b, splits, dtype, atol, t_real):
    """Every way the wrapper splits T_pad = 1,536 over a cluster (chosen by
    the batch size at 2 heads) gives the plain version's result, also where
    whole splits are padding (1,000 real keys: the last of 3, the last 2 of
    8; one real key: all but the first)."""
    assert pick_splits(1536, 2 * b) == splits
    rng = np.random.default_rng(t_real + b)
    kv = _quant_kv(rng, dev, 1, b, 1536, 128, t_real)
    q = _rand(rng, (b, 1, 128), dev, dtype)
    want = ops.quant_cross_attention_step_indexed_plain(q, *kv, 0, 2)
    got = ops.quant_cross_attention_step_indexed(q, *kv, 0, 2)
    assert torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:  # one real key: |out| = |v| up to 6
        atol = max(atol, _bf16_ulp(want))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_quant_cross_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 1, 64), device=dev)
    ks = torch.ones((1, 1, 1, 1536), device=dev)
    kq = torch.zeros((1, 1, 1536, 64), dtype=torch.int8, device=dev)
    ops.reset_launch_counts()
    odd = torch.zeros((1, 1, 100, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="T_pad = 100"):
        ops.quant_cross_attention_step_indexed(q, odd, ks[..., :100].contiguous(), odd,
                                               ks[..., :100].contiguous(), 0, 1)
    shifted = torch.zeros(1536 * 64 + 1, dtype=torch.int8, device=dev)[1:].view(1, 1, 1536, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.quant_cross_attention_step_indexed(q, shifted, ks, kq, ks, 0, 1)
    assert not ops.launches


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 10, 1, 32), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_fwd(x, x, x)
    kq = torch.zeros((2, 1, 128, 64), dtype=torch.int8, device=dev)
    ks = torch.ones((2, 1, 1, 128), device=dev)
    q = torch.zeros((1, 1, 64), device=dev)
    with pytest.raises(ValueError, match="layer"):
        ops.quant_cross_attention_step_indexed(q, kq, ks, kq, ks, 2, 1)
    with pytest.raises(ValueError, match="float32"):
        ops.mel_energies(torch.zeros((1, 3200), dtype=torch.float64, device=dev))


def test_greedy_decode_kernels_match_plain(dev):
    """A one-head tiny model (head dim 64, as the kernels take): the same
    greedy decode with every kernel, and with the plain versions, in f32."""
    kernels = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
    plain = dict(kernels, flash_attention=False, fused_quant_cross=False)
    mel = np.random.default_rng(3).standard_normal((2, 80, 128)).astype(np.float32)
    ids, mask = pack_prefixes([[50360, 40, 41, 50257], [50257]], 50256)
    out = []
    for over in (kernels, plain):
        model = build_model(tiny_test_config(n_heads=1, **over), seed=0, device=dev)
        ops.reset_launch_counts()
        res = greedy_decode(model, mel, ids, mask, max_new=6, device=dev)
        out.append((res.tokens.cpu(), dict(ops.launches)))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1]["flash_attention"] == 2 and out[0][1]["quant_cross_attention"] > 0
    assert not out[1][1]


@pytest.mark.parametrize("mode", ["off", "true"])
def test_beam_decode_kernels_match_plain(dev, mode):
    """Beam search (3 beams, timestamp rules) with the int8 cross-K/V
    repeated across beams through the K3 kernel, against the plain path, in
    f32: identical tokens, and K3 launched once per layer per step."""
    kernels = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
    plain = dict(kernels, flash_attention=False, fused_quant_cross=False)
    mel = np.random.default_rng(4).standard_normal((2, 80, 128)).astype(np.float32)
    ids, mask = pack_prefixes([[50360, 40, 41, 50257], [50257]], 50256)
    out = []
    for over in (kernels, plain):
        model = build_model(tiny_test_config(n_heads=1, **over), seed=0, device=dev)
        ops.reset_launch_counts()
        timings = {}
        res = beam_decode(model, mel, ids, mask, num_beams=3, max_new=8, early_stopping=mode,
                          timestamp_begin=50363, device=dev, timings=timings)
        out.append((res.tokens.cpu(), res.best.cpu(), dict(ops.launches), timings))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    counts, timings = out[0][2], out[0][3]
    assert counts["quant_cross_attention"] == 2 * timings["steps"]  # 2 decoder layers
    assert counts["flash_attention"] == 2 and not out[1][2]
    assert timings["reorder_ms"] >= 0.0


SERVE_FAST = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True,
                  gelu_approx=True)


def _biased_call(b: int = 4, max_new: int = 16):
    """A small biased, capped greedy call: left-padded prompts, three bias
    words a row (none in the last), caps that end rows at other steps."""
    mel = np.random.default_rng(7).standard_normal((b, 80, 128)).astype(np.float32)
    prefixes = [[50360, 40, 41, 50257], [50257], [50360, 7, 50257], [50257]][:b]
    ids, mask = pack_prefixes(prefixes, 50256)
    spans = np.full((b, 3, 3), 50256, np.int32)
    spans[:, 0, :2] = [220, 11]
    spans[:, 1, :1] = [13]
    spans[:, 2, :3] = [40, 41, 42]
    spans[-1] = 50256
    caps = np.array([5, 11, 2, 14][:b])
    return (mel, ids, mask), dict(max_new=max_new, eot_id=50256, bias_spans=spans,
                                  bias_boost=2.0, span_pad_id=50256, forced_eot_at=caps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_greedy_matches_eager(dev, dtype, monkeypatch):
    """The serving fast path (int8 cross-K/V through K3) with bias and
    caps: the calls that capture and replay the step give the eager loop's
    tokens, lengths and summed logprobs exactly."""
    from whisper_context_biasing_tpu_torch.decode import greedy

    model = build_model(tiny_test_config(n_heads=1, dtype=dtype, **SERVE_FAST), seed=0,
                        device=dev)
    args, kw = _biased_call()
    captured = [greedy_decode(model, *args, device=dev, **kw) for _ in range(3)]
    assert greedy._graphs[model]
    monkeypatch.setattr(greedy, "_capturable", lambda *a: False)
    eager = greedy_decode(model, *args, device=dev, **kw)
    for res in captured:
        assert torch.equal(res.tokens, eager.tokens)
        assert torch.equal(res.lengths, eager.lengths)
        assert torch.equal(res.sum_logprob, eager.sum_logprob)


def test_greedy_captures_once_a_signature(dev):
    """Three calls of one signature make one capture and launch K3 once a
    layer a step (the replays count their graph's launches); another
    signature makes another capture; the cache keeps at most MAX_GRAPHS."""
    from whisper_context_biasing_tpu_torch.decode import greedy

    model = build_model(tiny_test_config(n_heads=1, dtype="bfloat16", **SERVE_FAST), seed=0,
                        device=dev)
    args, kw = _biased_call()
    ops.reset_launch_counts()
    steps = []
    for _ in range(3):
        timings = {}
        greedy_decode(model, *args, device=dev, timings=timings, **kw)
        steps.append(timings["steps"])
    kept = greedy._graphs[model]
    assert len(kept) == 1
    graph = next(iter(kept.values())).graph
    assert graph is not None
    assert ops.launches["quant_cross_attention"] == model.cfg.n_text_layers * sum(steps)
    greedy_decode(model, *args, device=dev, **kw)
    assert next(iter(kept.values())).graph is graph
    for max_new in range(17, 18 + greedy.MAX_GRAPHS):
        greedy_decode(model, *args, device=dev, **dict(kw, max_new=max_new))
        assert 2 <= len(kept) <= greedy.MAX_GRAPHS


def test_captured_greedy_spans_and_trace(dev):
    """Under the profiler, the capturing call and a replaying call each
    have one ``decode.step`` a step; ``decode.graph_steps`` counts the
    replayed steps (all but the warm-up ones in the capturing call) and
    ``decode.graph_captures`` the one capture; the trace shows K3 once a
    layer a step, inside the replays too."""
    from whisper_context_biasing_tpu_torch.decode import greedy
    from whisper_context_biasing_tpu_torch.utils import profiling

    model = build_model(tiny_test_config(n_heads=1, dtype="bfloat16", **SERVE_FAST), seed=0,
                        device=dev)
    args, kw = _biased_call()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.reset_spans()
    steps = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            timings = {}
            greedy_decode(model, *args, device=dev, timings=timings, **kw)
            steps.append(timings["steps"])
        torch.cuda.synchronize()
    got = profiling.spans()
    roots = [s for s in got if s["name"] == "decode" and s["parent"] is None]
    assert len(roots) == 2
    for root, n, warm in zip(roots, steps, (greedy.WARMUP_STEPS, 0)):
        mine = [s for s in got if s["root"] == root["id"]]
        assert sum(s["name"] == "decode.step" for s in mine) == n
        assert root["counters"]["decode.graph_steps"] == n - warm
        assert root["counters"].get("decode.graph_captures", 0) == (1 if warm else 0)
    k3 = sum(e.count for e in prof.key_averages() if "quant_cross" in e.key
             and e.device_type == torch.autograd.DeviceType.CUDA)
    assert k3 == model.cfg.n_text_layers * sum(steps)


def test_cuda_generator_sampling_is_seeded(dev):
    """Temperature 1.0 with a generator on the card: one seed, one draw."""
    model = build_model(tiny_test_config(n_heads=1), seed=0, device=dev)
    mel = np.random.default_rng(5).standard_normal((2, 80, 128)).astype(np.float32)
    ids, mask = pack_prefixes([[50257], [50257]], 50256)

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return greedy_decode(model, mel, ids, mask, max_new=8, temperature=1.0, generator=gen,
                             device=dev).tokens.cpu()

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [1, 64, 100, 127, 129, 448])
def test_flash_kernel_causal(dev, dtype, atol, t):
    rng = np.random.default_rng(t)
    q, k, v = (_rand(rng, (2, t, 3, 64), dev, dtype) for _ in range(3))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    po, plse = ops.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


# f32: sums in other orders; bf16: dS and P round to bf16 before the
# products on both routes, and a value near a rounding boundary may round
# the other way, so the limit is 1% of the largest gradient (~2.5 bf16 ulps
# at the top of the range), plus 1e-5 for rows that attend to one key, whose
# dS = P (dP - D) is f32 cancellation noise around an exact 0
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,kv_len,causal", [
    *((tq, tk, kv_len, False) for tq, tk, kv_len in FLASH_SHAPES),
    (1, 1, 1, True), (100, 100, 100, True), (127, 127, 127, True), (129, 129, 129, True),
    (448, 448, 448, True)])
def test_flash_backward_kernel(dev, dtype, tq, tk, kv_len, causal):
    rng = np.random.default_rng(tq + 7 * tk + kv_len)
    q = _rand(rng, (2, tq, 3, 64), dev, dtype)
    k, v = _rand(rng, (2, tk, 3, 64), dev, dtype), _rand(rng, (2, tk, 3, 64), dev, dtype)
    do = _rand(rng, (2, tq, 3, 64), dev, dtype)
    o, lse = ops.flash_attention_fwd_plain(q, k, v, kv_len, causal)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, kv_len, causal)
    assert ops.launches["flash_attention_bwd"] == 1
    want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, kv_len, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        atol = 2e-5 if dtype == torch.float32 else 1e-2 * w.float().abs().max().item() + 1e-5
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def _strided_views(rng, dev, dtype, layout, t):
    """q, k, v, do as (2, t, 2, 64) views that are not contiguous: every
    other batch row of a larger tensor, or (q, k, v) side by side in one
    (2, t, 3 * 128) projection output as the fused QKV path hands them."""
    if layout == "batch strided":
        return [_rand(rng, (4, t, 2, 64), dev, dtype)[::2] for _ in range(4)]
    qkv = _rand(rng, (2, t, 3 * 128), dev, dtype)
    views = [qkv[..., i * 128:(i + 1) * 128].view(2, t, 2, 64) for i in range(3)]
    return views + [_rand(rng, (2, t, 2, 64), dev, dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["batch strided", "fused qkv"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_read_strided_views(dev, dtype, layout, causal):
    """Forward and backward through views (aligned for the bf16 kernels'
    16-byte copies) give what they give on contiguous copies."""
    q, k, v, do = _strided_views(np.random.default_rng(11), dev, dtype, layout, 150)
    assert not q.is_contiguous()
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
    oc, lsec = ops.flash_attention_fwd(qc, kc, vc, causal=causal)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    for g, w in zip(got, ops.flash_attention_bwd(qc, kc, vc, oc, lsec, doc, causal=causal)):
        assert g.is_contiguous() and torch.equal(g, w)
    po, _ = ops.flash_attention_fwd_plain(q, k, v, causal=causal)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=0)


def _misaligned(dev, dtype):
    """Two (2, 20, 2, 64) views: one starting an element into its storage,
    one with rows an odd number of elements (129) apart."""
    offset = torch.zeros(2 * 20 * 2 * 64 + 1, device=dev, dtype=dtype)[1:].view(2, 20, 2, 64)
    odd_rows = torch.zeros((2, 20, 129), device=dev, dtype=dtype)[..., :128].view(2, 20, 2, 64)
    return offset, odd_rows


def test_flash_wrappers_reject_misaligned_bf16(dev):
    """The bf16 kernels copy 16 bytes at a time: a view that starts 2 bytes
    into its storage, or whose rows are an odd number of elements apart,
    raises from both wrappers (no copy behind the caller's back); the f32
    kernels load element by element and take both."""
    good = torch.zeros((2, 20, 2, 64), device=dev, dtype=torch.bfloat16)
    lse = torch.zeros((2, 2, 20), device=dev)
    ops.reset_launch_counts()
    for bad in _misaligned(dev, torch.bfloat16):
        with pytest.raises(ValueError, match="tensor k must start on a 16-byte boundary"):
            ops.flash_attention_fwd(good, bad, good)
        with pytest.raises(ValueError, match="tensor do must start on a 16-byte boundary"):
            ops.flash_attention_bwd(good, good, good, good, lse, bad)
    assert not ops.launches
    for bad in _misaligned(dev, torch.float32):
        o, _ = ops.flash_attention_fwd(good.float(), bad, good.float())
        assert not o.any()  # v is zero
    assert ops.launches == {"flash_attention": 2}


@pytest.mark.parametrize("tq,tk,causal", [(300, 300, False), (448, 448, True), (130, 300, False)])
def test_flash_backward_is_deterministic(dev, tq, tk, causal):
    """No atomics and every sum in a fixed order: two runs of the bf16
    backward give the same bits."""
    rng = np.random.default_rng(12)
    q, do = (_rand(rng, (2, tq, 3, 64), dev, torch.bfloat16) for _ in range(2))
    k, v = (_rand(rng, (2, tk, 3, 64), dev, torch.bfloat16) for _ in range(2))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = ops.flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    first = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for _ in range(3):
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), name


def test_flash_autograd_reads_merged_heads_in_place(dev):
    """Gradients of the kernels through strided merged-head views equal
    autograd of the plain attention with the causal mask."""
    rng = np.random.default_rng(5)
    qkv = _rand(rng, (2, 70, 3 * 128), dev).requires_grad_()
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    g = _rand(rng, (2, 70, 128), dev)
    (ops.flash_attention(q, k, v, 2, causal=True) * g).sum().backward()
    got, qkv.grad = qkv.grad, None
    mask = torch.ones(70, 70, dtype=torch.bool, device=dev).tril()
    (attention(q, k, v, 2, mask) * g).sum().backward()
    torch.testing.assert_close(got, qkv.grad, atol=2e-5, rtol=0)


def test_train_step_kernels_match_plain(dev):
    """A one-head tiny model (head dim 64): one f32 step with grad
    accumulation 2, the mel and flash kernels against the plain versions."""
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal((2, 2, 128 * 160)) * 0.1).astype(np.float32)
    ids = rng.integers(100, 5000, (2, 2, 12)).astype(np.int32)
    spans = np.full((2, 2, 1, 2), 50256, np.int32)
    spans[..., 0, :] = ids[..., 3:5]
    batch = dict(decoder_input_ids=ids, labels=ids, bias_spans=spans)
    feats = ops.log_mel_spectrogram_fused(torch.from_numpy(audio).flatten(0, 1))  # CPU: plain
    runs = []
    for kernels in (True, False):
        cfg = tiny_test_config(n_heads=1, flash_attention=kernels, flash_decoder_min_seq=0)
        model = build_model(cfg, seed=0, device=dev, train=True)
        opt = make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, opt, grad_accum=2, mel_on_device=kernels)
        b = dict(batch, audio=audio) if kernels else dict(
            batch, input_features=feats.view(2, 2, 80, 128).numpy())
        ops.reset_launch_counts()
        _, m = step(init_train_state(model, opt), b)
        runs.append((float(m["loss"]), [p.grad.clone() for p in model.parameters()],
                     dict(ops.launches)))
    (kl, kg, kc), (pl, pg, pc) = runs
    # per microbatch: mel 1; 6 flash uses (2 encoder, 2 x 2 decoder), each
    # forward run twice under full remat, each backward once
    assert kc == {"mel": 2, "flash_attention": 24, "flash_attention_bwd": 12}
    assert not pc
    assert kl == pytest.approx(pl, rel=1e-5)
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# the fused LayerNorm+matmul kernel: f32 sums over d in another order;
# bf16 rounds y = LN(x) * g + beta to bf16 before the product on both
# routes (a value at a rounding boundary may go either way) and the output
# once more: 1% of the largest output
@pytest.mark.parametrize("d", [384, 512, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
def test_fused_ln_matmul_kernel(dev, act, dtype, d):
    rng = np.random.default_rng(d)
    e = 3 * d + 72  # a ragged last column tile
    x = (_rand(rng, (2, 151, d), dev) * 2 + 0.5).to(dtype)  # N = 302, a ragged row tile
    g, beta = 1 + 0.1 * _rand(rng, (d,), dev), 0.1 * _rand(rng, (d,), dev)
    w = (_rand(rng, (e, d), dev) / d ** 0.5).to(dtype).t()  # an nn.Linear weight, transposed
    b = _rand(rng, (e,), dev)
    ops.reset_launch_counts()
    got = ops.fused_ln_matmul(x, g, beta, w, b, act=act)
    assert ops.launches["fused_ln_matmul"] == 1
    want = ops.fused_ln_matmul_plain(x, g, beta, w, b, act=act)
    assert got.dtype == dtype and got.shape == (2, 151, e)
    atol = 2e-5 if dtype == torch.float32 else 1e-2 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    nobias = ops.fused_ln_matmul(x, g, beta, w.contiguous(), act=act)  # W copied to W^T
    torch.testing.assert_close(nobias.float(), ops.fused_ln_matmul_plain(
        x, g, beta, w, act=act).float(), atol=atol, rtol=0)


@pytest.mark.parametrize("d", [384, 512, 1280])
@pytest.mark.parametrize("e", [512, 1536, 2048, 5120])
@pytest.mark.parametrize("n", [1, 63, 64, 129, 3584, 12000])
def test_fused_ln_matmul_bf16_kernel_shapes(dev, n, e, d):
    """The bf16 kernel at one row, either side of its 64- and 128-row
    blocks and at the model's row counts, for every activation, with and
    without the bias: within 1% of the plain version's largest output."""
    rng = np.random.default_rng(n + e + d)
    x = (_rand(rng, (n, d), dev) * 2 + 0.5).to(torch.bfloat16)
    g, beta = 1 + 0.1 * _rand(rng, (d,), dev), 0.1 * _rand(rng, (d,), dev)
    w = (_rand(rng, (e, d), dev) / d ** 0.5).to(torch.bfloat16).t()
    b = _rand(rng, (e,), dev)
    ops.reset_launch_counts()
    for act in (None, "gelu", "gelu_tanh"):
        for bias in (b, None):
            got = ops.fused_ln_matmul(x, g, beta, w, bias, act=act)
            want = ops.fused_ln_matmul_plain(x, g, beta, w, bias, act=act)
            assert got.dtype == torch.bfloat16 and got.shape == (n, e)
            atol = 1e-2 * want.float().abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0,
                                       msg=lambda m: f"act {act}, bias {bias is not None}: {m}")
    assert ops.launches["fused_ln_matmul"] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
def test_fused_ln_matmul_grads(dev, act, dtype):
    """The kernel's forward with the hand-derived backward against torch
    autograd through the plain version: 1e-4 (f32) or 1% (bf16) of each
    gradient's largest value."""
    rng = np.random.default_rng(9)
    inputs = [_rand(rng, (3, 70, 256), dev).to(dtype), 1 + 0.1 * _rand(rng, (256,), dev),
              0.1 * _rand(rng, (256,), dev), (_rand(rng, (256, 520), dev) / 16).to(dtype),
              _rand(rng, (520,), dev)]
    r = _rand(rng, (3, 70, 520), dev)
    grads = []
    for fn in (ops.fused_ln_matmul, ops.fused_ln_matmul_plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        (fn(*leaves, act=act).float() * r).sum().backward()
        grads.append([t.grad for t in leaves])
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for name, got, want in zip(("x", "g", "beta", "w", "b"), *grads):
        assert got.dtype == want.dtype, name
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=rel * scale, rtol=0,
                                   msg=f"d{name}")


def test_fused_ln_matmul_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros((4, 12), device=dev)
    with pytest.raises(ValueError, match="d % 8"):
        ops.fused_ln_matmul(x, torch.ones(12, device=dev), torch.zeros(12, device=dev),
                            torch.zeros((12, 16), device=dev))
    x = torch.zeros((4, 16), device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        ops.fused_ln_matmul(x, torch.ones(16, device=dev), torch.zeros(16, device=dev),
                            torch.zeros((16, 16), device=dev, dtype=torch.bfloat16))
    # the bf16 kernel: whole 64-deep k-slabs up to d = 1,280, 16-byte output stores
    ops.reset_launch_counts()
    for d, e, match in ((72, 64, "x has d = 72"), (1344, 64, "x has d = 1344"),
                        (128, 36, "w has E = 36")):
        with pytest.raises(ValueError, match=match):
            ops.fused_ln_matmul(torch.zeros((4, d), device=dev, dtype=torch.bfloat16),
                                torch.ones(d, device=dev), torch.zeros(d, device=dev),
                                torch.zeros((d, e), device=dev, dtype=torch.bfloat16))
    assert not ops.launches


def test_fused_train_step_kernels_match_plain(dev):
    """A one-head tiny model (head dim 64): one f32 step with grad
    accumulation 2 under both fused LayerNorm switches with every kernel,
    against the all-plain config (unfused, no flash: in f32 the same
    function up to rounding)."""
    rng = np.random.default_rng(10)
    feats = (rng.standard_normal((2, 2, 80, 128)) * 0.3).astype(np.float32)
    ids = rng.integers(100, 5000, (2, 2, 12)).astype(np.int32)
    batch = dict(input_features=feats, decoder_input_ids=ids, labels=ids,
                 bias_spans=np.full((2, 2, 1, 2), 50256, np.int32))
    runs = []
    for kernels in (True, False):
        cfg = tiny_test_config(n_heads=1, flash_attention=kernels, flash_decoder_min_seq=0,
                               fused_ln_qkv=kernels, fused_ln_mlp=kernels)
        model = build_model(cfg, seed=0, device=dev, train=True)
        opt = make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, opt, grad_accum=2)
        ops.reset_launch_counts()
        _, m = step(init_train_state(model, opt), batch)
        runs.append((float(m["loss"]), [p.grad.clone() for p in model.parameters()],
                     dict(ops.launches)))
    (kl, kg, kc), (pl, pg, pc) = runs
    # per microbatch: 2 fused sites per encoder block, 3 per decoder block,
    # each forward run twice under full remat; flash as in the unfused step
    assert kc == {"fused_ln_matmul": 40, "flash_attention": 24, "flash_attention_bwd": 12}
    assert not pc
    assert kl == pytest.approx(pl, rel=1e-5)
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
