#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (whisper_context_biasing_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It needs one CUDA device and fails (non-zero exit, no result line) without
one, or without the port's package beside it. Phases, each of which raises
on failure:

1. the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``whisper_context_biasing_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel) and holds each kernel against its
   plain torch version at base.en serving shapes with batch 8, printing the
   max error, the median of CUDA-event-timed runs, the plain version's
   time, the least time the card could take (its bound) and, where one
   PyTorch call computes the same function, that call's time;
3. the main path: ``Pipeline("base.en", device="cuda")`` with seeded random
   weights on the fast path (bf16, every kernel) serves 8 short-form
   requests with a context and bias words; the launch counts of that run
   show it went through every kernel;
4. the same requests in f32, once with the kernels and once with their
   plain versions (chosen by config and by calling the plain mel frontend,
   not by fallback; the launch counts show which ran): the tokens must be
   identical, or diverge only at a near-tie (top-2 logit gap < 1e-4).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# base.en serving shapes
BATCH = 8
N_SAMPLES = 480000
N_MELS = 80
T_AUDIO = 1500
D_MODEL = 512
N_HEADS = 8
N_LAYERS = 6
T_PAD = 1536

# NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12     # CUDA cores, no tensor cores
PEAK_BF16_FLOP_S = 989e12   # tensor cores

REPS = 20  # CUDA-event-timed runs per kernel

CONTEXT = "patient history: hypertension treated with lisinopril and metformin"
BIAS_WORDS = ["lisinopril", "metformin", "atorvastatin"]
MAX_TOKENS = 64


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def synthetic_audio(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Speech-like test signal: a few gliding harmonics under a syllable-rate
    envelope, plus noise."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    sig = 0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)
    return sig.astype(np.float32)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_mel(torch, ops):
    from whisper_context_biasing_tpu_torch.audio.mel import log_mel_tail, mel_filter_bank

    rng = np.random.default_rng(1)
    audio = np.zeros((BATCH, N_SAMPLES), np.float32)
    t = np.arange(N_SAMPLES) / 16000.0
    for i in range(BATCH):
        if i % 2:  # loud tones over noise: the f32 rounding stress case
            audio[i] = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
                        + 0.05 * rng.standard_normal(N_SAMPLES))
        else:  # 5-30 s of speech-like signal, then silence (the clamp floor)
            clip = synthetic_audio(rng, 5 + 25 * i / (BATCH - 1))
            audio[i, : clip.size] = clip
    x = torch.from_numpy(audio).cuda()
    kern = ops.mel_energies(x, N_MELS)
    plain = ops.mel_energies_plain(x, N_MELS)
    err = max_err(log_mel_tail(kern), log_mel_tail(plain))
    print(f"K1 mel: log-mel max |kernel - plain| = {err:.3e} (atol 1e-4, f32, TF32 off)")
    require(err <= 1e-4, f"mel kernel disagrees with its plain version: {err}")
    # the least work of the function, not of the kernel's dense-DFT design:
    # a 400-point real FFT per frame (~2.5 N log2 N operations), the power
    # of 201 bins, a multiply-add per nonzero of the filterbank; the audio
    # read once and the energies written once
    frames = BATCH * (N_SAMPLES // 160)
    fb_nonzeros = int(np.count_nonzero(mel_filter_bank(n_mels=N_MELS)))
    n_ops = frames * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * fb_nonzeros)
    n_bytes = 4 * (audio.size + frames * N_MELS)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_F32_FLOP_S)
    return dict(
        name="mel", route="cuda", source="whisper_context_biasing_tpu_torch/ops/csrc/mel.cu",
        replaces="whisper_context_biasing_tpu/ops/mel_kernel.py:61",
        max_abs_err=err,
        ms=median_ms(torch, lambda: ops.mel_energies(x, N_MELS)),
        plain_ms=median_ms(torch, lambda: ops.mel_energies_plain(x, N_MELS)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_flash(torch, ops):
    import torch.nn.functional as F

    # the encoder's layout: merged-head (B, T, H*64) activations, read by the
    # kernel in place as (B, T, H, 64) views
    rng = np.random.default_rng(2)
    dh = D_MODEL // N_HEADS
    qkv32 = [torch.from_numpy(rng.standard_normal((BATCH, T_AUDIO, D_MODEL), np.float32))
             .cuda().view(BATCH, T_AUDIO, N_HEADS, dh) for _ in range(3)]
    o, lse = ops.flash_attention_fwd(*qkv32)
    po, plse = ops.flash_attention_fwd_plain(*qkv32)
    err32, lerr32 = max_err(o, po), max_err(lse, plse)
    print(f"K2 flash f32 (8, 1500, 8x64): max |o err| = {err32:.3e} (atol 2e-5), "
          f"max |lse err| = {lerr32:.3e} (atol 1e-4)")
    require(err32 <= 2e-5 and lerr32 <= 1e-4, f"flash f32 disagrees: {err32}, {lerr32}")
    qkv = [t.to(torch.bfloat16) for t in qkv32]
    o, lse = ops.flash_attention_fwd(*qkv)
    po, plse = ops.flash_attention_fwd_plain(*qkv)
    err, lerr = max_err(o, po), max_err(lse, plse)
    # a typical |o| is ~0.04 here (diffuse softmax over 1500 keys), so the
    # limit is a few bf16 ulps of the output's scale, not a fixed 2e-2
    print(f"K2 flash bf16 (8, 1500, 8x64): max |o err| = {err:.3e} (atol 5e-3), "
          f"max |lse err| = {lerr:.3e} (atol 1e-4)")
    require(err <= 5e-3 and lerr <= 1e-4, f"flash bf16 disagrees: {err}, {lerr}")
    heads = [t.transpose(1, 2) for t in qkv]  # (B, H, T, dh) for SDPA
    bh = BATCH * N_HEADS
    n_ops = 4 * bh * T_AUDIO * T_AUDIO * dh
    n_bytes = 2 * 4 * bh * T_AUDIO * dh + 4 * bh * T_AUDIO
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOP_S)
    return dict(
        name="flash_attention", route="cuda",
        source="whisper_context_biasing_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="whisper_context_biasing_tpu/ops/flash_attention.py:66",
        max_abs_err=err,
        ms=median_ms(torch, lambda: ops.flash_attention_fwd(*qkv)),
        plain_ms=median_ms(torch, lambda: ops.flash_attention_fwd_plain(*qkv)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(*heads)))


def check_quant_cross(torch, ops):
    rng = np.random.default_rng(3)
    shape = (N_LAYERS, BATCH, T_PAD, D_MODEL)
    k_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    v_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    scales = rng.uniform(0.005, 0.05, (2, N_LAYERS, BATCH, 1, T_PAD)).astype(np.float32)
    scales[..., T_AUDIO:] = 0.0  # zero scale marks the padding
    k_s, v_s = (torch.from_numpy(s).cuda() for s in scales)
    q = torch.from_numpy(rng.standard_normal((BATCH, 1, D_MODEL), np.float32)).cuda()
    q = q.to(torch.bfloat16)
    err = 0.0
    for layer in range(N_LAYERS):
        kern = ops.quant_cross_attention_step_indexed(q, k_q, k_s, v_q, v_s, layer, N_HEADS)
        plain = ops.quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s, layer,
                                                             N_HEADS)
        err = max(err, max_err(kern, plain))
    print(f"K3 int8 cross-attention bf16 (6, 8, 1536, 512), every layer: "
          f"max |err| = {err:.3e} (atol 1e-2)")
    require(err <= 1e-2, f"int8 cross-attention disagrees: {err}")
    # K/V rows of the real positions, every scale, q and the output
    n_bytes = 2 * BATCH * T_AUDIO * D_MODEL + 2 * 4 * BATCH * T_PAD + 2 * 2 * BATCH * D_MODEL
    n_ops = 4 * BATCH * T_AUDIO * D_MODEL
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOP_S)
    return dict(
        name="quant_cross_attention", route="cuda",
        source="whisper_context_biasing_tpu_torch/ops/csrc/quant_cross_attention.cu",
        replaces="whisper_context_biasing_tpu/ops/quant_cross_attention.py:48",
        max_abs_err=err,
        ms=median_ms(torch, lambda: ops.quant_cross_attention_step_indexed(
            q, k_q, k_s, v_q, v_s, 3, N_HEADS)),
        plain_ms=median_ms(torch, lambda: ops.quant_cross_attention_step_indexed_plain(
            q, k_q, k_s, v_q, v_s, 3, N_HEADS)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path, then f32 kernels vs plain versions
# ---------------------------------------------------------------------------

def requests(rng):
    return [synthetic_audio(rng, 5 + 25 * i / (BATCH - 1)) for i in range(BATCH)]


def profile_run(torch, pipe, clips, kwargs, card, wall_ms, table_path):
    """One more main-path batch under torch.profiler: device time by kernel,
    and the device's busy share of ``wall_ms``, the same batch's wall time
    without the profiler (which slows the host side many times over). The
    full table goes to ``table_path``."""
    import pathlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
    # device-side events only (kernels and copies); the aten rows would
    # count the same device time a second time
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile of the main path [{card}]: device busy {busy_ms:.1f} ms of the "
          f"{wall_ms:.1f} ms unprofiled wall = {100 * busy_ms / wall_ms:.1f}% "
          f"(idle {100 - 100 * busy_ms / wall_ms:.1f}%), {sum(r[1] for r in rows)} device ops")
    for us, n, key in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  x{n:<6d} {key[:90]}")
    table_path = pathlib.Path(table_path)
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(prof.key_averages().table(sort_by="self_device_time_total",
                                                    row_limit=60))


def serve(torch, Pipeline, ops, card, profile=None):
    clips = requests(np.random.default_rng(4))
    audio_s = sum(c.size for c in clips) / 16000.0
    pipe = Pipeline("base.en", device="cuda", seed=0)  # bf16 fast path: every kernel
    cfg = pipe.cfg
    require(cfg.flash_attention and cfg.fused_quant_cross
            and cfg.quantize_cross_kv and cfg.dtype == "bfloat16", "fast path is not on")
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                  max_tokens=MAX_TOKENS)
    pipe.transcribe(clips, **kwargs)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    tm = pipe.last_timings
    print(f"main path (base.en bf16, {BATCH} requests, {audio_s:.1f} s of audio) on {card}:")
    print(f"  tokens per request: {[len(r.tokens) for r in res]}")
    print(f"  mel {tm['mel_ms']:.3f} ms, encoder {tm['encode_ms']:.3f} ms, "
          f"prefill {tm['prefill_ms']:.3f} ms, decode {tm['decode_ms'] / max(tm['steps'], 1):.3f} "
          f"ms/step over {tm['steps']} steps, wall {wall * 1e3:.1f} ms, "
          f"{audio_s / wall:.1f} audio-s/s  [{card}]")
    print(f"  launches on the main path: {counts}")
    for r in res:
        require(all(0 <= t < cfg.n_vocab for t in r.tokens) and len(r.tokens) <= MAX_TOKENS,
                "main path produced out-of-range tokens")
    for name in ("mel", "flash_attention", "quant_cross_attention"):
        require(counts.get(name, 0) > 0, f"main path never launched the {name} kernel")
    if profile:
        profile_run(torch, pipe, clips, kwargs, card, wall * 1e3, profile)
    return counts


def f32_agreement(torch, Pipeline, ops):
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes

    clips = requests(np.random.default_rng(4))
    plain_cfg = dict(flash_attention=False, fused_quant_cross=False)
    runs = []
    for overrides in ({}, plain_cfg):
        kernels = not overrides
        pipe = Pipeline("base.en", device="cuda", seed=0, dtype="float32",
                        config_overrides=overrides)
        tok = pipe.tokenizer
        ctx = tok.encode(CONTEXT.lower(), add_special_tokens=False)
        ids, mask = pack_prefixes([[tok.sop] + ctx + [tok.sot]] * BATCH, tok.eot, 32)
        spans = pipe._spans(BIAS_WORDS, BATCH)
        audio = np.stack([pad_or_trim(c, pipe.window_samples) for c in clips])
        ops.reset_launch_counts()
        if kernels:
            mel = pipe.mel(audio)
        else:  # the plain frontend, named outright
            mel = log_mel_spectrogram(torch.from_numpy(audio).cuda(), n_mels=pipe.cfg.n_mels)
        res = greedy_decode(pipe.model, mel, ids, mask, max_new=MAX_TOKENS, eot_id=tok.eot,
                            bias_spans=spans, bias_boost=2.0, span_pad_id=tok.eot,
                            device="cuda", return_margins=True)
        counts = dict(ops.launches)
        if kernels:
            for name in ("mel", "flash_attention", "quant_cross_attention"):
                require(counts.get(name, 0) > 0, f"f32 kernel run never launched {name}")
        else:
            require(not counts, f"f32 plain run launched kernels: {counts}")
        print(f"  f32 {'kernel' if kernels else 'plain'} run launches: {counts}")
        runs.append((res.tokens.cpu().numpy(), res.margins.cpu().numpy()))
        del pipe
    (kt, _), (pt, pm) = runs
    for i in range(BATCH):
        diff = np.nonzero(kt[i] != pt[i])[0]
        if diff.size:
            s = int(diff[0])
            print(f"  f32 row {i}: tokens diverge at step {s}, plain top-2 logit gap "
                  f"{pm[i, s]:.3e} (pass only if < 1e-4)")
            require(pm[i, s] < 1e-4, f"f32 kernels vs plain diverge at row {i} step {s}")
    print(f"f32 main path, kernels vs plain versions: tokens identical up to near-ties "
          f"({int((kt == pt).all(axis=1).sum())}/{BATCH} rows identical)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="TABLE_PATH",
                    help="also profile one main-path run: device time by kernel, "
                         "the full profiler table written to TABLE_PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from whisper_context_biasing_tpu_torch import Pipeline, ops
    from whisper_context_biasing_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    # true f32 everywhere: the mel frontend and the f32 comparison need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    out = _build.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s into {out}")
    for log in sorted(out.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")

    kernels = [check_mel(torch, ops), check_flash(torch, ops), check_quant_cross(torch, ops)]
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}, library {k['library_ms']}) [{card}]")
    counts = serve(torch, Pipeline, ops, card, args.profile)
    f32_agreement(torch, Pipeline, ops)
    for k in kernels:
        k["launches"] = counts.get(k["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
