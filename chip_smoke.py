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
   plain torch version at base.en shapes with batch 8 (serving, and the
   training step's flash uses: encoder full, decoder causal and decoder
   cross), printing the max error, the median device time over
   CUDA-event-timed bursts of calls, the plain version's time, the least
   time the card could take (its bound) and, where one PyTorch call
   computes the same function, that call's time;
3. the serving path: ``Pipeline("base.en", device="cuda")`` with seeded
   random weights on the fast path (bf16, every kernel) serves 8
   short-form requests with a context and bias words; the launch counts of
   that run show it went through every serving kernel; then ``mel_ms``
   taken apart, inside ``transcribe`` (host pad and stack, the
   ``Pipeline.mel`` call, GC pauses) and piece by piece (host pad and
   stack, the copy to the card, K1, the log tail);
4. the same requests in f32, once with the kernels and once with their
   plain versions (chosen by config and by calling the plain mel frontend,
   not by fallback; the launch counts show which ran): the tokens must be
   identical, or diverge only at a near-tie (top-2 logit gap < 1e-4);
5. the training path: ``make_train_step`` on base.en (bf16, flash
   attention, full remat, log-mel from raw audio inside the step), batch 8
   x grad_accum 2 with prompted labels of 448 tokens and bias spans from
   the port's collator, 3 optimizer steps: finite loss and grad norm, and
   exactly the kernel launches the configuration implies;
6. the same step in f32, once with the kernels and once with the plain
   versions (by config, and the plain mel frontend named outright): the
   loss and the gradients must agree within the limits printed;
7. the fused training path: phase 5's step and batch with both fused
   LayerNorm+matmul switches on (the ``--fused_ln`` config), 3 steps, with
   exactly the launches the configuration implies (120 fused launches per
   optimizer step);
8. that fused step in f32 with every kernel against the all-plain config
   (unfused, no flash, the plain mel frontend): loss and gradients agree;
9. the fine-tuning entry point: ``train_and_evaluate`` on base.en with the
   ``--fused_ln`` config over a synthetic WAV corpus written to a
   temporary directory (``PromptWhisperDataset``, prompts and bias lists),
   2 optimizer steps, a WER evaluation whose encoder runs the fused kernel,
   ``refs_and_pred.txt`` and ``checkpoint-2`` read back;
10. the reference's entry points at base.en width: phase 3's seeded weights
   written as ``model.safetensors`` by the port's own writer and read back
   bit-identical, ``Pipeline(checkpoint=...)`` giving phase 3's tokens and
   launches; ``cli.train --flash_attention --fused_ln`` from that file on a
   WAV corpus (2 steps, an eval, a save, the test eval) with its result
   files, ``checkpoint-2`` and exactly the launches its configuration
   implies; ``cli.export_hf`` of the checkpoint, then ``cli.evaluation
   --final_model`` on the export and ``--best_checkpoint`` on the run giving
   the same ``refs_and_pred.txt``; whether libmpg123 is here (and, with
   libmp3lame, one ``.mp3`` decoded); each CLI's wall time;
11. long-form and beam serving at base.en width: (a) ``Pipeline.transcribe``
   of a 75 s and a 48 s clip with timestamps, the default temperature ladder
   with best_of 2, window info and the VAD gate (bf16, every kernel): each
   window's rung, avg logprob, no-speech probability and compression ratio,
   the wall and the device's busy time (a profiled repeat), exactly the
   launches the run implies (K1 one a window iteration, K2 six a decode
   call, K3 six a decode step) and ``srt()`` that parses back; (b) the same
   clips at temperature 0 in f32, the kernels against their plain versions:
   tokens, segments and seeks identical (a divergence passes only at a
   top-2 logit gap < 1e-4); (c) 5 beams on phase 3's requests in bf16 (ms a
   step, the cache reorder's share, K3 six a step), then f32 kernels against
   plain versions with identical beams; (d) seeded sampling with a CUDA
   generator repeating; (e) ``Pipeline("base")`` detecting a language per
   request; (f) ``cli.transcribe --long --timestamps --format srt`` from
   phase 10's ``model.safetensors``, one SRT per file that parses back;
12. the rest of serving at base.en width: (a) ``Pipeline.transcribe(
   long_form="chunked", chunked_batch=32)`` of a 300 s recording and phase
   11's clips with timestamps and the default ladder (bf16, every kernel):
   windows, window batches, decode calls and steps, the wall, and exactly
   the launches the run implies (K1 one a window batch, K2 six an encoder
   pass, K3 six a decode step); (b) the same route at t=0 in f32 with word
   timestamps, the kernels against their plain versions: tokens, segments
   and words identical (a divergence passes only at a top-2 logit gap
   < 1e-4); (c) short-form word timestamps on phase 3's requests (the
   alignment pass's ms; words monotone inside each clip) and long-form word
   timestamps on the 75 s clip; (d) ``window_buckets=(8, 15)`` on phase 3's
   requests: launches and encoder ms per bucket beside the unbucketed call,
   then f32 kernels against plain versions with identical tokens; (e) a
   ``StreamingTranscriber`` fed the 75 s clip in 1 s chunks giving
   ``transcribe_long_batch``'s tokens; (f) ``cli.serve`` on 127.0.0.1:0 from
   phase 10's ``model.safetensors``: 8 concurrent posts in one micro-batch,
   a 75 s post, a word-timestamp post, a stream session, ``/health``, each
   latency and the server's RTF meter;
13. speculative and Medusa decoding at base.en width on phase 3's requests
   (bf16, every kernel): (a) a random tiny.en draft, k = 4: rounds, tokens a
   round, ms a round beside plain greedy's ms a step, exactly K1 1, K2 10,
   K3 4 x 5 x rounds; (b) the target as its own draft: K2 12, K3 6 x 5 x
   rounds; (c) 4 untrained Medusa heads at 1 and 3 chains: K1 1, K2 6, K3
   0; bf16 tokens equal plain greedy's or diverge at a top-2 gap under one
   bf16 ulp (2^-7), and in f32 with the kernels (b) and (c) are held to
   plain greedy's tokens by phase 4's rule; (d) ``cli.medusa`` from phase
   10's ``model.safetensors`` on phase 10's corpus (exactly K2 6 a frozen
   encoder pass), then ``cli.transcribe --medusa`` and ``--draft_model``
   and ``cli.serve --medusa`` against the plain CLI and server (the bf16
   rule); (e) phase 11's clips at t=0 in f32, sequential and chunked, with
   a self-draft and with heads: tokens and segments equal the plain run's;
   (f) ``quantize_decoder_weights`` on phase 3's model: decode ms a step
   beside the bf16 model's, the largest prefill logit difference, K1 1, K2
   6, K3 6 a step;
14. training extensions and the last entry points: (a) ``train_and_evaluate``
   with ``lora_rank=8`` and SpecAugment at base.en over phase 10's corpus,
   unfused and with the ``--fused_ln`` config (2 steps of batch 8 x accum 2,
   an eval, a save): exactly the launches the steps and the eval imply, the
   returned model the base with checkpoint-2's adapters merged and bit-equal
   to the base elsewhere; then the LoRA step in f32 with every kernel
   against the all-plain configuration (phase 6's rule, on the adapters'
   gradients); (b) ``make_distill_step`` with a base.en teacher and a
   tiny.en student on phase 5's batch (raw audio, labels of 449 tokens),
   bf16, 3 steps: step ms and exactly the launches the step implies (the
   teacher's forward once, the student's twice under full remat); the step
   in f32 against the all-plain configuration; ``cli.distill`` from phase
   10's ``model.safetensors`` over its corpus; (c) one raw-audio distillation
   step of a large-v3 teacher (128 mels, full width, drawn on the card) and
   a tiny student with its vocab (80 mels): K1 exactly twice, the 128-mel
   features within 1e-4 of the plain version's; (d) ``cli.acceptance`` on
   the five BASELINE configs offline (config 1 on the CPU, 2-5 on the card
   at the full width of base.en, small.en, medium.en and large-v3): ``ok``,
   the asserts JAX's offline run skips skipped, each config's wall and
   exactly its launches; (e) ``cli.check_weightce``,
   ``cli.check_data_collator`` and ``cli.check_data_loader`` once each.
15. data and tensor parallelism: (a) a world of one over NCCL against the
   unsharded step and phase 3's requests, ``torchrun --nproc_per_node 1
   cli.train``; (b) two ranks this script spawns, sharing the card over
   gloo at mesh (1, 2) and (2, 1): f32 tokens, beams, loss and gradients
   against the unsharded run, bf16 launches exact; (c) the four remat
   policies; (d) on the same two ranks, in f32 at both meshes, every
   serving route against the unsharded run with exact launches (a random
   tiny.en draft, a self-draft, 2 Medusa heads at 1 and 3 chains, phase
   11's clips with words, phase 12's chunked batch in both window modes);
   (e) at (2, 1) a 0.2 rung on CUDA generators: the unsharded tokens, each
   rank's uniforms the unsharded run's at its rows; (f) ``cli.serve
   --dtype float32`` under ``torchrun``, one rank over NCCL and two over
   gloo at ``--model_parallelism`` 2 and 1, started while (b)-(e) run:
   phase 12 (f)'s posts and a stream session give the one-device server's
   replies, and every rank exits 0 after SIGTERM to its rank 0; (g) on the
   same two ranks, in f32 at both meshes: two distillation steps of phase
   14 (b)'s pair and phase 14 (a)'s LoRA loop, unfused and ``--fused_ln``,
   against the unsharded runs (loss rel 1e-5, agreement equal, the first
   step's gradients phase 6's rule, launches exactly the rank's loop's:
   at (1, 2) phase 14's), and a sharded (DCP) checkpoint saved at (1, 2)
   from the card's tensors, read back in this process bit-equal to the
   gathered weights, one copy on disk, and resumed at (2, 1) for the next
   step's loss; (a) also saves and reads one over NCCL.

Phase 2 also holds the mel kernel against its plain version at 80 and 128
mels, a 3 s window and batch 1, and against the float64 numpy frontend on a
loud and a quiet clip, and times it beside the cuFFT sequence (``torch.stft``,
``|X|^2``, the filterbank product); the fused
LayerNorm+matmul kernel (forward and gradients) against its plain version at
every site of the encoder and the decoder, the int8 cross-attention in f32
and bf16 at every layer (and bit-identical over 4 runs) and through its
one-layer wrapper, and prints what the compiler and the runtime report of
each mel, flash, int8 cross-attention and fused kernel (registers, spills,
shared memory, resident blocks per SM) and the rate each reaches beside its
bound. The int8 cross-attention is timed as a decode step runs
it, in bursts that rotate over the 6 layers (75 MB of K/V, more than the
50 MB L2 holds), so its time is fed from device memory. It also holds K1,
K2 and K3 at the shapes phase 12 gives them: K1 on 8 s and 15 s windows,
K2 at T = 400 and 750 (the buckets' encoder), K3 at T_pad = 512 and 768 for
batches of 8 and 32 and at T_pad = 1536 for the chunked batch of 32, and K2
and K3 at the tiny.en draft's width (d 384, 6 heads; 4 decoder layers), K2
and K3 at the widths of small.en, medium.en and large-v3 (12, 16 and 20
heads; 12, 24 and 32 decoder layers) and K4 at small.en's encoder shape,
K2-K5 at a rank's share of base.en on a model axis of 2 and K2 and K3 at
the draft's (3 heads, d 192), each with its bound and, for K2 and K4,
SDPA's time beside it. The line before the last is the kernel table as
JSON, with each kernel's launches
summed over the main-path phases (3, 5, 7, 9, 10, 11, 12, 13, 14 and 15);
the last line is
``{"ok": true, "device": {...}}``.

``--kernels-only [TREE]`` stops after phase 2 (all five kernels checked and
timed) and prints no result line; with TREE, a checkout of another commit,
it runs that checkout's package, so two versions of a kernel can be timed in
turns on one card. ``--flash-only [TREE]`` does the same for the flash
kernels (K2, K4) alone.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import re
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

# NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit); the bf16
# peak is the port's (utils/flops.py H100_BF16_FLOPS, set in main once the
# package is importable)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12     # CUDA cores, no tensor cores
PEAK_BF16_FLOP_S = None     # tensor cores

REPS = 20  # CUDA-event-timed bursts per kernel
BURST = 5  # calls per burst

# base.en training shapes: label length n_text_ctx (the longest prompted
# label sequence), so the decoder takes the flash path
T_TEXT = 448
ACCUM = 2
TRAIN_STEPS = 3

CONTEXT = "patient history: hypertension treated with lisinopril and metformin"
BIAS_WORDS = ["lisinopril", "metformin", "atorvastatin"]
MAX_TOKENS = 64


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_blocker = []  # one (8192, 8192) bf16 operand, made at first use


def median_ms(torch, fn) -> float:
    """Device time of one ``fn()``: the median over REPS bursts, each BURST
    calls between two CUDA events that queue up behind ~3.5 ms of matmul, so
    the device runs the burst back to back and the host's launch overhead
    (tens of microseconds a call, more than the smallest kernels take) is
    not in the reading."""
    if not _blocker:
        _blocker.append(torch.randn(8192, 8192, device="cuda").to(torch.bfloat16))
    block = _blocker[0]
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(2):
            block @ block
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
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

def kernel_name(mangled: str) -> str:
    """The kernel's own name out of its mangled one (``_ZN<len><scope>
    <len><name>E...`` or ``_Z<len><name>...``): the last length-prefixed
    identifier of the leading run."""
    m = re.match(r"_ZN?", mangled)
    pos, name = (m.end() if m else 0), mangled
    while m := re.match(r"\d+", mangled[pos:]):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    return name


def print_build_logs(out) -> None:
    """What ptxas said of each kernel (``-Xptxas -v`` in the build logs):
    registers, static shared memory, stack and spill bytes."""
    for log in sorted(out.glob("*.log")):
        entry = "?"
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = kernel_name(m.group(1))
            elif "spill" in line or "registers" in line:
                print(f"  {log.stem} {entry}: {line.replace('ptxas info    :', '').strip()}")


def print_kernel_info(card, kernels=("mel_kernel", "flash_attention", "quant_cross_attention",
                                      "fused_block")) -> None:
    """Registers, shared memory a block (static + dynamic) and resident
    blocks per SM of the mel, flash, int8 cross-attention and fused
    LayerNorm+matmul kernels at the main path's shapes, as the CUDA runtime
    reports them."""
    import importlib

    for name in kernels:
        # by its full name: ops.flash_attention is the function of that name
        mod = importlib.import_module(f"whisper_context_biasing_tpu_torch.ops.{name}")
        if not hasattr(mod, "kernel_info"):
            print(f"  (this checkout's ops.{name} has no kernel_info)")
            continue
        if name == "quant_cross_attention":  # a block's share of the serving shape's keys
            rows = mod.kernel_info(T_PAD // mod.pick_splits(T_PAD, BATCH * N_HEADS))
        else:
            rows = mod.kernel_info(D_MODEL) if name == "fused_block" else mod.kernel_info()
        for r in rows:
            print(f"  {r['kernel']} {r['dtype']}: {r['registers']} registers x {r['threads']} "
                  f"threads, {r['smem_bytes']} B shared memory a block, {r['local_bytes']} B "
                  f"local memory a thread, {r['blocks_per_sm']} blocks ("
                  f"{r['blocks_per_sm'] * r['threads'] // 32} warps) an SM  [{card}]")


def mel_clip(rng, kind: str) -> np.ndarray:
    """A 30 s clip for the float64 reference check: "loud" tones over noise
    (the f32 rounding stress case) or "quiet", the speech-like signal at
    1/1000 of its level."""
    t = np.arange(N_SAMPLES) / 16000.0
    if kind == "loud":
        return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
                + 0.05 * rng.standard_normal(N_SAMPLES)).astype(np.float32)
    return 1e-3 * synthetic_audio(rng, N_SAMPLES / 16000.0)


def check_mel(torch, ops):
    """K1 against its plain version at the serving shape and at 128 mels, a
    short window and batch 1; against the float64 numpy reference on a loud
    and a quiet clip; timed at the serving shape beside the plain version,
    the bound and the cuFFT sequence that computes the same function."""
    from whisper_context_biasing_tpu_torch.audio.mel import (
        hann_window_periodic,
        log_mel_spectrogram_np,
        log_mel_tail,
        mel_filter_bank,
    )

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
    # two f32 algorithms apart: the plain version's dense DFT sums 200
    # products twice, the kernel's FFT rounds through ~log2(400) levels
    err = 0.0
    for label, xs, n_mels in (("8 x 480000, 80 mels", x, N_MELS),
                              ("8 x 480000, 128 mels", x, 128),
                              ("8 x 48000 (3 s window), 80 mels", x[:, :48000].contiguous(), N_MELS),
                              ("1 x 480000, 80 mels", x[3:4], N_MELS)):
        kern = ops.mel_energies(xs, n_mels)
        plain = ops.mel_energies_plain(xs, n_mels)
        e = max_err(log_mel_tail(kern), log_mel_tail(plain))
        print(f"K1 mel {label}: log-mel max |kernel - plain| = {e:.3e} (atol 1e-4, f32, TF32 off)")
        require(e <= 1e-4, f"mel kernel disagrees with its plain version at {label}: {e}")
        if n_mels == N_MELS and xs is x:
            err = e
    for kind in ("loud", "quiet"):
        clip = mel_clip(rng, kind)
        got = log_mel_tail(ops.mel_energies(torch.from_numpy(clip[None]).cuda(), N_MELS))[0]
        e = float(np.abs(got.cpu().numpy() - log_mel_spectrogram_np(clip, N_MELS)).max())
        print(f"K1 mel {kind} clip: log-mel max |kernel - float64 numpy reference| = {e:.3e} "
              f"(atol 1e-4)")
        require(e <= 1e-4, f"mel kernel disagrees with the float64 reference on a {kind} clip: {e}")
    # the least work of the function: a 400-point real FFT per frame (~2.5 N
    # log2 N operations), the power of 201 bins, a multiply-add per nonzero
    # of the filterbank; the audio read once and the energies written once
    frames = BATCH * (N_SAMPLES // 160)
    fb_np = mel_filter_bank(n_mels=N_MELS)
    n_ops = frames * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * np.count_nonzero(fb_np))
    n_bytes = 4 * (audio.size + frames * N_MELS)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_F32_FLOP_S)
    # the yardstick: cuFFT's real FFT through torch.stft, |X|^2, the dense
    # filterbank product (f32, TF32 off): a sequence of library calls, not one
    window = torch.from_numpy(hann_window_periodic()).cuda()
    fb = torch.from_numpy(fb_np.T.copy()).cuda()

    def stft_sequence():
        spec = torch.stft(x, n_fft=400, hop_length=160, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return (spec.abs() ** 2).transpose(1, 2) @ fb

    lib_err = max_err(log_mel_tail(stft_sequence()), log_mel_tail(ops.mel_energies_plain(x, N_MELS)))
    ms = median_ms(torch, lambda: ops.mel_energies(x, N_MELS))
    plain_ms = median_ms(torch, lambda: ops.mel_energies_plain(x, N_MELS))
    lib_ms = median_ms(torch, stft_sequence)
    print(f"  mel kernel 8 x 480000, 80 mels: {ms:.4f} ms = {n_bytes / ms / 1e6:.0f} GB/s of the "
          f"{n_bytes / 1e6:.2f} MB it must move (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}; the cuFFT sequence torch.stft -> |X|^2 -> @ filterbank {lib_ms:.4f} ms, "
          f"log-mel {lib_err:.1e} from the plain version)")
    return dict(
        name="mel", route="cuda", source="whisper_context_biasing_tpu_torch/ops/csrc/mel.cu",
        replaces="whisper_context_biasing_tpu/ops/mel_kernel.py:61",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library="the cuFFT sequence torch.stft -> abs()**2 -> @ filterbank")


# the three flash uses of the training step: (Tq, Tk, causal)
FLASH_SHAPES = {"encoder full": (T_AUDIO, T_AUDIO, False),
                "decoder causal": (T_TEXT, T_TEXT, True),
                "decoder cross": (T_TEXT, T_AUDIO, False)}


def merged_heads(torch, rng, t):
    """(BATCH, t, 512) merged-head activations, read as (BATCH, t, 8, 64) views."""
    dh = D_MODEL // N_HEADS
    x = torch.from_numpy(rng.standard_normal((BATCH, t, D_MODEL), np.float32)).cuda()
    return x.view(BATCH, t, N_HEADS, dh)


def check_flash(torch, ops):
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    dh = D_MODEL // N_HEADS
    bh = BATCH * N_HEADS
    entry = None
    for label, (tq, tk, causal) in FLASH_SHAPES.items():
        qkv32 = [merged_heads(torch, rng, t) for t in (tq, tk, tk)]
        o, lse = ops.flash_attention_fwd(*qkv32, causal=causal)
        po, plse = ops.flash_attention_fwd_plain(*qkv32, causal=causal)
        err32, lerr32 = max_err(o, po), max_err(lse, plse)
        print(f"K2 flash f32 {label} ({BATCH}, {tq}x{tk}, 8x64): max |o err| = {err32:.3e} "
              f"(atol 2e-5), max |lse err| = {lerr32:.3e} (atol 1e-4)")
        require(err32 <= 2e-5 and lerr32 <= 1e-4, f"flash f32 {label} disagrees: {err32}, "
                f"{lerr32}")
        qkv = [t.to(torch.bfloat16) for t in qkv32]
        o, lse = ops.flash_attention_fwd(*qkv, causal=causal)
        po, plse = ops.flash_attention_fwd_plain(*qkv, causal=causal)
        err, lerr = max_err(o, po), max_err(lse, plse)
        if causal:
            # early rows attend to a handful of keys, so |o| reaches |v| ~ 3 and
            # one bf16 rounding of o is up to 2^-7 |o|: the limit is 1% of max |o|
            limit = 1e-2 * po.float().abs().max().item()
            why = "1% of max |o|"
        else:
            # a typical |o| is ~0.04 here (diffuse softmax over 1500 keys), so
            # the limit is a few bf16 ulps of the output's scale
            limit, why = 5e-3, "a few bf16 ulps of |o| ~ 0.04"
        print(f"K2 flash bf16 {label}: max |o err| = {err:.3e} (atol {limit:.2e}, {why}), "
              f"max |lse err| = {lerr:.3e} (atol 1e-4)")
        require(err <= limit and lerr <= 1e-4, f"flash bf16 {label} disagrees: {err}, {lerr}")
        heads = [t.transpose(1, 2) for t in qkv]  # (B, H, T, dh) for SDPA
        frac = 0.5 if causal else 1.0
        n_ops = 4 * bh * tq * tk * dh * frac
        n_bytes = 2 * bh * dh * (2 * tq + 2 * tk) + 4 * bh * tq
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOP_S)
        ms = median_ms(torch, lambda: ops.flash_attention_fwd(*qkv, causal=causal))
        plain_ms = median_ms(torch, lambda: ops.flash_attention_fwd_plain(*qkv, causal=causal))
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(*heads,
                                                                         is_causal=causal))
        print(f"  flash_attention {label}: {ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s of "
              f"{n_ops / 1e9:.2f} GFLOP (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
              f"SDPA {lib_ms:.4f} ms)")
        if entry is None:  # the JSON line carries the encoder shape, as before
            entry = dict(
                name="flash_attention", route="cuda",
                source="whisper_context_biasing_tpu_torch/ops/csrc/flash_attention.cu",
                replaces="whisper_context_biasing_tpu/ops/flash_attention.py:66",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    return entry


def check_flash_bwd(torch, ops):
    """K4 at the training step's three flash shapes, f32 (TF32 off) and
    bf16, on the forward's own output and logsumexp."""
    import torch.nn.functional as F

    rng = np.random.default_rng(5)
    dh = D_MODEL // N_HEADS
    bh = BATCH * N_HEADS
    entry = None
    for label, (tq, tk, causal) in FLASH_SHAPES.items():
        f32 = [merged_heads(torch, rng, t) for t in (tq, tk, tk, tq)]  # q, k, v, do
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in f32)
            o, lse = ops.flash_attention_fwd_plain(q, k, v, causal=causal)
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
            # f32: sums of up to 1500 terms in other orders, ~1e-6 of the
            # largest gradient; bf16: P and dS round to bf16 before the products
            # on both routes and a value at a rounding boundary may go either
            # way, then the output rounds once more: ~2 bf16 ulps of the largest
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                scale = w.float().abs().max().item()
                err = max_err(g, w)
                errs.append(err)
                print(f"K4 flash bwd {str(dtype)[6:]} {label} ({BATCH}, {tq}x{tk}, 8x64) "
                      f"{name}: max |err| = {err:.3e} (atol {rel:g} x max |{name}| = "
                      f"{rel * scale:.3e})")
                require(err <= rel * scale, f"flash backward {dtype} {label} {name} "
                        f"disagrees: {err} > {rel * scale}")
        frac = 0.5 if causal else 1.0
        n_ops = 10 * bh * tq * tk * dh * frac
        n_bytes = 2 * bh * dh * (4 * tq + 4 * tk) + 4 * bh * tq  # q o do dq, k v dk dv, lse
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOP_S)
        ms = median_ms(torch, lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                              causal=causal))
        plain_ms = median_ms(torch, lambda: ops.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                                          causal=causal))
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        doh = do.transpose(1, 2)
        lib_ms = median_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                              retain_graph=True))
        print(f"  flash_attention_bwd {label}: {ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s of "
              f"the 5 products' {n_ops / 1e9:.2f} GFLOP (the two kernels do 7: "
              f"{1.4 * n_ops / ms / 1e9:.1f} TFLOP/s executed; plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, SDPA backward {lib_ms:.4f} ms)")
        if entry is None:
            entry = dict(
                name="flash_attention_bwd", route="cuda",
                source="whisper_context_biasing_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                replaces="whisper_context_biasing_tpu/ops/flash_attention.py:84",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
    return entry


def check_quant_cross(torch, ops):
    rng = np.random.default_rng(3)
    shape = (N_LAYERS, BATCH, T_PAD, D_MODEL)
    k_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    v_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    scales = rng.uniform(0.005, 0.05, (2, N_LAYERS, BATCH, 1, T_PAD)).astype(np.float32)
    scales[..., T_AUDIO:] = 0.0  # zero scale marks the padding
    k_s, v_s = (torch.from_numpy(s).cuda() for s in scales)
    q32 = torch.from_numpy(rng.standard_normal((BATCH, 1, D_MODEL), np.float32)).cuda()

    def kernel(q, layer):
        return ops.quant_cross_attention_step_indexed(q, k_q, k_s, v_q, v_s, layer, N_HEADS)

    def plain(q, layer):
        return ops.quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s, layer,
                                                            N_HEADS)

    # f32: sums over 1,500 keys in another order; bf16: the weights round to
    # bf16 before the product on both routes, the output once more
    for dtype, limit in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        q = q32.to(dtype)
        err = max(max_err(kernel(q, layer), plain(q, layer)) for layer in range(N_LAYERS))
        print(f"K3 int8 cross-attention {str(dtype)[6:]} (6, 8, 1536, 512), every layer: "
              f"max |err| = {err:.3e} (atol {limit:g})")
        require(err <= limit, f"int8 cross-attention {dtype} disagrees: {err}")
        runs = [kernel(q, N_LAYERS - 1) for _ in range(4)]
        require(all(torch.equal(runs[0], r) for r in runs[1:]),
                f"int8 cross-attention {dtype}: 4 runs on the same inputs differ")
    print("K3 int8 cross-attention: 4 runs on the same inputs are bit-identical (f32, bf16)")
    # K3': the one-layer wrapper, off every path, on layer 0's (B, T_pad, D) K/V
    # (a checkout from before it had one has none)
    if hasattr(ops, "quant_cross_attention_step"):
        one = [t[0] for t in (k_q, k_s, v_q, v_s)]
        err1 = max_err(ops.quant_cross_attention_step(q, *one, N_HEADS),
                       ops.quant_cross_attention_plain(q, *one, N_HEADS))
        print(f"K3' quant_cross_attention_step bf16 (8, 1536, 512), one layer: max |err| = "
              f"{err1:.3e} (atol 1e-2); off every path, as in JAX")
        require(err1 <= 1e-2, f"quant_cross_attention_step disagrees: {err1}")
    # K/V rows of the real positions, every scale, q and the output
    n_bytes = 2 * BATCH * T_AUDIO * D_MODEL + 2 * 4 * BATCH * T_PAD + 2 * 2 * BATCH * D_MODEL
    n_ops = 4 * BATCH * T_AUDIO * D_MODEL
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOP_S)
    # as a decode step walks it: layer after layer, 75 MB of K/V in all, which
    # the 50 MB L2 cannot hold, so every launch is fed from device memory
    layers = itertools.cycle(range(N_LAYERS))
    ms = median_ms(torch, lambda: kernel(q, next(layers)))
    one_layer_ms = median_ms(torch, lambda: kernel(q, 3))
    print(f"  quant_cross_attention bf16, bursts rotating over the {N_LAYERS} layers (fed from "
          f"device memory): {ms:.4f} ms = {n_bytes / ms / 1e6:.0f} GB/s of the "
          f"{n_bytes / 1e6:.2f} MB it must move (bound {b_ms:.4f} ms by {b_by} at "
          f"{PEAK_BYTES_S / 1e9:.0f} GB/s); on layer 3 alone (12.6 MB, L2-resident after the "
          f"first call): {one_layer_ms:.4f} ms")
    return dict(
        name="quant_cross_attention", route="cuda",
        source="whisper_context_biasing_tpu_torch/ops/csrc/quant_cross_attention.cu",
        replaces="whisper_context_biasing_tpu/ops/quant_cross_attention.py:48",
        max_abs_err=err, ms=ms, plain_ms=median_ms(torch, lambda: plain(q, 3)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        also="K3' (whisper_context_biasing_tpu/ops/quant_cross_attention.py:102) is this kernel "
             "on a one-layer view, ops.quant_cross_attention_step; off every path, as in JAX")


# the fused LayerNorm+matmul sites at base.en batch 8: (N, E, act), and the
# launches of each in one fused training step (6 layers x 2 microbatches x 2
# forwards under full remat; the training config's gelu is the erf one)
FUSED_SHAPES = {"encoder QKV": (BATCH * T_AUDIO, 3 * D_MODEL, None),
                "encoder MLP gelu": (BATCH * T_AUDIO, 4 * D_MODEL, "gelu"),
                "encoder MLP gelu_tanh": (BATCH * T_AUDIO, 4 * D_MODEL, "gelu_tanh"),
                "decoder QKV": (BATCH * T_TEXT, 3 * D_MODEL, None),
                "decoder cross q": (BATCH * T_TEXT, D_MODEL, None),
                "decoder MLP gelu": (BATCH * T_TEXT, 4 * D_MODEL, "gelu")}
FUSED_LAUNCHES_PER_STEP = {"encoder QKV": 24, "encoder MLP gelu": 24, "encoder MLP gelu_tanh": 0,
                           "decoder QKV": 24, "decoder cross q": 24, "decoder MLP gelu": 24}


def fused_inputs(torch, rng, n, e, dtype):
    """x (n, 512) in ``dtype``; LayerNorm g, beta and bias b in f32, as the
    model passes them; W (512, e) as the transposed view of an (e, 512)
    nn.Linear weight in ``dtype``, as the model passes it."""
    def t(shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).cuda()
    return (t((n, D_MODEL), 2.0, 0.5).to(dtype), t((D_MODEL,), 0.1, 1.0),
            t((D_MODEL,), 0.1), t((e, D_MODEL), D_MODEL ** -0.5).to(dtype).t(), t((e,), 0.5))


def check_fused_ln(torch, ops):
    """K5 against its plain version at the model's fused sites, bf16
    and f32, its gradients through the autograd function against autograd
    of the plain version, and its time beside the bound, the plain
    version's and the unfused torch sequence it replaces."""
    import torch.nn.functional as F

    rng = np.random.default_rng(6)
    entry = None
    for label, (n, e, act) in FUSED_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, g, beta, w, b = fused_inputs(torch, rng, n, e, dtype)
            got = ops.fused_ln_matmul(x, g, beta, w, b, act=act)
            want = ops.fused_ln_matmul_plain(x, g, beta, w, b, act=act)
            err = max_err(got, want)
            if dtype == torch.float32:
                # sums over d = 512 in another order: ~1e-6 of |out| ~ 3
                limit, why = 2e-5, "f32, TF32 off"
            else:
                # y rounds to bf16 before the product on both routes (a value
                # at a rounding boundary may go either way), the output once more
                limit = 1e-2 * want.float().abs().max().item()
                why = "1% of max |out|"
            print(f"K5 fused LN+matmul {str(dtype)[6:]} {label} ({n} x {D_MODEL} -> {e}): "
                  f"max |err| = {err:.3e} (atol {limit:.2e}, {why})")
            require(err <= limit, f"fused LN+matmul {dtype} {label} disagrees: {err}")
        # times in bf16, the training and fast-path dtype
        itemsize = 2
        n_bytes = (n * D_MODEL + D_MODEL * e + n * e) * itemsize
        b_ms, b_by = bound(n_bytes, 2 * n * D_MODEL * e, PEAK_BF16_FLOP_S)
        ms = median_ms(torch, lambda: ops.fused_ln_matmul(x, g, beta, w, b, act=act))
        plain_ms = median_ms(torch, lambda: ops.fused_ln_matmul_plain(x, g, beta, w, b, act=act))
        gc, bc, wc, bbc = g.to(dtype), beta.to(dtype), w.t(), b.to(dtype)

        def unfused():
            y = F.linear(F.layer_norm(x, (D_MODEL,), gc, bc, 1e-5), wc, bbc)
            return y if act is None else F.gelu(y, approximate="tanh" if act == "gelu_tanh"
                                                else "none")
        unfused_ms = median_ms(torch, unfused)
        n_ops = 2 * n * D_MODEL * e
        print(f"  fused_ln_matmul {label}, {FUSED_LAUNCHES_PER_STEP[label]} launches a fused "
              f"step: {ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s (plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}; the unfused torch sequence layer_norm -> linear"
              f"{'' if act is None else ' -> gelu'} in bf16: {unfused_ms:.4f} ms, not a "
              f"library call for the same function)")
        if entry is None:  # the JSON line carries the encoder QKV shape
            entry = dict(
                name="fused_ln_matmul", route="cuda",
                source="whisper_context_biasing_tpu_torch/ops/csrc/fused_ln_matmul.cu",
                replaces="whisper_context_biasing_tpu/ops/fused_block.py:74",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    # gradients of all five inputs at the encoder MLP site
    n, e, act = FUSED_SHAPES["encoder MLP gelu"]
    for dtype in (torch.float32, torch.bfloat16):
        inputs = fused_inputs(torch, rng, n, e, dtype)
        r = torch.from_numpy(rng.standard_normal((n, e)).astype(np.float32)).cuda()
        grads = []
        for fn in (ops.fused_ln_matmul, ops.fused_ln_matmul_plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            (fn(*leaves, act=act).float() * r).sum().backward()
            grads.append([t.grad for t in leaves])
        # f32: the two backwards sum in other orders; bf16: the hand-derived
        # backward keeps dy in f32 where autograd of the plain version
        # rounds it to bf16 (the dtype of y's cast)
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        for name, gk, gp in zip(("x", "g", "beta", "w", "b"), *grads):
            scale = gp.float().abs().max().item()
            err = max_err(gk, gp)
            print(f"K5 fused LN+matmul grad {str(dtype)[6:]} encoder MLP gelu d{name}: "
                  f"max |err| = {err:.3e} (atol {rel:g} x max |d{name}| = {rel * scale:.3e})")
            require(err <= rel * scale, f"fused LN+matmul gradient {dtype} d{name} disagrees: "
                    f"{err} > {rel * scale}")
    return entry


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path, then f32 kernels vs plain versions
# ---------------------------------------------------------------------------

def requests(rng):
    return [synthetic_audio(rng, 5 + 25 * i / (BATCH - 1)) for i in range(BATCH)]


def kernel_name_of(key: str) -> str:
    """``ns::name<args>(params)`` -> ``name<args>``, for a profiler row."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(", 1)[0].split("::")[-1]


def profile_run(torch, fn, card, wall_ms, table_path, what):
    """``fn`` once more under torch.profiler: device time by kernel, and the
    device's busy share of ``wall_ms``, the same work's wall time without
    the profiler (which slows the host side many times over). The full
    table goes to ``table_path``."""
    import pathlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only (kernels and copies); the aten rows would
    # count the same device time a second time
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile of {what} [{card}]: device busy {busy_ms:.1f} ms of the "
          f"{wall_ms:.1f} ms unprofiled wall = {100 * busy_ms / wall_ms:.1f}% "
          f"(idle {100 - 100 * busy_ms / wall_ms:.1f}%), {sum(r[1] for r in rows)} device ops")
    for us, n, key in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  x{n:<6d} {key[:90]}")
    ours = [(us, n, kernel_name_of(key)) for us, n, key in rows
            if any(k in key for k in ("mel_", "flash_", "quant_cross", "ln_matmul"))]
    print("  the port's kernels in it: " + "; ".join(
        f"{name} {us / 1e3:.3f} ms x{n}" for us, n, name in ours))
    table_path = pathlib.Path(table_path)
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(prof.key_averages().table(sort_by="self_device_time_total",
                                                    row_limit=60))


def mel_split(torch, pipe, ops, clips, kwargs, card, rounds: int = 5) -> None:
    """The serving path's ``mel_ms`` taken apart, median (and range) of
    ``rounds`` rounds. A round runs ``transcribe`` as the main path does,
    with its clock and ``Pipeline.mel`` watched from outside (a host-clock
    mark beside each of the pipeline's CUDA events, and the garbage
    collector's pauses), so that its own ``mel_ms`` splits into the host's
    ``pad_or_trim`` + ``np.stack``, the ``Pipeline.mel`` call and the GC.
    Then, in the state that decode leaves: the whole ``Pipeline.mel(np.stack
    (...))`` call under the pipeline's clock, and its pieces one at a time:
    pad + stack (host clock), the host-to-device copy of the pageable stack
    (CUDA events, and its host clock), K1 and the log tail (CUDA events from
    the end of the copy to the end of each, so the host's time to issue them
    is in)."""
    import gc

    from whisper_context_biasing_tpu_torch import pipeline as pipeline_module
    from whisper_context_biasing_tpu_torch.audio import pad_or_trim
    from whisper_context_biasing_tpu_torch.audio.mel import log_mel_tail
    from whisper_context_biasing_tpu_torch.utils.profiling import Clock

    host, pauses = {}, []

    class WatchedClock(Clock):
        def mark(self, name):
            super().mark(name)
            host[name] = time.perf_counter()

    def watched_mel(stacked):
        host["mel_in"] = time.perf_counter()
        out = type(pipe).mel(pipe, stacked)
        host["mel_out"] = time.perf_counter()
        return out

    def on_gc(phase, info):
        pauses.append((phase, time.perf_counter()))

    def stack():
        return np.stack([pad_or_trim(c, pipe.window_samples) for c in clips])

    def whole_call():
        torch.cuda.synchronize()
        clock = Clock(torch.device("cuda"))
        clock.mark("start")
        pipe.mel(stack())
        clock.mark("mel")
        return clock.ms("start", "mel")

    runs = []
    for _ in range(rounds):
        pauses.clear()
        pipeline_module.Clock, pipe.mel = WatchedClock, watched_mel
        gc.callbacks.append(on_gc)
        try:
            torch.cuda.synchronize()
            pipe.transcribe(clips, **kwargs)
            torch.cuda.synchronize()
        finally:
            gc.callbacks.remove(on_gc)
            pipeline_module.Clock = Clock
            del pipe.mel
        starts = [t for ph, t in pauses if ph == "start"]
        gc_ms = sum((stop - start) * 1e3 for start, stop in
                    zip(starts, [t for ph, t in pauses if ph == "stop"])
                    if host["start"] <= start <= host["mel"])
        in_pipe = (pipe.last_timings["mel_ms"], (host["mel_in"] - host["start"]) * 1e3,
                   (host["mel_out"] - host["mel_in"]) * 1e3, gc_ms)
        whole = whole_call()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked = stack()
        t1 = time.perf_counter()
        ev[0].record()
        audio = torch.as_tensor(stacked, dtype=torch.float32, device="cuda")
        ev[1].record()
        t2 = time.perf_counter()
        energies = ops.mel_energies(audio, pipe.cfg.n_mels)
        ev[2].record()
        log_mel_tail(energies)
        ev[3].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        runs.append(in_pipe + (whole, (t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                               (t2 - t1) * 1e3, ev[1].elapsed_time(ev[2]),
                               ev[2].elapsed_time(ev[3]), (t3 - t0) * 1e3, whole_call()))
    (mel_ms, pad_stack_in, call_in, gc_in, whole, pad_stack, copy, copy_host, k1, tail, total,
     whole_again) = (f"{statistics.median(c):.3f} ms ({min(c):.3f}-{max(c):.3f})"
                     for c in zip(*runs))
    print(f"  mel_ms split (median and range of {rounds} rounds, {stacked.nbytes / 1e6:.1f} MB of "
          f"audio) [{card}]:\n"
          f"    in transcribe: mel_ms {mel_ms} (the pipeline's CUDA events) = host pad_or_trim + "
          f"np.stack {pad_stack_in} + the Pipeline.mel call {call_in} (host clock), GC pauses "
          f"in that window {gc_in}\n"
          f"    after the decode: Pipeline.mel(np.stack(...)) {whole} (the pipeline's clock), "
          f"{whole_again} once more after the pieces\n"
          f"    its pieces: host pad_or_trim + np.stack {pad_stack} (host clock); host-to-device "
          f"copy {copy} (CUDA events; {copy_host} on the host clock); K1 issued and run {k1}; "
          f"log tail issued and run {tail} (CUDA events); {total} in all (host clock)")


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
    mel_split(torch, pipe, ops, clips, kwargs, card)
    if profile:
        profile_run(torch, lambda: pipe.transcribe(clips, **kwargs), card, wall * 1e3,
                    profile, "the serving path")
    return counts, [r.tokens for r in res]


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
    return runs[0]  # the kernel run's tokens and top-2 gaps: phase 15's reference


# ---------------------------------------------------------------------------
# phases 5 and 6: the training step, then f32 kernels vs plain versions
# ---------------------------------------------------------------------------

def train_batch(rng) -> dict:
    """BATCH x ACCUM rows of raw audio with prompted labels (<|startofprev|>
    context <|startoftranscript|> text <|endoftext|>, 449 tokens, so the
    decoder reads T_TEXT = 448) and the bias words' spans, some planted in
    the text, collated by the port's collator; split into ACCUM microbatches."""
    from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer()
    ctx = tok.encode(CONTEXT.lower(), add_special_tokens=False)
    words = [tok.encode(w, add_special_tokens=False) for w in BIAS_WORDS]
    rows = []
    for i in range(BATCH * ACCUM):
        text = list(rng.integers(220, 50000, T_TEXT - len(ctx) - 2))
        for j, w in enumerate(words[: 1 + i % len(words)]):
            at = (j + 1) * len(text) // 4  # in place: the label length stays put
            text[at : at + len(w)] = w
        rows.append({"audio": synthetic_audio(rng, 5 + 25 * (i % BATCH) / (BATCH - 1)),
                     "labels": [tok.sop, *ctx, tok.sot, *text, tok.eot],
                     "bias_spans": words})
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop, max_target_length=T_TEXT + 1,
                                 bias_span_pad_id=tok.eot)
    batch = coll(rows)
    require(batch["decoder_input_ids"].shape == (BATCH * ACCUM, T_TEXT), "bad label length")
    return {k: v.reshape(ACCUM, BATCH, *v.shape[1:]) for k, v in batch.items()}


FUSED_LN = dict(fused_ln_qkv=True, fused_ln_mlp=True)  # the --fused_ln switch


def expected_train_launches(cfg, steps: int, s: int = T_TEXT, mel: bool = True) -> dict:
    """Launches the configuration implies: per microbatch one mel, and per
    flash use (every encoder layer; two per decoder layer at S >= the
    threshold) one forward, run again by the backward under full remat, and
    one backward; under the fused LayerNorm switches one fused launch per
    site (two per encoder block, three per decoder block), run again under
    full remat (its backward launches no kernel)."""
    uses = cfg.n_audio_layers + (2 * cfg.n_text_layers if s >= cfg.flash_decoder_min_seq
                                 else 0)
    n = steps * ACCUM
    remat = 2 if cfg.remat == "full" else 1
    want = {"mel": n} if mel else {}
    want.update(flash_attention=n * uses * remat, flash_attention_bwd=n * uses)
    if cfg.fused_ln_qkv and cfg.fused_ln_mlp:
        want["fused_ln_matmul"] = n * (2 * cfg.n_audio_layers + 3 * cfg.n_text_layers) * remat
    return want


def train(torch, ops, card, profile=None, fused=False, baseline=None):
    """Phase 5 (``fused=False``) or phase 7: TRAIN_STEPS steps of the
    base.en training step; ``baseline`` is phase 5's step walls, printed
    beside phase 7's."""
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    batch = train_batch(np.random.default_rng(7))
    cfg = get_config("base.en", dtype="bfloat16", flash_attention=True, remat="full",
                     **(FUSED_LN if fused else {}))
    model = build_model(cfg, seed=0, device="cuda", train=True)
    # the reference recipe, as the JAX package's training benchmark builds it
    opt = make_optimizer(peak_lr=1e-5, warmup_steps=50, total_steps=1000)
    step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM, mel_on_device=True)
    state = init_train_state(model, opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    counts = dict(ops.launches)
    want = expected_train_launches(cfg, TRAIN_STEPS)
    audio_s = BATCH * ACCUM * 30.0  # 30 s-padded windows, as the training benchmark counts
    what = "fused LN+matmul training path (--fused_ln)" if fused else "training path"
    print(f"{what} (base.en bf16, flash, remat full, mel in the step, batch {BATCH} x "
          f"accum {ACCUM}, labels {T_TEXT}) on {card}:")
    for i, ((loss, gn), w) in enumerate(zip(metrics, walls)):
        beside = ("" if baseline is None else f"; unfused (phase 5) {baseline[i] * 1e3:.1f} ms, "
                  f"{audio_s / baseline[i]:.1f} audio-s/s")
        print(f"  step {i + 1}: loss {loss:.4f}, grad norm {gn:.4f}, wall {w * 1e3:.1f} ms, "
              f"{audio_s / w:.1f} train audio-s/s{beside}  [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches over {TRAIN_STEPS} steps: {counts} (the configuration implies {want})")
    require(all(np.isfinite(x) for mt in metrics for x in mt), "non-finite loss or grad norm")
    require(counts == want, f"training launches {counts} != {want}")
    require(state.step == TRAIN_STEPS, "the step counter did not advance")
    if profile:
        profile_run(torch, lambda: step(state, batch), card, walls[-1] * 1e3, profile,
                    f"one {'fused ' if fused else ''}training step")
    return counts, walls


def train_f32_agreement(torch, ops, fused=False):
    """Phase 6 (``fused=False``) or phase 8: one f32 step with every kernel
    of the configuration (and the fused LayerNorm switches in phase 8)
    against the all-plain configuration."""
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}
    runs = []
    for kernels in (True, False):
        cfg = get_config("base.en", dtype="float32", flash_attention=kernels, remat="full",
                         **(FUSED_LN if fused and kernels else {}))
        model = build_model(cfg, seed=0, device="cuda", train=True)
        opt = make_optimizer(peak_lr=1e-5, warmup_steps=50, total_steps=1000)
        step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM,
                               mel_on_device=kernels)
        if kernels:
            b = batch
        else:  # the plain frontend, named outright
            audio = batch["audio"]
            feats = log_mel_spectrogram(audio.flatten(0, 1), n_mels=cfg.n_mels)
            b = dict({k: v for k, v in batch.items() if k != "audio"},
                     input_features=feats.view(*audio.shape[:2], *feats.shape[1:]))
        ops.reset_launch_counts()
        _, m = step(init_train_state(model, opt), b)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        print(f"  f32 training {'kernel' if kernels else 'plain'} run launches: {counts}")
        if kernels:
            want = expected_train_launches(cfg, 1)
            require(counts == want, f"f32 kernel training run launches {counts} != {want}")
        else:
            require(not counts, f"f32 plain training run launched kernels: {counts}")
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     {n: p.grad for n, p in model.named_parameters()}))
        del model, opt, step
    (kl, kn, kg), (pl, pn, pg) = runs
    diff = sum(((kg[n] - pg[n]).double() ** 2).sum().item() for n in pg) ** 0.5
    ref = sum((pg[n].double() ** 2).sum().item() for n in pg) ** 0.5
    worst = max(pg, key=lambda n: (kg[n] - pg[n]).abs().max().item()
                / max(pg[n].abs().max().item(), 1e-30))
    worst_rel = ((kg[worst] - pg[worst]).abs().max() / pg[worst].abs().max()).item()
    # f32 on both routes, TF32 off: the kernels and the plain attention sum in
    # other orders (~1e-6 relative per attention output), carried through 12
    # layers and the backward; the limit leaves an order of magnitude of room
    print(f"f32 {'fused ' if fused else ''}training step, kernels vs plain versions: "
          f"loss {kl:.7f} vs {pl:.7f} "
          f"(rel {abs(kl - pl) / abs(pl):.2e}, limit 1e-5), grad norm {kn:.6f} vs {pn:.6f}, "
          f"|g_kernel - g_plain| / |g_plain| = {diff / ref:.2e} (limit 1e-4), worst tensor "
          f"{worst}: max |err| / max |g| = {worst_rel:.2e}")
    require(abs(kl - pl) <= 1e-5 * abs(pl), f"f32 training loss disagrees: {kl} vs {pl}")
    require(diff <= 1e-4 * ref, f"f32 training gradients disagree: {diff / ref}")


# ---------------------------------------------------------------------------
# phase 9: the fine-tuning entry point
# ---------------------------------------------------------------------------

CORPUS_ROWS = {"train": 2 * BATCH, "dev": BATCH}  # 2 optimizer steps' worth, one eval batch
EVAL_MAX_LEN = 32


def write_corpus(root, rng, rows=CORPUS_ROWS) -> None:
    """``{root}/jsonl/{phase}.jsonl`` rows (text, description, bias words from
    the training phase's vocabulary) and ``{root}/audio/{phase}/*.wav`` clips
    of 5-30 s of speech-like signal, 16 kHz int16; ``rows``: phase -> count."""
    import wave

    (root / "jsonl").mkdir(parents=True)
    for phase, n in rows.items():
        (root / "audio" / phase).mkdir(parents=True)
        with open(root / "jsonl" / f"{phase}.jsonl", "w") as f:
            for i in range(n):
                words = [BIAS_WORDS[(i + j) % len(BIAS_WORDS)] for j in range(1 + i % 2)]
                text = f"Patient {i} takes {' and '.join(words)} daily."
                f.write(json.dumps({"id": str(i), "file": f"{phase}{i}.wav", "text": text,
                                    "description": CONTEXT, "bias_words": words}) + "\n")
                clip = synthetic_audio(rng, 5 + 25 * (i % BATCH) / (BATCH - 1))
                with wave.open(str(root / "audio" / phase / f"{phase}{i}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes((np.clip(clip, -1, 1) * 32767).astype(np.int16).tobytes())


def entry_point(torch, ops, card):
    """``train_and_evaluate`` with the --fused_ln config: 2 optimizer steps
    of batch 8 x accum 2, an eval and a save at step 2. Returns the
    launches of the run."""
    import pathlib
    import tempfile

    from whisper_context_biasing_tpu_torch.data import PromptWhisperDataset, SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.metrics import parse_refs_and_pred_file
    from whisper_context_biasing_tpu_torch.models import get_config
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
    from whisper_context_biasing_tpu_torch.train import (
        TrainingConfig,
        load_checkpoint,
        train_and_evaluate,
    )
    from whisper_context_biasing_tpu_torch.utils import RunLogger

    stamps = []

    class StampedLogger(RunLogger):
        """Records the host clock at each logged entry (a step's entry is
        logged once its loss is read, i.e. after the step has finished)."""

        def log(self, event, step=None):
            stamps.append((dict(event), time.perf_counter()))
            super().log(event, step)

    tok = load_tokenizer()
    cfg = get_config("base.en", dtype="bfloat16", flash_attention=True, remat="full", **FUSED_LN)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_corpus(root / "corpus", np.random.default_rng(8))
        data = {phase: PromptWhisperDataset(str(root / "corpus" / "audio"),
                                            str(root / "corpus" / "jsonl"), phase,
                                            tokenizer=tok, prompt=True, bias_list=True,
                                            bias_nums=3)
                for phase in CORPUS_ROWS}
        coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id,
                                     decoder_start_token_id=tok.sot,
                                     decoder_prev_token_id=tok.sop, pad_to_multiple=32)
        out = root / "run"
        tcfg = TrainingConfig(output_dir=str(out), per_device_train_batch_size=BATCH,
                              gradient_accumulation_steps=ACCUM, num_train_epochs=2,
                              eval_steps=2, save_steps=2, logging_steps=1,
                              per_device_eval_batch_size=BATCH,
                              generation_max_length=EVAL_MAX_LEN, bias_boost=2.0)
        logger = StampedLogger(str(out), echo=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, hist = train_and_evaluate(cfg, None, tok, data["train"], data["dev"], coll,
                                         tcfg, logger=logger, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
        logger.close()
        stamp = {(e["step"], "eval_wer" in e): t for e, t in stamps}
        rows = parse_refs_and_pred_file(str(out / "refs_and_pred.txt"))
        sd, _, meta = load_checkpoint(str(out / "checkpoint-2"), cfg)
        same = all(torch.equal(sd[n], p.detach().cpu()) for n, p in model.named_parameters())
    eval_batches = -(-CORPUS_ROWS["dev"] // BATCH)
    per_step = expected_train_launches(cfg, 1, mel=False)["fused_ln_matmul"]
    want_fused = 2 * per_step + eval_batches * 2 * cfg.n_audio_layers
    print(f"fine-tuning entry point (train_and_evaluate, base.en bf16 --fused_ln, flash, remat "
          f"full, batch {BATCH} x accum {ACCUM}, 2 steps, eval of {CORPUS_ROWS['dev']} rows at "
          f"generation_max_length {EVAL_MAX_LEN}, bias boost 2.0) on {card}:")
    print(f"  step 1 {1e3 * (stamp[1, False] - t0):.1f} ms after the call (model build, "
          f"loader start and first-use set-up included), step 2 "
          f"{1e3 * (stamp[2, False] - stamp[1, False]):.1f} ms, eval "
          f"{1e3 * (stamp[2, True] - stamp[2, False]):.1f} ms, whole call {wall:.2f} s "
          f"(checkpoint write and best-checkpoint reload included)  [{card}]")
    print(f"  log history: {[{k: v for k, v in e.items() if k != 'elapsed_s'} for e in hist]}")
    print(f"  refs_and_pred.txt: {len(rows[0])} rows; checkpoint-2 step {meta['step']}, "
          f"params equal to the trained model: {same}")
    print(f"  launches: {counts} (fused LN+matmul: 2 steps x {per_step} + {eval_batches} eval "
          f"batch(es) x {2 * cfg.n_audio_layers} = {want_fused})")
    require(any("loss" in e and np.isfinite(e["loss"]) for e in hist), "no finite loss logged")
    require(any("eval_wer" in e for e in hist), "no eval_wer logged")
    require(len(rows[0]) == CORPUS_ROWS["dev"], f"refs_and_pred.txt has {len(rows[0])} rows")
    require(meta["step"] == 2 and same, "checkpoint-2 does not hold the trained model")
    require(counts.get("fused_ln_matmul") == want_fused,
            f"fused LN+matmul launches {counts.get('fused_ln_matmul')} != {want_fused}")
    require(counts.get("flash_attention", 0) > 0 and counts.get("flash_attention_bwd", 0) > 0,
            "the entry point never launched the flash kernels")
    return counts


# ---------------------------------------------------------------------------
# phase 10: the reference's entry points
# ---------------------------------------------------------------------------

ENTRY_ROWS = {"train": 2 * BATCH, "dev": BATCH, "test": BATCH}


def mp3_check() -> None:
    """Whether libmpg123 (the ``.mp3`` decoder) and libmp3lame are here; with
    both, a 1 s 440 Hz tone written with libmp3lame goes through
    ``load_audio``: about 1 s at 16 kHz, its peak at 440 Hz. The corpus of
    this phase is WAV, so neither library is required."""
    import ctypes
    import ctypes.util
    import tempfile

    from whisper_context_biasing_tpu_torch.audio import load_audio
    from whisper_context_biasing_tpu_torch.audio.mp3 import available

    lame = None
    for cand in (ctypes.util.find_library("mp3lame"), "libmp3lame.so.0"):
        try:
            lame = ctypes.CDLL(cand) if cand else None
        except OSError:
            continue
        if lame is not None:
            break
    print(f"  libmpg123 {'found' if available() else 'not found'}, libmp3lame "
          f"{'found' if lame is not None else 'not found'}")
    if lame is None or not available():
        return
    pcm = (0.5 * 32767 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)).astype(np.int16)
    lame.lame_init.restype = ctypes.c_void_p
    h = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(h, 16000)
    lame.lame_set_num_channels(h, 1)
    lame.lame_set_mode(h, 3)  # mono
    lame.lame_set_brate(h, 96)
    require(lame.lame_init_params(h) >= 0, "lame_init_params failed")
    buf = ctypes.create_string_buffer(pcm.size * 5 // 4 + 7200)
    ptr = pcm.ctypes.data_as(ctypes.c_void_p)
    n = lame.lame_encode_buffer(h, ptr, ptr, pcm.size, buf, len(buf))
    data = buf.raw[:n]
    n = lame.lame_encode_flush(h, buf, len(buf))
    data += buf.raw[:n]
    lame.lame_close(h)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tone.mp3")
        with open(path, "wb") as f:
            f.write(data)
        audio = load_audio(path)
    spec = np.abs(np.fft.rfft(audio[4000:12000] * np.hanning(8000)))
    peak = float(np.fft.rfftfreq(8000, 1 / 16000)[np.argmax(spec)])
    print(f"  .mp3 decoded through libmpg123: {audio.size} samples at 16 kHz, peak at "
          f"{peak:.0f} Hz")
    require(abs(audio.size - 16000) < 4000 and abs(peak - 440) < 10, "the .mp3 decoded wrong")


def entry_points(torch, ops, card, serve_counts, serve_tokens, tmp):
    """The reference's entry points at base.en width, in-process:
    (a) phase 3's seeded weights written as ``model.safetensors`` and read
    back bit-identical, then ``Pipeline(checkpoint=...)`` on phase 3's
    requests: phase 3's tokens and launches; (b) ``cli.train`` with
    ``--init_checkpoint`` that file, ``--flash_attention --fused_ln``, 2
    optimizer steps of batch 8 x accum 2, an eval and a save at step 2, the
    test eval: its result files, ``checkpoint-2`` and exactly the launches
    the configuration implies; (c) ``cli.export_hf`` of ``checkpoint-2``,
    then ``cli.evaluation --final_model`` on the export and
    ``--best_checkpoint`` on the run: the same ``refs_and_pred.txt``.
    Works in the directory ``tmp``; returns the launches of (a) and (b)
    summed, and the path of the ``model.safetensors`` it wrote."""
    import pathlib

    from whisper_context_biasing_tpu_torch import Pipeline
    from whisper_context_biasing_tpu_torch.cli import evaluation, export_hf
    from whisper_context_biasing_tpu_torch.cli import train as train_cli
    from whisper_context_biasing_tpu_torch.data import PromptWhisperDataset
    from whisper_context_biasing_tpu_torch.metrics import parse_refs_and_pred_file
    from whisper_context_biasing_tpu_torch.models import (
        get_config,
        init_state_dict,
        load_safetensors,
        save_safetensors,
    )
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
    from whisper_context_biasing_tpu_torch.train import load_checkpoint

    start = time.perf_counter()
    walls = {}
    total = {}
    root = pathlib.Path(tmp)
    # (a) the checkpoint round trip and serving from it
    base = get_config("base.en")
    sd = init_state_dict(base, 0)  # what Pipeline("base.en", seed=0) builds
    path = root / "init" / "model.safetensors"
    t0 = time.perf_counter()
    save_safetensors(sd, base, str(path))
    t1 = time.perf_counter()
    back, cfg = load_safetensors(str(path))
    t2 = time.perf_counter()
    print(f"  model.safetensors {path.stat().st_size / 1e6:.1f} MB: written in "
          f"{t1 - t0:.2f} s, read back in {t2 - t1:.2f} s (host)")
    require(back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd),
            "the safetensors round trip is not bit-identical")
    dims = ("n_mels", "n_audio_ctx", "d_model", "n_heads", "n_audio_layers",
            "n_text_layers", "n_vocab", "n_text_ctx", "multilingual")
    require(all(getattr(cfg, f) == getattr(base, f) for f in dims),
            f"config_from_state_dict gave {cfg}")
    clips = requests(np.random.default_rng(4))
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                  max_tokens=MAX_TOKENS)
    t0 = time.perf_counter()
    pipe = Pipeline("base.en", checkpoint=str(path), device="cuda", seed=0)
    pipe.transcribe(clips, **kwargs)  # warm-up, as phase 3
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    walls["Pipeline(checkpoint=...) build + 2 batches"] = time.perf_counter() - t0
    same = [r.tokens for r in res] == serve_tokens
    print(f"  Pipeline(checkpoint=model.safetensors): tokens identical to phase 3: {same}; "
          f"launches {counts} (phase 3: {serve_counts})")
    require(same, "Pipeline(checkpoint=) tokens differ from the seeded Pipeline's")
    require(counts == serve_counts, "Pipeline(checkpoint=) launches differ from phase 3's")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    del pipe

    # (b) the train CLI
    corpus, out = root / "corpus", root / "run"
    write_corpus(corpus, np.random.default_rng(9), ENTRY_ROWS)
    data = ["--data_root", str(corpus), "--data_dir", "audio",
            "--jsonl_data", str(corpus / "jsonl")]
    tok = load_tokenizer()
    longest = max(len(ds.build_label_sequence(i)) for ds in (
        PromptWhisperDataset(str(corpus / "audio"), str(corpus / "jsonl"), phase,
                             tokenizer=tok, prompt=True, bias_list=True, seed=42)
        for phase in ENTRY_ROWS) for i in range(len(ds)))
    cfg = get_config("base.en", flash_attention=True, fused_ln_qkv=True, fused_ln_mlp=True)
    # the collator pads labels to a multiple of 32
    require(-(-longest // 32) * 32 < cfg.flash_decoder_min_seq,
            f"labels of {longest} tokens take the decoder's flash path; the expected "
            "launches assume they do not")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, hist = train_cli.main([
        *data, "--output", str(out), "--init_checkpoint", str(path), "--flash_attention",
        "--fused_ln", "--prompt", "--bias_list", "--batch", str(BATCH), "--grad_accum",
        str(ACCUM), "--epoch", "2", "--eval_steps", "2", "--save_steps", "2",
        "--logging_steps", "1", "--eval_batch", str(BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    walls["cli.train"] = time.perf_counter() - t0
    counts = dict(ops.launches)
    # the step-2 dev eval and the test eval
    evals = -(-ENTRY_ROWS["dev"] // BATCH) + -(-ENTRY_ROWS["test"] // BATCH)
    want = expected_train_launches(cfg, 2, s=0, mel=False)
    want["flash_attention"] += evals * cfg.n_audio_layers
    want["fused_ln_matmul"] += evals * 2 * cfg.n_audio_layers
    results = {name: json.loads((out / name).read_text())
               for name in ("test_results.json", "bias_wer_results.json")}
    refs, preds = parse_refs_and_pred_file(str(out / "refs_and_pred.txt"))
    ckpt, _, meta = load_checkpoint(str(out / "checkpoint-2"), cfg)
    reloaded = all(torch.equal(ckpt[n], p.detach().cpu()) for n, p in model.named_parameters())
    print(f"  cli.train --flash_attention --fused_ln (labels up to {longest} tokens): log "
          f"history {[{k: v for k, v in e.items() if k != 'elapsed_s'} for e in hist]}")
    print(f"    {results}; refs_and_pred.txt {len(refs)} rows; checkpoint-2 step "
          f"{meta['step']}, equal to the returned model: {reloaded}")
    print(f"    launches {counts} (2 steps and {evals} eval batches imply {want})")
    require(set(results["test_results.json"]) == {"wer"}, "test_results.json has no wer")
    require(len(refs) == len(preds) == ENTRY_ROWS["test"],
            f"refs_and_pred.txt has {len(refs)} rows")
    require(meta["step"] == 2 and reloaded, "checkpoint-2 does not hold the trained model")
    require(any("loss" in e and np.isfinite(e["loss"]) for e in hist), "no finite loss")
    require(counts == want, f"cli.train launches {counts} != {want}")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    del model

    # (c) export, then the evaluation CLI through the two loaders
    t0 = time.perf_counter()
    export_hf.main(["--model", "base.en", "--checkpoint", str(out / "checkpoint-2"),
                    "--out", str(root / "export")])
    walls["cli.export_hf"] = time.perf_counter() - t0
    runs = {"--final_model": ["--final_model", "--model_path",
                              str(root / "export" / "model.safetensors"),
                              "--output", str(root / "eval_final")],
            "--best_checkpoint": ["--best_checkpoint", "--output", str(out),
                                  "--refs_pred_file", str(root / "best_refs_and_pred.txt")]}
    for mode, argv in runs.items():
        t0 = time.perf_counter()
        evaluation.main([*data, "--batch", str(BATCH), "--device", "cuda", *argv])
        torch.cuda.synchronize()
        walls[f"cli.evaluation {mode}"] = time.perf_counter() - t0
    files = [(root / "eval_final" / "refs_and_pred.txt").read_text(),
             (root / "best_refs_and_pred.txt").read_text()]
    print(f"  cli.evaluation --final_model (the export) and --best_checkpoint (the run): "
          f"refs_and_pred.txt identical: {files[0] == files[1]}")
    require(files[0] == files[1], "the two loaders' refs_and_pred.txt differ")
    mp3_check()
    for name, w in walls.items():
        print(f"  {name}: {w:.2f} s wall  [{card}]")
    print(f"  phase 10 took {time.perf_counter() - start:.1f} s  [{card}]")
    return total, path


# ---------------------------------------------------------------------------
# phase 11: long-form and beam serving
# ---------------------------------------------------------------------------

DEVICE = "cuda"
LONG_CLIPS_S = (75.0, 48.0)
BEAMS = 5


def parse_srt(text: str) -> list[tuple[float, float, str]]:
    """Cues of an SRT document; raises on a malformed one: 1-based
    consecutive indices, ``HH:MM:SS,mmm --> HH:MM:SS,mmm``, start <= end."""
    def secs(stamp):
        m = re.fullmatch(r"(\d\d):(\d\d):(\d\d),(\d\d\d)", stamp)
        require(m is not None, f"bad SRT time {stamp!r}")
        h, mi, s, ms = (int(g) for g in m.groups())
        return h * 3600 + mi * 60 + s + ms / 1000

    cues = []
    for i, block in enumerate(b for b in text.strip().split("\n\n") if b.strip()):
        lines = block.split("\n")
        require(len(lines) >= 2 and lines[0] == str(i + 1), f"bad SRT cue {block!r}")
        start, arrow, end = lines[1].partition(" --> ")
        require(arrow == " --> ", f"bad SRT timing line {lines[1]!r}")
        a, e = secs(start), secs(end)
        require(a <= e, f"SRT cue ends before it starts: {lines[1]!r}")
        cues.append((a, e, "\n".join(lines[2:])))
    return cues


def device_busy_ms(torch, fn) -> tuple[float, int]:
    """``fn`` once under torch.profiler with CUDA activity only: the sum of
    the device's kernel and copy times, and their count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def long_form_batch(torch, Pipeline, ops, card):
    """(a) Two speech-like clips of 75 s and 48 s, one context, 3 bias words:
    timestamps, the default ladder with best_of 2, window info, the VAD gate,
    64 tokens a window. Gates: exactly the launches the run implies (K1 one a
    window iteration, K2 six a decode call, K3 six a decode step) and SRT
    that parses back."""
    rng = np.random.default_rng(11)
    clips = [synthetic_audio(rng, s) for s in LONG_CLIPS_S]
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    mel_calls = []
    real_mel = pipe.mel

    def counted_mel(stacked):
        mel_calls.append(stacked.shape[0])
        return real_mel(stacked)

    pipe.mel = counted_mel
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, timestamps=True,
                  best_of=2, window_info=True, vad=True, max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PathRecorder() as rec:
        res = pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    steps = rec.steps
    want = {"mel": len(mel_calls), "flash_attention": N_LAYERS * len(rec.calls),
            "quant_cross_attention": N_LAYERS * steps}
    iterations = len(mel_calls)
    # the device's busy share, on the same batch with the t=0 rung alone:
    # profiling the full ladder's ~840,000 device operations takes minutes
    t0_kwargs = dict(kwargs, temperatures=(0.0,))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe.transcribe(clips, **t0_kwargs)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t1
    busy, n_ops = device_busy_ms(torch, lambda: pipe.transcribe(clips, **t0_kwargs))
    audio_s = sum(c.size for c in clips) / 16000.0
    print(f"(a) long-form batch (base.en bf16, clips of {LONG_CLIPS_S} s, timestamps, the "
          f"ladder 0.0-1.0 with best_of 2, VAD, {MAX_TOKENS} tokens a window) on {card}:")
    for i, r in enumerate(res):
        for w in r.windows:
            print(f"  clip {i} window at {w['start_s']:.2f} s: rung {w['temperature']}, avg "
                  f"logprob {w['avg_logprob']:.3f}, no-speech {w['no_speech_prob']:.2e}, "
                  f"compression {w['compression_ratio']}, accepted {w['accepted']}")
    print(f"  {iterations} window iterations, {len(rec.calls)} decode calls, {steps} decode "
          f"steps: wall {wall * 1e3:.1f} ms = {audio_s / wall:.1f} audio-s/s, wall / decode "
          f"steps {wall * 1e3 / steps:.2f} ms  [{card}]")
    print(f"  the same batch with the t=0 rung alone: wall {wall0 * 1e3:.1f} ms; device busy "
          f"{busy:.1f} ms of a profiled repeat ({n_ops} device ops) = "
          f"{100 * busy / (wall0 * 1e3):.1f}% of that wall (idle "
          f"{100 - 100 * busy / (wall0 * 1e3):.1f}%)  [{card}]")
    print(f"  launches {counts} (the run implies {want})")
    cues = [parse_srt(r.srt()) for r in res]
    print(f"  srt() cues per clip: {[len(c) for c in cues]}; tokens per clip: "
          f"{[len(r.tokens) for r in res]}")
    require(counts == want, f"long-form launches {counts} != {want}")
    require(all(r.windows for r in res), "a clip has no window info")
    require(all(len(c) == len(r.segments) for c, r in zip(cues, res)),
            "srt() lost cues")
    return counts, clips


def long_form_f32_gate(torch, Pipeline, ops, clips):
    """(b) The same clips at temperature 0 in f32, the kernels against their
    plain versions (by config, and the plain mel frontend): every decode
    call's tokens identical, or the first divergence at a top-2 logit gap
    < 1e-4 (as phase 4); then tokens, segments and seeks identical."""
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram

    runs = []
    for kernels in (True, False):
        over = {} if kernels else dict(flash_attention=False, fused_quant_cross=False)
        pipe = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32", config_overrides=over)
        if not kernels:  # the plain frontend, named outright
            pipe.mel = lambda stacked, pipe=pipe: log_mel_spectrogram(
                torch.as_tensor(stacked, device=DEVICE), n_mels=pipe.cfg.n_mels)
        ops.reset_launch_counts()
        with PathRecorder(margins=True) as rec:
            res = pipe.transcribe(clips, context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                                  timestamps=True, temperatures=(0.0,), window_info=True,
                                  max_tokens=MAX_TOKENS)
        counts = dict(ops.launches)
        if kernels:
            for name in ("mel", "flash_attention", "quant_cross_attention"):
                require(counts.get(name, 0) > 0, f"(b) f32 kernel run never launched {name}")
        else:
            require(not counts, f"(b) f32 plain run launched kernels: {counts}")
        runs.append((res, rec.calls, counts))
        del pipe
    (kres, kcalls, kc), (pres, pcalls, _) = runs
    print(f"(b) f32 long-form, kernels (launches {kc}) vs plain versions: "
          f"{len(kcalls)} and {len(pcalls)} decode calls")
    if not same_calls(kcalls, pcalls, "(b)"):
        return
    same = ([r.tokens for r in kres] == [r.tokens for r in pres]
            and [r.segments for r in kres] == [r.segments for r in pres]
            and [[w["start_s"] for w in r.windows] for r in kres]
            == [[w["start_s"] for w in r.windows] for r in pres])
    print(f"  tokens, segments and seeks identical: {same} "
          f"({sum(len(r.windows) for r in kres)} windows)")
    require(same, "(b) f32 long-form results differ")


def beam_serving(torch, Pipeline, ops, card):
    """(c) num_beams=5 on phase 3's 8 requests in bf16 (ms a step, the cache
    reorder's share, K3 six a step), then in f32 with the kernels against
    their plain versions: identical tokens."""
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from whisper_context_biasing_tpu_torch.decode import beam_decode, pack_prefixes

    clips = requests(np.random.default_rng(4))
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS,
                  num_beams=BEAMS)
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    pipe.transcribe(clips, **kwargs)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    tm = pipe.last_timings
    want = {"mel": 1, "flash_attention": N_LAYERS, "quant_cross_attention": N_LAYERS * tm["steps"]}
    per_step = tm["decode_ms"] / max(tm["steps"], 1)
    pipe.transcribe(clips, **dict(kwargs, num_beams=1))  # greedy, beside it
    greedy = pipe.last_timings
    print(f"(c) beam search (base.en bf16, {BATCH} requests x {BEAMS} beams, frozen pool, "
          f"{MAX_TOKENS} tokens) on {card}:")
    print(f"  encoder {tm['encode_ms']:.3f} ms, prefill {tm['prefill_ms']:.3f} ms, decode "
          f"{per_step:.3f} ms/step over {tm['steps']} steps (greedy on the same requests right "
          f"after: {greedy['decode_ms'] / max(greedy['steps'], 1):.3f} ms/step), cache reorder "
          f"{tm['reorder_ms'] / max(tm['steps'], 1):.3f} ms/step = "
          f"{100 * tm['reorder_ms'] / tm['decode_ms']:.1f}% of decode, wall {wall * 1e3:.1f} ms  "
          f"[{card}]")
    print(f"  launches {counts} (the run implies {want}); tokens per request "
          f"{[len(r.tokens) for r in res]}")
    require(counts == want, f"beam launches {counts} != {want}")
    del pipe

    runs = []
    for kernels in (True, False):
        over = {} if kernels else dict(flash_attention=False, fused_quant_cross=False)
        pipe = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32", config_overrides=over)
        tok = pipe.tokenizer
        ctx = tok.encode(CONTEXT.lower(), add_special_tokens=False)
        ids, mask = pack_prefixes([[tok.sop] + ctx + [tok.sot]] * BATCH, tok.eot)
        audio = np.stack([pad_or_trim(c, pipe.window_samples) for c in clips])
        ops.reset_launch_counts()
        mel = (pipe.mel(audio) if kernels else
               log_mel_spectrogram(torch.from_numpy(audio).to(DEVICE), n_mels=pipe.cfg.n_mels))
        out = beam_decode(pipe.model, mel, ids, mask, num_beams=BEAMS, max_new=MAX_TOKENS,
                          eot_id=tok.eot, bias_spans=pipe._spans(BIAS_WORDS, BATCH),
                          bias_boost=2.0, span_pad_id=tok.eot, device=DEVICE)
        c = dict(ops.launches)
        require(bool(c) == kernels, f"(c) f32 {'kernel' if kernels else 'plain'} run launches {c}")
        runs.append(out.tokens.cpu().numpy())
        del pipe
    same = np.array_equal(runs[0], runs[1])
    print(f"  f32 beam, kernels vs plain versions: all {BATCH} x {BEAMS} beams identical: {same}")
    require(same, "(c) f32 beam tokens differ between the kernels and the plain versions")
    return counts


def sampling_and_language(torch, Pipeline, card):
    """(d) temperature 1.0 with a generator on the card: one seed, the same
    tokens twice (another seed, other tokens); (e) ``Pipeline("base")`` with
    language="auto" on phase 3's requests: each start carries a language
    token."""
    from whisper_context_biasing_tpu_torch.audio import pad_or_trim
    from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes
    from whisper_context_biasing_tpu_torch.tokenizer import LANGUAGES

    clips = requests(np.random.default_rng(4))
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    tok = pipe.tokenizer
    mel = pipe.mel(np.stack([pad_or_trim(c, pipe.window_samples) for c in clips]))
    ids, mask = pack_prefixes([[tok.sot]] * BATCH, tok.eot)

    def sample(seed):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return greedy_decode(pipe.model, mel, ids, mask, max_new=16, eot_id=tok.eot,
                             temperature=1.0, generator=gen, device=DEVICE).tokens.cpu()

    a, b, c = sample(1234), sample(1234), sample(1235)
    print(f"(d) sampling at temperature 1.0, CUDA generator: seed 1234 twice identical: "
          f"{torch.equal(a, b)}; seed 1235 differs: {not torch.equal(a, c)}")
    require(torch.equal(a, b) and not torch.equal(a, c), "(d) seeded sampling does not repeat")
    del pipe

    pipe = Pipeline("base", device=DEVICE, seed=0)
    detected = pipe.detect_language(clips)
    starts, langs = pipe._starts(BATCH, lambda: pipe.mel(np.stack(
        [pad_or_trim(c, pipe.window_samples) for c in clips])), "auto", "transcribe")
    res = pipe.transcribe(clips, language="auto", max_tokens=8)
    lang_ids = {pipe.tokenizer.convert_tokens_to_ids(f"<|{lang}|>") for lang in LANGUAGES}
    print(f"(e) language id (base, multilingual, vocab {pipe.cfg.n_vocab}): detected "
          f"{detected[:3]}...; starts {starts[:2]}...; result languages {[r.language for r in res]}"
          f"  [{card}]")
    require(all(len(s) == 3 and s[1] in lang_ids for s in starts), "(e) starts lack <|xx|>")
    require([r.language for r in res] == [lang for lang, _ in detected] == langs,
            "(e) transcribe's languages differ from detect_language's")


def transcribe_cli(torch, ops, card, init_path, tmp):
    """(f) ``cli.transcribe --init_checkpoint <phase 10's model.safetensors>
    --long --timestamps --format srt --output_dir``: one SRT per file that
    parses back."""
    import pathlib
    import wave

    from whisper_context_biasing_tpu_torch.cli import transcribe

    root = pathlib.Path(tmp) / "transcribe"
    root.mkdir()
    rng = np.random.default_rng(12)
    paths = []
    for name, seconds in (("visit1", 40.0), ("visit2", 12.0)):
        path = root / f"{name}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(synthetic_audio(rng, seconds), -1, 1) * 32767)
                          .astype(np.int16).tobytes())
        paths.append(str(path))
    out = root / "srt"
    t0 = time.perf_counter()
    transcribe.main(["--audio", *paths, "--init_checkpoint", str(init_path), "--long",
                     "--timestamps", "--format", "srt", "--output_dir", str(out),
                     "--max_tokens", "32", "--temperatures", "0.0", "0.4",
                     "--bias_words", *BIAS_WORDS, "--bias_boost", "2.0",
                     "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cues = {p.name: parse_srt(p.read_text()) for p in sorted(out.glob("*.srt"))}
    print(f"(f) cli.transcribe --long --timestamps --format srt: {sorted(cues)} with "
          f"{[len(c) for c in cues.values()]} cues, {wall:.2f} s wall  [{card}]")
    require(sorted(cues) == ["visit1.srt", "visit2.srt"], f"(f) SRT files {sorted(cues)}")
    require(all(cues.values()), "(f) an SRT file has no cue")


def long_form_and_beam(torch, Pipeline, ops, card, init_path, tmp):
    """Phase 11; returns the launches of its main-path runs, (a) and (c)'s
    bf16 batch, summed."""
    start = time.perf_counter()
    long_counts, clips = long_form_batch(torch, Pipeline, ops, card)
    long_form_f32_gate(torch, Pipeline, ops, clips)
    beam_counts = beam_serving(torch, Pipeline, ops, card)
    sampling_and_language(torch, Pipeline, card)
    transcribe_cli(torch, ops, card, init_path, tmp)
    print(f"  phase 11 took {time.perf_counter() - start:.1f} s  [{card}]")
    return {k: long_counts.get(k, 0) + beam_counts.get(k, 0)
            for k in set(long_counts) | set(beam_counts)}


# ---------------------------------------------------------------------------
# phase 2, the shapes of phase 12: the bucket windows and the chunked batch
# ---------------------------------------------------------------------------

BUCKETS = (8, 15)
BUCKET_T = {8: 400, 15: 750}      # encoder states of a bucket's window
CHUNKED_BATCH = 32

# phase 13: the tiny.en draft's width, the draft's proposals a round, the
# Medusa heads
DRAFT = "tiny.en"
DRAFT_D, DRAFT_HEADS, DRAFT_LAYERS = 384, 6, 4
SPEC_K = 4
MEDUSA_HEADS = 4
# bf16 near-tie limit for speculative and Medusa tokens against plain
# greedy's: verification scores several positions at once (through the
# plain int8 path, not K3) where greedy scores one, so bf16 logits differ by
# roundings; one bf16 ulp of a logit in [1, 2) (base.en's random-weight
# logits stay under ~2.2 on these requests)
BF16_TIE = 2 ** -7


def check_flash_shape(torch, ops, rng, t, d=D_MODEL, heads=N_HEADS) -> dict:
    """K2 on an encoder's full (BATCH, t, heads x 64) attention, f32 and
    bf16, against its plain version with phase 2's limits, timed beside its
    bound and SDPA."""
    import torch.nn.functional as F

    dh, bh = d // heads, BATCH * heads

    def merged(t):
        x = torch.from_numpy(rng.standard_normal((BATCH, t, d), np.float32)).cuda()
        return x.view(BATCH, t, heads, dh)

    qkv32 = [merged(t) for _ in range(3)]
    o, lse = ops.flash_attention_fwd(*qkv32)
    po, plse = ops.flash_attention_fwd_plain(*qkv32)
    err32, lerr32 = max_err(o, po), max_err(lse, plse)
    require(err32 <= 2e-5 and lerr32 <= 1e-4, f"flash f32 at T={t}, {heads} heads disagrees: "
            f"{err32}")
    qkv = [q.to(torch.bfloat16) for q in qkv32]
    o, lse = ops.flash_attention_fwd(*qkv)
    po, plse = ops.flash_attention_fwd_plain(*qkv)
    err, lerr = max_err(o, po), max_err(lse, plse)
    require(err <= 5e-3 and lerr <= 1e-4, f"flash bf16 at T={t}, {heads} heads disagrees: "
            f"{err}, {lerr}")
    n_ops = 4 * bh * t * t * dh
    b_ms, b_by = bound(2 * bh * dh * 4 * t + 4 * bh * t, n_ops, PEAK_BF16_FLOP_S)
    ms = median_ms(torch, lambda: ops.flash_attention_fwd(*qkv))
    plain_ms = median_ms(torch, lambda: ops.flash_attention_fwd_plain(*qkv))
    split = [q.transpose(1, 2) for q in qkv]
    lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(*split))
    print(f"K2 flash encoder ({BATCH}, {t}x{t}, {heads}x{dh}): f32 max |o err| {err32:.3e} "
          f"(2e-5), |lse err| {lerr32:.3e} (1e-4); bf16 max |o err| {err:.3e} (5e-3), |lse err| "
          f"{lerr:.3e} (1e-4); bf16 {ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, SDPA {lib_ms:.4f} ms)")
    return dict(kernel="flash_attention", shape=f"{BATCH}x{t}x{t}x{heads}", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, library_ms=lib_ms)


def check_quant_shape(torch, ops, rng, b, t_pad, t, d=D_MODEL, heads=N_HEADS,
                      layers=N_LAYERS) -> dict:
    """K3 on (layers, b, t_pad, d) int8 cross K/V with t real keys, f32 and
    bf16 at every layer, against its plain version (limits relative to the
    output's scale), timed rotating over the layers beside its bound."""
    from whisper_context_biasing_tpu_torch.ops.quant_cross_attention import pick_splits

    shape = (layers, b, t_pad, d)
    k_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    v_q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    scales = rng.uniform(0.005, 0.05, (2, layers, b, 1, t_pad)).astype(np.float32)
    scales[..., t:] = 0.0
    k_s, v_s = (torch.from_numpy(s).cuda() for s in scales)
    q32 = torch.from_numpy(rng.standard_normal((b, 1, d), np.float32)).cuda()
    errs, limits = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q = q32.to(dtype)
        pairs = [(ops.quant_cross_attention_step_indexed(q, k_q, k_s, v_q, v_s, li, heads),
                  ops.quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s, li,
                                                               heads))
                 for li in range(layers)]
        errs[dtype] = max(max_err(k, p) for k, p in pairs)
        # relative to the output's scale, as the K2 causal and K5 checks
        # are: a batch of 32 holds 4x the outputs of phase 2's 8, so its
        # largest error is larger. f32: sums in another order; bf16: the
        # output rounds once more on each route, one ulp of an output in
        # [2, 4) is 2^-6 = 0.0156, over phase 2's absolute 1e-2
        scale = max(1.0, max(p.float().abs().max().item() for _, p in pairs))
        limits[dtype] = (1e-5 if dtype == torch.float32 else 1e-2) * scale
        require(errs[dtype] <= limits[dtype], f"int8 cross-attention {dtype} at B={b}, "
                f"T_pad={t_pad}, {heads} heads disagrees: {errs[dtype]} > {limits[dtype]}")
    n_bytes = 2 * b * t * d + 2 * 4 * b * t_pad + 2 * 2 * b * d
    b_ms, b_by = bound(n_bytes, 4 * b * t * d, PEAK_BF16_FLOP_S)
    cycle = itertools.cycle(range(layers))
    ms = median_ms(torch, lambda: ops.quant_cross_attention_step_indexed(
        q, k_q, k_s, v_q, v_s, next(cycle), heads))
    plain_ms = median_ms(torch, lambda: ops.quant_cross_attention_step_indexed_plain(
        q, k_q, k_s, v_q, v_s, layers // 2, heads))
    width = "" if (d, heads, layers) == (D_MODEL, N_HEADS, N_LAYERS) else \
        f"{layers} layers, d {d}, {heads} heads, "
    print(f"K3 int8 cross-attention ({width}B {b}, T_pad {t_pad}, {t} keys, "
          f"{pick_splits(t_pad, b * heads)} splits): f32 max |err| {errs[torch.float32]:.3e} (atol "
          f"{limits[torch.float32]:.2e}: 1e-5 x max(1, max |out|)), bf16 "
          f"{errs[torch.bfloat16]:.3e} (atol {limits[torch.bfloat16]:.2e}: 1% of it); bf16 "
          f"rotating over the layers {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"by {b_by})")
    return dict(kernel="quant_cross_attention", shape=f"{layers}x{b}x{t_pad}({t})x{d}",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms, bound_ms=b_ms)


def check_bucket_shapes(torch, ops) -> list[dict]:
    """K1, K2 and K3 at the shapes phase 12 gives them and no earlier path
    did: K1 on 8 s and 15 s windows (128,000 and 240,000 samples); K2 on the
    encoder's T = 400 and 750 (neither a multiple of the bf16 tile: the
    ragged last Q and KV tiles); K3 at T_pad = 512 and 768 (400 and 750 real
    keys, quantize_cross_kv(pad_to=128)) for the bucket batches of 8 and the
    chunked batch of 32, and at T_pad = 1536 for the chunked batch of 32.
    Each against its plain version with phase 2's tolerances, timed as
    phase 2 times it, beside its bound."""
    from whisper_context_biasing_tpu_torch.audio.mel import log_mel_tail

    rows = []
    rng = np.random.default_rng(21)
    for seconds in BUCKETS:
        n = seconds * 16000
        clips = [synthetic_audio(rng, seconds - 1.5 * (i % 3)) for i in range(BATCH)]
        x = torch.from_numpy(np.stack([np.pad(a, (0, n - a.size)) for a in clips])).cuda()
        err = max_err(log_mel_tail(ops.mel_energies(x, N_MELS)),
                      log_mel_tail(ops.mel_energies_plain(x, N_MELS)))
        require(err <= 1e-4, f"mel kernel at {n} samples disagrees: {err}")
        frames = BATCH * (n // 160)
        n_bytes = 4 * (BATCH * n + frames * N_MELS)
        b_ms, b_by = bound(n_bytes, frames * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * 391),
                           PEAK_F32_FLOP_S)
        ms = median_ms(torch, lambda: ops.mel_energies(x, N_MELS))
        plain_ms = median_ms(torch, lambda: ops.mel_energies_plain(x, N_MELS))
        print(f"K1 mel {BATCH} x {n} ({seconds} s bucket): log-mel max |err| = {err:.3e} (atol "
              f"1e-4); {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
        rows.append(dict(kernel="mel", shape=f"{BATCH}x{n}", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms))
    for t in BUCKET_T.values():
        rows.append(check_flash_shape(torch, ops, rng, t))
    for b, t_pad, t in ((BATCH, 512, 400), (BATCH, 768, 750), (CHUNKED_BATCH, 512, 400),
                        (CHUNKED_BATCH, 768, 750), (CHUNKED_BATCH, T_PAD, T_AUDIO)):
        rows.append(check_quant_shape(torch, ops, rng, b, t_pad, t))
    return rows


def check_draft_shapes(torch, ops) -> list[dict]:
    """K2 and K3 at the width of phase 13's tiny.en draft (d 384, 6 heads of
    64, 4 decoder layers), which no earlier path gives them: K2 on its
    encoder's (8, 1500, 6 x 64), K3 on its (4, 8, 1536, 384) int8 cross K/V;
    each as ``check_bucket_shapes`` holds and times its shapes."""
    rng = np.random.default_rng(31)
    return [check_flash_shape(torch, ops, rng, T_AUDIO, DRAFT_D, DRAFT_HEADS),
            check_quant_shape(torch, ops, rng, BATCH, T_PAD, T_AUDIO, DRAFT_D, DRAFT_HEADS,
                              DRAFT_LAYERS)]


# phase 14: the widths of the acceptance sweep's models, (d, heads, decoder
# layers), that no earlier phase gives the kernels
WIDTHS = {"small.en": (768, 12, 12), "medium.en": (1024, 16, 24), "large-v3": (1280, 20, 32)}


def check_flash_bwd_shape(torch, ops, rng, t, d, heads) -> dict:
    """K4 on an encoder's full (BATCH, t, heads x 64) attention, f32 and bf16,
    on the forward's own output and logsumexp, against its plain version
    with phase 2's limits, timed beside its bound and SDPA's backward."""
    import torch.nn.functional as F

    dh, bh = d // heads, BATCH * heads
    f32 = [torch.from_numpy(rng.standard_normal((BATCH, t, d), np.float32)).cuda()
           .view(BATCH, t, heads, dh) for _ in range(4)]  # q, k, v, do
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (x.to(dtype) for x in f32)
        o, lse = ops.flash_attention_fwd_plain(q, k, v)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do)
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do)
        rel = 1e-4 if dtype == torch.float32 else 1e-2  # phase 2's limits
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, scale = max_err(g, w), w.float().abs().max().item()
            errs[dtype] = max(errs.get(dtype, 0.0), err / scale)
            require(err <= rel * scale, f"flash backward {dtype} at T={t}, {heads} heads "
                    f"{name} disagrees: {err} > {rel * scale}")
    n_ops = 10 * bh * t * t * dh
    b_ms, b_by = bound(2 * bh * dh * 8 * t + 4 * bh * t, n_ops, PEAK_BF16_FLOP_S)
    ms = median_ms(torch, lambda: ops.flash_attention_bwd(q, k, v, o, lse, do))
    plain_ms = median_ms(torch, lambda: ops.flash_attention_bwd_plain(q, k, v, o, lse, do))
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh)
    doh = do.transpose(1, 2)
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                          retain_graph=True))
    print(f"K4 flash bwd encoder ({BATCH}, {t}x{t}, {heads}x{dh}): max |err| / max |grad| f32 "
          f"{errs[torch.float32]:.2e} (1e-4), bf16 {errs[torch.bfloat16]:.2e} (1e-2); bf16 "
          f"{ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s of the 5 products (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, SDPA backward {lib_ms:.4f} ms)")
    return dict(kernel="flash_attention_bwd", shape=f"{BATCH}x{t}x{t}x{heads}",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                library_ms=lib_ms)


def check_width_shapes(torch, ops) -> list[dict]:
    """K2 and K3 at the widths of small.en, medium.en and large-v3 (12, 16
    and 20 heads of 64), which the acceptance sweep of phase 14 gives them:
    K2 on the encoder's (8, 1500, heads x 64), K3 on the (layers, 8, 1536, d)
    int8 cross K/V; and K4 at small.en's encoder shape (phase 14's config 3
    trains small.en). Each as ``check_bucket_shapes`` holds and times its
    shapes."""
    rng = np.random.default_rng(41)
    rows = []
    for name, (d, heads, layers) in WIDTHS.items():
        print(f"{name} width (d {d}, {heads} heads, {layers} decoder layers):")
        rows.append(check_flash_shape(torch, ops, rng, T_AUDIO, d, heads))
        rows.append(check_quant_shape(torch, ops, rng, BATCH, T_PAD, T_AUDIO, d, heads, layers))
        if name == "small.en":
            rows.append(check_flash_bwd_shape(torch, ops, rng, T_AUDIO, d, heads))
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 12: the rest of serving
# ---------------------------------------------------------------------------

RECORDING_S = 300.0


class CallRecorder:
    """Calls of a function of the port, and the host seconds spent in them,
    wherever a module of the package holds it (``encode_audio`` is imported
    by name into several): ``with CallRecorder("decode.word_timestamps",
    "dtw_path") as rec: ...; rec.calls, rec.seconds``."""

    def __init__(self, module: str, name: str):
        import importlib

        self.fn = getattr(importlib.import_module(f"whisper_context_biasing_tpu_torch.{module}"),
                          name)
        self.name, self.calls, self.seconds = name, 0, 0.0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            t = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t

        self.patched = [m for n, m in list(sys.modules.items())
                        if n.startswith("whisper_context_biasing_tpu_torch")
                        and getattr(m, self.name, None) is self.fn]
        for m in self.patched:
            setattr(m, self.name, counted)
        return self

    def __exit__(self, *exc):
        for m in self.patched:
            setattr(m, self.name, self.fn)


class PathRecorder:
    """Decode calls (with their steps, tokens and top-2 gaps) and encoder
    passes of everything inside, wherever the package calls
    ``greedy_decode`` or ``encode_audio`` from."""

    def __init__(self, margins: bool = False):
        self.margins = margins

    def __enter__(self):
        from whisper_context_biasing_tpu_torch.decode import greedy

        self.enc = CallRecorder("models.whisper", "encode_audio").__enter__()
        self.fn = greedy.greedy_decode
        self.calls: list[dict] = []

        def recorded(*a, timings=None, **kw):
            t = {} if timings is None else timings  # the caller's dict, when it passes one
            res = self.fn(*a, timings=t, return_margins=self.margins, **kw)
            self.calls.append(dict(steps=t["steps"], tokens=res.tokens.cpu().numpy(),
                                   margins=None if res.margins is None
                                   else res.margins.cpu().numpy()))
            return res
        recorded.cache_size = self.fn.cache_size  # evaluate_wer's signature diagnostic

        self.patched = [m for n, m in list(sys.modules.items())
                        if n.startswith("whisper_context_biasing_tpu_torch")
                        and getattr(m, "greedy_decode", None) is self.fn]
        for m in self.patched:
            m.greedy_decode = recorded
        return self

    def __exit__(self, *exc):
        for m in self.patched:
            m.greedy_decode = self.fn
        self.enc.__exit__(*exc)

    @property
    def steps(self) -> int:
        return sum(c["steps"] for c in self.calls)

    def implied(self, mel_calls: int) -> dict:
        """The launches the run implies: K1 one a mel call, K2 six an
        encoder pass, K3 six a decode step."""
        return {"mel": mel_calls, "flash_attention": N_LAYERS * self.enc.calls,
                "quant_cross_attention": N_LAYERS * self.steps}


def counted_mel(pipe) -> list:
    """Count ``pipe.mel`` calls (the window batches): returns the list the
    calls' batch sizes go into."""
    calls = []
    real = pipe.mel

    def mel(stacked):
        calls.append(stacked.shape[0])
        return real(stacked)

    pipe.mel = mel
    return calls


def same_calls(kcalls, pcalls, label) -> bool:
    """Kernel vs plain decode calls: identical tokens in as many calls, or
    the first divergence at a top-2 logit gap < 1e-4 (then False, and the
    rest, which that divergence may steer, is not compared)."""
    for ci, (kc, pc) in enumerate(zip(kcalls, pcalls)):
        diff = np.argwhere(kc["tokens"] != pc["tokens"])
        if diff.size:
            row, step = (int(x) for x in diff[0])
            gap = pc["margins"][row, step]
            print(f"  {label}: decode call {ci} row {row} diverges at step {step}, plain top-2 "
                  f"logit gap {gap:.3e} (passes only if < 1e-4)")
            require(gap < 1e-4, f"{label}: kernels vs plain diverge at call {ci}")
            return False
    require(len(kcalls) == len(pcalls), f"{label}: {len(kcalls)} vs {len(pcalls)} decode calls")
    return True


def words_ok(words, seconds: float, monotone: bool = True) -> bool:
    starts = [w.start for w in words]
    inside = all(0.0 <= w.start <= w.end <= seconds + 1e-6 for w in words)
    return inside and (not monotone or starts == sorted(starts))


def chunked_clips():
    """The 300 s recording (seed 13) and phase 11's 75 s and 48 s clips."""
    rng = np.random.default_rng(11)
    return [synthetic_audio(np.random.default_rng(13), RECORDING_S)] + [
        synthetic_audio(rng, s) for s in LONG_CLIPS_S]


def chunked_batch(torch, Pipeline, ops, card):
    """(a) ``long_form="chunked"``, timestamps, the default ladder, a
    context and 3 bias words, 64 tokens a window, ``chunked_batch=32`` on the
    300 s recording and phase 11's clips, bf16 with every kernel."""
    from whisper_context_biasing_tpu_torch.decode import chunk_layout

    clips = chunked_clips()
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    mel_calls = counted_mel(pipe)
    windows = sum(len(chunk_layout(c.size, pipe.window_samples)) for c in clips)
    kwargs = dict(long_form="chunked", chunked_batch=CHUNKED_BATCH, timestamps=True,
                  window_info=True, context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                  max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PathRecorder() as rec:
        res = pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    want = rec.implied(len(mel_calls))
    audio_s = sum(c.size for c in clips) / 16000.0
    rungs = [w["temperature"] for r in res for w in r.windows]
    print(f"(a) chunked long-form (base.en bf16, clips of {RECORDING_S:.0f}, {LONG_CLIPS_S} s, "
          f"timestamps, the ladder 0.0-1.0, chunked_batch {CHUNKED_BATCH}, {MAX_TOKENS} tokens a "
          f"window) on {card}:")
    print(f"  {windows} windows ({[len(r.windows) for r in res]} a clip) in {len(mel_calls)} "
          f"window batches of {mel_calls} rows; {len(rec.calls)} decode calls, {rec.steps} "
          f"decode steps, {rec.enc.calls} encoder passes; rungs reached {sorted(set(rungs))}")
    print(f"  wall {wall * 1e3:.1f} ms = {audio_s / wall:.1f} audio-s/s, wall / decode steps "
          f"{wall * 1e3 / max(rec.steps, 1):.2f} ms  [{card}]")
    print(f"  launches {counts} (the run implies {want})")
    print(f"  segments per clip {[len(r.segments) for r in res]}; tokens per clip "
          f"{[len(r.tokens) for r in res]}")
    require(counts == want and rec.enc.calls == len(rec.calls),
            f"chunked launches {counts} != {want}")
    require(sum(len(r.windows) for r in res) == windows, "(a) a window has no window info")
    for r, c in zip(res, clips):
        require(all(0.0 <= a <= e <= c.size / 16000.0 + 30.0 for a, e, _ in r.segments),
                "(a) a segment outside its clip")
    return counts, clips


def chunked_f32_gate(torch, Pipeline, ops, clips):
    """(b) (a)'s route at temperature 0 in f32 with word timestamps, the
    kernels against their plain versions (by config, and the plain mel
    frontend): tokens, segments and words identical (a divergence passes
    only at a top-2 logit gap < 1e-4)."""
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram

    runs = []
    for kernels in (True, False):
        over = {} if kernels else dict(flash_attention=False, fused_quant_cross=False)
        pipe = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32", config_overrides=over)
        if not kernels:
            pipe.mel = lambda stacked, pipe=pipe: log_mel_spectrogram(
                torch.as_tensor(stacked, device=DEVICE), n_mels=pipe.cfg.n_mels)
        ops.reset_launch_counts()
        with PathRecorder(margins=True) as rec:
            res = pipe.transcribe(clips, long_form="chunked", chunked_batch=CHUNKED_BATCH,
                                  timestamps=True, word_timestamps=True, temperatures=(0.0,),
                                  context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                                  max_tokens=MAX_TOKENS)
        counts = dict(ops.launches)
        require(bool(counts) == kernels, f"(b) f32 {'kernel' if kernels else 'plain'} run "
                f"launches {counts}")
        runs.append((res, rec.calls, counts))
        del pipe
    (kres, kcalls, kc), (pres, pcalls, _) = runs
    print(f"(b) f32 chunked with word timestamps, kernels (launches {kc}) vs plain versions: "
          f"{len(kcalls)} decode calls each")
    if not same_calls(kcalls, pcalls, "(b)"):
        return
    words = [[(w.word, w.start, w.end) for w in r.words] for r in kres]
    same = ([r.tokens for r in kres] == [r.tokens for r in pres]
            and [r.segments for r in kres] == [r.segments for r in pres]
            and words == [[(w.word, w.start, w.end) for w in r.words] for r in pres])
    print(f"  tokens, segments and words identical: {same} ({sum(map(len, words))} words; "
          f"monotone and inside each clip: "
          f"{all(words_ok(r.words, c.size / 16000.0) for r, c in zip(kres, clips))})")
    require(same, "(b) f32 chunked results differ between the kernels and the plain versions")
    require(all(words_ok(r.words, c.size / 16000.0) for r, c in zip(kres, clips)),
            "(b) chunked word times are not monotone inside their clip")


def word_timestamps_runs(torch, Pipeline, ops, card):
    """(c) short-form ``word_timestamps=True`` on phase 3's 8 requests (K2
    twice: the alignment's encoder pass and the decode's) and long-form word
    timestamps on the 75 s clip at t=0, bf16: word times inside each clip,
    monotone in short-form; the alignment pass's ms."""
    clips = requests(np.random.default_rng(4))
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS,
                  word_timestamps=True)
    pipe.transcribe(clips, **kwargs)  # warm-up
    mel_calls = counted_mel(pipe)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PathRecorder() as rec, CallRecorder("decode.word_timestamps", "dtw_path") as dtw, \
            CallRecorder("decode.word_timestamps", "split_words") as split:
        res = pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tm = dict(ops.launches), pipe.last_timings
    want = rec.implied(len(mel_calls))
    ok = all(words_ok(r.words, c.size / 16000.0) for r, c in zip(res, clips))
    print(f"(c) short-form word timestamps ({BATCH} requests, bf16): encoder {tm['encode_ms']:.3f} "
          f"ms, decode {tm['decode_ms'] / max(tm['steps'], 1):.3f} ms/step, alignment pass "
          f"{tm['align_ms']:.3f} ms (CUDA events: the teacher-forced pass, then on the host "
          f"the DTW {dtw.seconds * 1e3:.3f} ms and the word split {split.seconds * 1e3:.3f} ms), "
          f"wall {wall * 1e3:.1f} ms  [{card}]")
    print(f"  words per request {[len(r.words) for r in res]}; monotone and inside each clip: "
          f"{ok}; launches {counts} (the run implies {want}, {rec.enc.calls} encoder passes)")
    require(counts == want and rec.enc.calls == 2, f"(c) short-form launches {counts} != {want}")
    require(ok and all(r.words and r.segments for r in res), "(c) short-form words out of order")
    total = dict(counts)
    clip = chunked_clips()[1]
    mel_calls.clear()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PathRecorder() as rec:
        r = pipe.transcribe(clip, word_timestamps=True, timestamps=True, temperatures=(0.0,),
                            window_info=True, max_tokens=MAX_TOKENS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    want = rec.implied(len(mel_calls))
    inside = words_ok(r.words, clip.size / 16000.0, monotone=False)
    print(f"  long-form word timestamps (the 75 s clip, t=0): {len(r.windows)} windows, "
          f"{len(rec.calls)} decode calls, {rec.enc.calls} encoder passes, {len(r.words)} words, "
          f"wall {wall * 1e3:.1f} ms; inside the clip: {inside}, monotone: "
          f"{words_ok(r.words, clip.size / 16000.0)}; launches {counts} (implies {want})  [{card}]")
    require(counts == want, f"(c) long-form launches {counts} != {want}")
    require(inside and r.words, "(c) long-form word times outside the clip")
    return {k: total.get(k, 0) + counts.get(k, 0) for k in set(total) | set(counts)}


def bucketed(torch, Pipeline, ops, card):
    """(d) ``window_buckets=(8, 15)`` on phase 3's requests, bf16: launches
    and encoder ms per bucket beside the unbucketed call's; then f32 with the
    kernels against their plain versions: identical tokens."""
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram

    clips = requests(np.random.default_rng(4))
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS)
    pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    whole_wall = time.perf_counter() - t0
    whole = pipe.last_timings
    pipe.transcribe(clips, window_buckets=BUCKETS, **kwargs)  # warm-up
    per_bucket = []
    real_short = pipe._short_form

    def watched(clips_, idxs, win, **kw):
        before = dict(ops.launches)
        out = real_short(clips_, idxs, win, **kw)
        per_bucket.append((win, {k: v - before.get(k, 0) for k, v in ops.launches.items()}))
        return out

    pipe._short_form = watched
    mel_calls = counted_mel(pipe)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PathRecorder() as rec:
        res = pipe.transcribe(clips, window_buckets=BUCKETS, **kwargs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    want = rec.implied(len(mel_calls))
    buckets = pipe.last_timings["buckets"]
    print(f"(d) window_buckets={BUCKETS} on phase 3's {BATCH} requests (bf16): wall "
          f"{wall * 1e3:.1f} ms; unbucketed right before: wall {whole_wall * 1e3:.1f} ms, encoder "
          f"{whole['encode_ms']:.3f} ms, decode {whole['decode_ms'] / max(whole['steps'], 1):.3f} "
          f"ms/step  [{card}]")
    for (win, launches), (w2, tm) in zip(per_bucket, sorted(buckets.items())):
        print(f"  bucket {win / 16000:.0f} s: {tm['clips']} clips in {tm['rows']} rows, encoder "
              f"{tm['encode_ms']:.3f} ms, mel {tm['mel_ms']:.3f} ms, decode "
              f"{tm['decode_ms'] / max(tm['steps'], 1):.3f} ms/step over {tm['steps']} steps; "
              f"launches {launches}")
    print(f"  launches {counts} (the run implies {want}); tokens per request "
          f"{[len(r.tokens) for r in res]}")
    require(counts == want and len(mel_calls) == len(buckets) == rec.enc.calls,
            f"(d) bucketed launches {counts} != {want}")
    require(sorted(buckets) == [128000, 240000, 480000], f"(d) buckets {sorted(buckets)}")
    del pipe
    runs = []
    for kernels in (True, False):
        over = {} if kernels else dict(flash_attention=False, fused_quant_cross=False)
        pipe = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32", config_overrides=over)
        if not kernels:
            pipe.mel = lambda stacked, pipe=pipe: log_mel_spectrogram(
                torch.as_tensor(stacked, device=DEVICE), n_mels=pipe.cfg.n_mels)
        ops.reset_launch_counts()
        with PathRecorder(margins=True) as rec:
            out = pipe.transcribe(clips, window_buckets=BUCKETS, **kwargs)
        c = dict(ops.launches)
        require(bool(c) == kernels, f"(d) f32 {'kernel' if kernels else 'plain'} run launches {c}")
        runs.append(([r.tokens for r in out], rec.calls))
        del pipe
    if same_calls(runs[0][1], runs[1][1], "(d) f32 bucketed"):
        require(runs[0][0] == runs[1][0], "(d) f32 bucketed tokens differ")
        print(f"  f32 bucketed, kernels vs plain versions: tokens identical over "
              f"{len(runs[0][1])} bucket batches")
    return counts


def streaming(torch, Pipeline, ops, card):
    """(e) ``StreamingTranscriber`` (``Pipeline.stream``) on the 75 s clip fed
    in 1 s chunks, timestamps, t=0, bf16: the tokens of
    ``transcribe_long_batch`` on the same clip."""
    from whisper_context_biasing_tpu_torch.decode import transcribe_long_batch

    clip = chunked_clips()[1]
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    tok = pipe.tokenizer
    want = transcribe_long_batch(pipe.model, tok, [clip], mel_fn=pipe.mel, max_new=MAX_TOKENS,
                                 use_timestamps=True, temperatures=(0.0,),
                                 prefix_pad_to_multiple=32, return_segments=True,
                                 window_samples=pipe.window_samples, device=DEVICE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = pipe.stream(max_new=MAX_TOKENS, use_timestamps=True, temperatures=(0.0,))
    lat = []
    for i in range(0, clip.size, 16000):
        t1 = time.perf_counter()
        st.feed(clip[i: i + 16000])
        lat.append(time.perf_counter() - t1)
    st.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    same = st.tokens == want[0][0] and st.segments == want[1][0]
    print(f"(e) streaming the 75 s clip in 1 s chunks (bf16, t=0): {len(st.window_info)} windows, "
          f"tokens and segments identical to transcribe_long_batch: {same}; wall {wall:.2f} s, "
          f"feed calls {len(lat)} (slowest {max(lat) * 1e3:.1f} ms, median "
          f"{statistics.median(lat) * 1e3:.2f} ms); launches {counts}  [{card}]")
    require(same and st.tokens, "(e) the stream's tokens differ from transcribe_long_batch's")
    return counts


def serve_cli(torch, ops, card, init_path):
    """(f) ``cli.serve`` on 127.0.0.1:0 from phase 10's model.safetensors
    (batch 8, a 250 ms micro-batch window, timestamps, t=0): 8 concurrent
    WAV posts in one micro-batch, a 75 s post, a word-timestamp post (each
    lone post waits out the window), a stream session, /health."""
    import http.client
    import io
    import threading
    import wave

    from whisper_context_biasing_tpu_torch.cli import serve

    def wav(audio):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    args = serve.parse_args(["--init_checkpoint", str(init_path), "--host", "127.0.0.1",
                             "--port", "0", "--batch", str(BATCH), "--max_wait_ms", "250",
                             "--max_tokens", str(MAX_TOKENS), "--timestamps", "--temperatures",
                             "0.0", "--bias_words", *BIAS_WORDS, "--bias_boost", "2.0",
                             "--device", DEVICE])
    t0 = time.perf_counter()
    engine, server = serve.make_server(args)
    start_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address

    def call(method, path, body=b"", headers=None):
        c = http.client.HTTPConnection(*addr, timeout=600)
        t = time.perf_counter()
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        out = json.loads(r.read())
        c.close()
        return r.status, out, (time.perf_counter() - t) * 1e3

    try:
        clips = requests(np.random.default_rng(4))
        long_clip = chunked_clips()[1]
        ops.reset_launch_counts()
        replies = [None] * BATCH

        def post(i):
            replies[i] = call("POST", "/transcribe", wav(clips[i]), {"X-Context": CONTEXT})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batch = engine.batches[-1]
        long_reply = call("POST", "/transcribe", wav(long_clip), {"X-Window-Info": "1"})
        word_reply = call("POST", "/transcribe", wav(clips[2]), {"X-Word-Timestamps": "1"})
        status, out, _ = call("POST", "/stream", headers={"X-Context": CONTEXT})
        sid = out["session"]
        pcm = (np.clip(long_clip, -1, 1) * 32767).astype("<i2")
        feeds = [call("POST", f"/stream/{sid}", pcm[i: i + 16000].tobytes())
                 for i in range(0, pcm.size, 16000)]
        end = call("POST", f"/stream/{sid}/end")
        health = call("GET", "/health")
        torch.cuda.synchronize()
        counts = dict(ops.launches)
    finally:
        server.shutdown()
        engine.close()
        thread.join()
    statuses = ([r[0] for r in replies] + [long_reply[0], word_reply[0], status, end[0],
                                           health[0]] + [f[0] for f in feeds])
    print(f"(f) cli.serve (started in {start_s:.1f} s with its warm-up) on "
          f"{addr[0]}:{addr[1]}: 8 concurrent posts in one micro-batch of {batch}, latencies "
          f"{[round(r[2]) for r in replies]} ms; the 75 s post {long_reply[2]:.0f} ms "
          f"({len(long_reply[1].get('windows', []))} windows); the word-timestamp post "
          f"{word_reply[2]:.0f} ms ({len(word_reply[1].get('words', []))} words); the stream "
          f"session {len(feeds)} feeds (slowest {max(f[2] for f in feeds):.0f} ms), end "
          f"{end[2]:.0f} ms, {len(end[1]['text'])} characters; /health {health[1]}; the server's "
          f"RTF meter {engine.rtf.rtf:.1f} (audio s / wall s over its batches)  [{card}]")
    print(f"  launches {counts}")
    require(all(s == 200 for s in statuses), f"(f) the server answered {statuses}")
    require(batch == BATCH, f"(f) the 8 concurrent posts ran in a batch of {batch}")
    require(word_reply[1].get("words") and long_reply[1].get("windows"),
            "(f) the word or window fields are missing")
    return counts


def rest_of_serving(torch, Pipeline, ops, card, init_path):
    """Phase 12; returns the launches of its bf16 runs, summed."""
    start = time.perf_counter()
    runs = []
    counts, clips = chunked_batch(torch, Pipeline, ops, card)
    runs.append(counts)
    chunked_f32_gate(torch, Pipeline, ops, clips)
    runs.append(word_timestamps_runs(torch, Pipeline, ops, card))
    runs.append(bucketed(torch, Pipeline, ops, card))
    runs.append(streaming(torch, Pipeline, ops, card))
    runs.append(serve_cli(torch, ops, card, init_path))
    print(f"  phase 12 took {time.perf_counter() - start:.1f} s  [{card}]")
    return {k: sum(c.get(k, 0) for c in runs) for k in set().union(*runs)}


# ---------------------------------------------------------------------------
# phase 13: speculative and Medusa decoding
# ---------------------------------------------------------------------------

def timed_transcribe(torch, pipe, ops, clips, kwargs):
    """A warm-up ``transcribe``, then one timed: (results, launches,
    ``last_timings``, wall s)."""
    pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.transcribe(clips, **kwargs)
    torch.cuda.synchronize()
    return res, dict(ops.launches), dict(pipe.last_timings), time.perf_counter() - t0


def emitted_per_round(res, rounds: int) -> float:
    """Tokens a row emits a verify round after its first (the eot counts):
    the correction plus the accepted proposals, averaged over rows and
    rounds (a row that has finished idles through the rest)."""
    emitted = [min(len(r.tokens) + 1, MAX_TOKENS) - 1 for r in res]
    return sum(emitted) / (len(res) * max(rounds, 1))


def divergences(got, plain, margins) -> list[tuple[int, int, float]]:
    """(row, step, plain top-2 logit gap there) of each row whose tokens
    differ from plain greedy's, at its first differing step (the rest of the
    row, which the divergence may steer, is not compared)."""
    out = []
    for i, (g, p) in enumerate(zip(got, plain)):
        if g != p:
            s = next(j for j in range(len(g) + 1) if j == len(g) or j == len(p) or g[j] != p[j])
            out.append((i, s, float(margins[i, s])))
    return out


def bf16_agreement(label, got, plain, margins) -> str:
    """A bf16 run's rows against plain greedy's: identical, or each first
    divergence at a plain top-2 logit gap < BF16_TIE; returns what it found."""
    div = divergences(got, plain, margins)
    for i, _, gap in div:
        require(gap < BF16_TIE, f"{label}: bf16 row {i} differs from plain greedy at a top-2 "
                f"gap of {gap:.3e} >= {BF16_TIE:.3e}")
    return (f"rows identical to plain greedy's {len(plain) - len(div)}/{len(plain)}"
            + "".join(f"; row {i} from step {s} (plain top-2 gap {gap:.3e})"
                      for i, s, gap in div))


def token_rows(tokens: np.ndarray, eot: int) -> list[list[int]]:
    """(B, max_new) eot-padded decode output -> each row's tokens before eot."""
    return [row[: int(np.argmax(row == eot)) if (row == eot).any() else len(row)].tolist()
            for row in tokens]


def same_as_plain(label, got, plain, margins) -> bool:
    """Rows of tokens against plain greedy's: identical, or the first
    divergence at a plain top-2 logit gap < 1e-4 (phase 11's rule)."""
    div = divergences(got, plain, margins)
    for i, s, gap in div:
        print(f"  {label}: row {i} diverges from plain greedy at step {s}, plain top-2 logit "
              f"gap {gap:.3e} (passes only if < 1e-4)")
        require(gap < 1e-4, f"{label}: row {i} differs from plain greedy")
    return not div


def write_wavs(root, clips) -> list[str]:
    import wave

    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, clip in enumerate(clips):
        paths.append(str(root / f"req{i}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(clip, -1, 1) * 32767).astype(np.int16).tobytes())
    return paths


def speculative_serving(torch, Pipeline, ops, card):
    """(a) phase 3's requests with a random tiny.en draft, k = 4, bf16 with
    every kernel: rounds, tokens a round, ms a round beside plain greedy's ms
    a step on the same target, exactly K1 1, K2 10, K3 4 x 5 x rounds; (b)
    the target as its own draft: K2 12, K3 6 x 5 x rounds; then in f32 with
    the kernels, held to plain greedy's tokens; (c) Medusa with 4 untrained
    heads at 1 and 3 chains: K1 1, K2 6, K3 0, and in f32 as (b). Returns the
    bf16 runs' launches, summed, and the f32 pipeline."""
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    clips = requests(np.random.default_rng(4))
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    pipe = Pipeline("base.en", device=DEVICE, seed=0, draft_model=DRAFT, speculative_k=SPEC_K)
    dcfg = pipe.draft_cfg
    require((dcfg.d_model, dcfg.n_heads, dcfg.n_text_layers) == (DRAFT_D, DRAFT_HEADS,
                                                                 DRAFT_LAYERS)
            and dcfg.fused_quant_cross and dcfg.flash_attention, f"the draft config {dcfg}")
    draft = pipe.draft
    pipe.draft = None  # plain greedy on the same target, beside it
    _, plain_counts, plain_tm, plain_wall = timed_transcribe(torch, pipe, ops, clips, kwargs)
    with PathRecorder(margins=True) as rec:
        plain = [r.tokens for r in pipe.transcribe(clips, **kwargs)]
    margins = rec.calls[0]["margins"]
    step_ms = plain_tm["decode_ms"] / max(plain_tm["steps"], 1)
    add(plain_counts)
    print(f"(a) speculative decoding, base.en target, random {DRAFT} draft (d {DRAFT_D}, "
          f"{DRAFT_HEADS} heads, {DRAFT_LAYERS} layers), k = {SPEC_K}, phase 3's {BATCH} "
          f"requests, bf16 with every kernel, on {card}:")
    print(f"  plain greedy on the same target right before: decode {step_ms:.3f} ms/step over "
          f"{plain_tm['steps']} steps, wall {plain_wall * 1e3:.1f} ms")
    for label, dmodel, dlayers in (("(a) random draft", draft, DRAFT_LAYERS),
                                   ("(b) self-draft", pipe.model, N_LAYERS)):
        if dmodel is pipe.model:  # the API's own self-draft: a Whisper as draft_params
            del pipe
            pipe = Pipeline("base.en", device=DEVICE, seed=0, draft_model="base.en",
                            speculative_k=SPEC_K, draft_params=dmodel)
        else:
            pipe.draft = dmodel
        res, counts, tm, wall = timed_transcribe(torch, pipe, ops, clips, kwargs)
        rounds = tm["rounds"]
        want = {"mel": 1, "flash_attention": N_LAYERS + dlayers,
                "quant_cross_attention": dlayers * (SPEC_K + 1) * rounds}
        per_round = emitted_per_round(res, rounds)
        print(f"  {label}: {rounds} rounds, {per_round:.2f} tokens a row a round "
              f"({per_round - 1:.2f} accepted drafts), decode "
              f"{tm['decode_ms'] / max(rounds, 1):.3f} ms a round = "
              f"{tm['decode_ms'] / max(rounds, 1) / max(per_round, 1e-9):.3f} ms a token "
              f"(plain: {step_ms:.3f} ms a step), encoders + prefills {tm['encode_ms']:.3f} ms, "
              f"wall {wall * 1e3:.1f} ms  [{card}]")
        print(f"    launches {counts} (the run implies {want}); bf16 "
              f"{bf16_agreement(label, [r.tokens for r in res], plain, margins)}")
        require(counts == want, f"{label} launches {counts} != {want}")
        add(counts)
    pipe.draft = pipe.draft_cfg = None

    # (c) Medusa, untrained heads, 1 and 3 chains, on the same target
    heads = init_medusa_params(pipe.cfg, MEDUSA_HEADS, 0)
    mpipe = Pipeline("base.en", device=DEVICE, seed=0, medusa=heads, medusa_chains=1)
    for chains in (1, 3):
        mpipe.medusa["n_chains"] = chains
        res, counts, tm, wall = timed_transcribe(torch, mpipe, ops, clips, kwargs)
        rounds = tm["rounds"]
        per_round = emitted_per_round(res, rounds)
        want = {"mel": 1, "flash_attention": N_LAYERS}
        print(f"(c) Medusa, {MEDUSA_HEADS} untrained heads, {chains} chain(s) (verify S = "
              f"{1 + chains * MEDUSA_HEADS}): {rounds} rounds, {per_round:.2f} tokens a row a "
              f"round, decode {tm['decode_ms'] / max(rounds, 1):.3f} ms a round, wall "
              f"{wall * 1e3:.1f} ms; launches {counts} (the run implies {want}); bf16 "
              f"{bf16_agreement(f'(c) {chains} chain(s)', [r.tokens for r in res], plain, margins)}"
              f"  [{card}]")
        require(counts == want, f"(c) Medusa launches {counts} != {want}")
        add(counts)
    del mpipe, pipe

    # f32 with the kernels: each accelerator held to plain greedy's tokens
    p32 = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32")
    with PathRecorder(margins=True) as rec:
        plain = [r.tokens for r in p32.transcribe(clips, **kwargs)]
    margins = rec.calls[0]["margins"]
    for label, attrs in (("(b) f32 self-draft", dict(draft=p32.model, draft_cfg=p32.cfg)),
                         ("(c) f32 Medusa 1 chain", dict(medusa=dict(heads, n_chains=1))),
                         ("(c) f32 Medusa 3 chains", dict(medusa=dict(heads, n_chains=3)))):
        for k, v in attrs.items():
            setattr(p32, k, v)
        ops.reset_launch_counts()
        got = [r.tokens for r in p32.transcribe(clips, **kwargs)]
        counts = dict(ops.launches)
        require(counts.get("flash_attention", 0) > 0 and counts.get("mel", 0) > 0,
                f"{label} never launched the kernels: {counts}")
        same = same_as_plain(label, got, plain, margins)
        print(f"  {label}, kernels (launches {counts}) vs plain greedy: tokens identical: "
              f"{same} ({p32.last_timings['rounds']} rounds)")
        p32.draft = p32.draft_cfg = p32.medusa = None
    return total, p32, heads


def medusa_entry_points(torch, ops, card, init_path, tmp):
    """(d) ``cli.medusa`` from phase 10's ``model.safetensors`` on phase 10's
    corpus (2 steps of batch 8, a dev probe): its files, the head accuracies,
    the expected tokens a round and exactly K2 6 an encoder pass (12 more a
    forward whose labels reach ``flash_decoder_min_seq``); then
    ``cli.transcribe --medusa`` and ``--draft_model tiny.en`` on phase 3's
    requests as WAVs, and ``cli.serve --medusa`` on one post: the plain
    CLI's and server's text. Returns cli.medusa's launches."""
    import contextlib
    import http.client
    import io
    import pathlib
    import threading

    from whisper_context_biasing_tpu_torch.cli import medusa as medusa_cli
    from whisper_context_biasing_tpu_torch.cli import serve, transcribe
    from whisper_context_biasing_tpu_torch.models import get_config
    from whisper_context_biasing_tpu_torch.train import medusa as medusa_train

    root = pathlib.Path(tmp)
    corpus, out = root / "corpus", root / "medusa"
    seqs = []
    real = medusa_train.forward_hidden

    def recorded(model, feats, ids):
        seqs.append(ids.shape[1])
        return real(model, feats, ids)

    medusa_train.forward_hidden = recorded
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        medusa_cli.main(["--data_root", str(corpus), "--data_dir", "audio", "--jsonl_data",
                         str(corpus / "jsonl"), "--init_checkpoint", str(init_path),
                         "--output", str(out), "--prompt", "--medusa_heads", str(MEDUSA_HEADS),
                         "--batch", str(BATCH), "--epoch", "1", "--warmup_steps", "0",
                         "--eval_steps", "2", "--logging_steps", "1", "--eval_batches", "1",
                         "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        medusa_train.forward_hidden = real
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    min_seq = get_config("base.en").flash_decoder_min_seq
    want = {"flash_attention": sum(N_LAYERS + (2 * N_LAYERS if s >= min_seq else 0)
                                   for s in seqs)}
    summary = json.loads((out / "medusa_results.json").read_text())
    print(f"(d) cli.medusa ({MEDUSA_HEADS} heads, 2 steps of batch {BATCH} and a dev probe, "
          f"labels of {sorted(set(seqs))} tokens): dev head accuracy "
          f"{summary['eval_head_acc']}, expected {summary['eval_tokens_per_round']} tokens a "
          f"round, wall {wall:.2f} s; launches {counts} ({len(seqs)} frozen forwards imply "
          f"{want})  [{card}]")
    require(counts == want, f"(d) cli.medusa launches {counts} != {want}")
    require((out / "medusa.npz").is_file() and summary["n_heads"] == MEDUSA_HEADS,
            "(d) cli.medusa wrote no heads")

    paths = write_wavs(root / "requests", requests(np.random.default_rng(4)))

    def cli(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hyps = transcribe.main(["--audio", *paths, "--init_checkpoint", str(init_path),
                                    "--max_tokens", str(MAX_TOKENS), "--context", CONTEXT,
                                    "--bias_words", *BIAS_WORDS, "--bias_boost", "2.0",
                                    "--device", DEVICE, *extra])
        return hyps, buf.getvalue().splitlines()

    t0 = time.perf_counter()
    with PathRecorder(margins=True) as rec:
        (plain_hyps, plain) = cli()
    margins = rec.calls[0]["margins"]
    t1 = time.perf_counter()
    medusa_hyps, by_medusa = cli("--medusa", str(out / "medusa.npz"))
    t2 = time.perf_counter()
    draft_hyps, by_draft = cli("--draft_model", DRAFT, "--spec_k", str(SPEC_K))
    t3 = time.perf_counter()
    print(f"  cli.transcribe on {len(paths)} WAVs: plain {t1 - t0:.2f} s, --medusa {t2 - t1:.2f} "
          f"s, --draft_model {DRAFT} {t3 - t2:.2f} s (each with its model builds); the same "
          f"text as the plain CLI: --medusa {by_medusa == plain} (bf16 "
          f"{bf16_agreement('(d) --medusa', medusa_hyps, plain_hyps, margins)}), --draft_model "
          f"{by_draft == plain} (bf16 "
          f"{bf16_agreement('(d) --draft_model', draft_hyps, plain_hyps, margins)})  [{card}]")
    require(len(plain) == len(paths), "(d) cli.transcribe printed no line a file")

    args = serve.parse_args(["--init_checkpoint", str(init_path), "--host", "127.0.0.1",
                             "--port", "0", "--batch", str(BATCH), "--max_tokens",
                             str(MAX_TOKENS), "--medusa", str(out / "medusa.npz"),
                             "--device", DEVICE])
    engine, server = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = open(paths[2], "rb").read()

    def post():
        c = http.client.HTTPConnection(*server.server_address, timeout=600)
        c.request("POST", "/transcribe", body=body, headers={"X-Context": CONTEXT})
        r = c.getresponse()
        reply = (r.status, json.loads(r.read()))
        c.close()
        return reply

    batches = []
    real_medusa = serve.medusa_decode_batch

    def recorded(*a, **kw):
        batches.append(real_medusa(*a, **kw))
        return batches[-1]

    serve.medusa_decode_batch = recorded
    try:
        with_heads = post()
        engine.medusa = None
        with PathRecorder(margins=True) as rec:
            without = post()
    finally:
        serve.medusa_decode_batch = real_medusa
        server.shutdown()
        engine.close()
        thread.join()
    plain_rows = token_rows(rec.calls[0]["tokens"], engine.tokenizer.eot)
    agreement = bf16_agreement("(d) cli.serve --medusa", batches[0], plain_rows,
                               rec.calls[0]["margins"])
    print(f"  cli.serve --medusa, one post: {with_heads[0]}, the same text as without the "
          f"heads: {with_heads[1]['text'] == without[1]['text']} (its micro-batch of "
          f"{len(plain_rows)} rows, bf16 {agreement}; {with_heads[1]['latency_ms']:.0f} ms with, "
          f"{without[1]['latency_ms']:.0f} ms without)  [{card}]")
    require(with_heads[0] == without[0] == 200, "(d) cli.serve --medusa did not answer")
    return counts


def long_form_accelerated(torch, p32, heads, card):
    """(e) phase 11's 75 s and 48 s clips at t=0 in f32 with the kernels,
    sequential and chunked long-form, with the target as its own draft and
    with the Medusa heads: tokens and segments equal the plain run's."""
    rng = np.random.default_rng(11)
    clips = [synthetic_audio(rng, s) for s in LONG_CLIPS_S]
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, temperatures=(0.0,),
                  max_tokens=MAX_TOKENS)
    for route in ("sequential", "chunked"):
        kw = dict(kwargs, long_form=True) if route == "sequential" else dict(
            kwargs, long_form="chunked", chunked_batch=CHUNKED_BATCH)
        t0 = time.perf_counter()
        plain = p32.transcribe(clips, **kw)
        walls = [time.perf_counter() - t0]
        same = []
        for attrs in (dict(draft=p32.model, draft_cfg=p32.cfg),
                      dict(medusa=dict(heads, n_chains=1))):
            for k, v in attrs.items():
                setattr(p32, k, v)
            t0 = time.perf_counter()
            got = p32.transcribe(clips, **kw)
            walls.append(time.perf_counter() - t0)
            p32.draft = p32.draft_cfg = p32.medusa = None
            same.append([r.tokens for r in got] == [r.tokens for r in plain]
                        and [r.segments for r in got] == [r.segments for r in plain])
        n_tokens = sum(len(r.tokens) for r in plain)
        print(f"(e) f32 {route} long-form at t=0: tokens and segments equal the plain run's "
              f"with the self-draft {same[0]}, with the heads {same[1]} ({n_tokens} tokens; "
              f"walls plain / draft / heads {walls[0]:.2f} / {walls[1]:.2f} / {walls[2]:.2f} s)"
              f"  [{card}]")
        require(all(same), f"(e) f32 {route} long-form differs from the plain run")


def int8_decoder(torch, Pipeline, ops, card):
    """(f) ``quantize_decoder_weights`` on phase 3's model: decode ms/step
    beside the bf16 model's in this call, exactly K1 1, K2 6, K3 6 a step,
    and the largest logit difference from the bf16 model on the prefill."""
    from whisper_context_biasing_tpu_torch.audio import pad_or_trim
    from whisper_context_biasing_tpu_torch.decode import pack_prefixes
    from whisper_context_biasing_tpu_torch.models import (
        decode_tokens,
        encode_audio,
        init_kv_cache,
        precompute_cross_kv,
        quantize_cross_kv,
        quantize_decoder_weights,
    )

    clips = requests(np.random.default_rng(4))
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS)
    pipe = Pipeline("base.en", device=DEVICE, seed=0)
    _, _, tm, _ = timed_transcribe(torch, pipe, ops, clips, kwargs)
    float_model = pipe.model
    pipe.model = quantize_decoder_weights(float_model)
    res, counts, qtm, wall = timed_transcribe(torch, pipe, ops, clips, kwargs)
    want = {"mel": 1, "flash_attention": N_LAYERS,
            "quant_cross_attention": N_LAYERS * qtm["steps"]}
    tok = pipe.tokenizer
    ids, mask = pack_prefixes([[tok.sop] + tok.encode(CONTEXT.lower(), add_special_tokens=False)
                               + [tok.sot]] * BATCH, tok.eot, 32)
    ids, mask = torch.from_numpy(ids).long().to(DEVICE), torch.from_numpy(mask).to(DEVICE)
    mel = pipe.mel(np.stack([pad_or_trim(c, pipe.window_samples) for c in clips]))
    pos = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
    logits = []
    with torch.no_grad():
        for model in (float_model, pipe.model):
            cross = quantize_cross_kv(precompute_cross_kv(model, encode_audio(model, mel)))
            lg, _ = decode_tokens(model, ids, cross_kv=cross,
                                  cache=init_kv_cache(model.cfg, BATCH, ids.shape[1], DEVICE),
                                  token_positions=pos, self_mask=mask)
            logits.append(lg[mask])
    diff = max_err(*logits)
    scale = logits[0].abs().max().item()
    print(f"(f) int8 decoder weights (quantize_decoder_weights of phase 3's model): decode "
          f"{qtm['decode_ms'] / max(qtm['steps'], 1):.3f} ms/step over {qtm['steps']} steps "
          f"(the bf16 model right before: {tm['decode_ms'] / max(tm['steps'], 1):.3f}), wall "
          f"{wall * 1e3:.1f} ms; prefill logits max |int8 - bf16| {diff:.3e} (max |logit| "
          f"{scale:.2f}); launches {counts} (the run implies {want})  [{card}]")
    require(counts == want, f"(f) int8 decoder launches {counts} != {want}")
    require(np.isfinite(diff) and all(0 <= t < pipe.cfg.n_vocab for r in res for t in r.tokens),
            "(f) the int8 decoder gave non-finite logits or out-of-range tokens")
    return counts


def speculative_and_medusa(torch, Pipeline, ops, card, init_path, tmp):
    """Phase 13; returns the launches of its bf16 runs, summed."""
    start = time.perf_counter()
    spec_counts, p32, heads = speculative_serving(torch, Pipeline, ops, card)
    runs = [spec_counts, medusa_entry_points(torch, ops, card, init_path, tmp)]
    long_form_accelerated(torch, p32, heads, card)
    del p32
    runs.append(int8_decoder(torch, Pipeline, ops, card))
    print(f"  phase 13 took {time.perf_counter() - start:.1f} s  [{card}]")
    return {k: sum(c.get(k, 0) for c in runs) for k in set().union(*runs)}


# ---------------------------------------------------------------------------
# phase 14: training extensions and the last entry points
# ---------------------------------------------------------------------------

LORA_RANK = 8
DISTILL_STEPS = 3
ACCEPT_MAX_NEW = MAX_TOKENS


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def grads_agree(label, kl, pl, kg, pg) -> None:
    """Phase 6's rule: loss within 1e-5 relative, |g_kernel - g_plain| within
    1e-4 of |g_plain| over every gradient tensor."""
    diff = sum(((k - p).double() ** 2).sum().item() for k, p in zip(kg, pg)) ** 0.5
    ref = sum((p.double() ** 2).sum().item() for p in pg) ** 0.5
    print(f"  f32 {label}, kernels vs plain versions: loss {kl:.7f} vs {pl:.7f} (rel "
          f"{abs(kl - pl) / abs(pl):.2e}, limit 1e-5), |g_kernel - g_plain| / |g_plain| = "
          f"{diff / ref:.2e} (limit 1e-4) over {len(pg)} tensors")
    require(abs(kl - pl) <= 1e-5 * abs(pl), f"f32 {label} loss disagrees: {kl} vs {pl}")
    require(diff <= 1e-4 * ref, f"f32 {label} gradients disagree: {diff / ref}")


def phase14_datasets(corpus, phases=("train", "dev")):
    from whisper_context_biasing_tpu_torch.data import PromptWhisperDataset
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer()
    return tok, {phase: PromptWhisperDataset(str(corpus / "audio"), str(corpus / "jsonl"), phase,
                                             tokenizer=tok, prompt=True, bias_list=True,
                                             bias_nums=3)
                 for phase in phases}


def lora_runs(torch, ops, card, tmp):
    """(a) ``train_and_evaluate`` with ``lora_rank=8`` and SpecAugment at
    base.en over phase 10's corpus, unfused and with --fused_ln (2 steps of
    batch 8 x accum 2, an eval and a save at step 2): the launches the steps
    and the eval imply; the returned model is the base with checkpoint-2's
    adapters merged, every other weight bit-equal to the base's; then the
    LoRA step in f32 with every kernel (K1 for the features, flash, fused
    LN+matmul) against the all-plain configuration (phase 6's rule)."""
    import pathlib

    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram
    from whisper_context_biasing_tpu_torch.data import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.models import build_model, get_config, init_state_dict
    from whisper_context_biasing_tpu_torch.train import SpecAugmentConfig, TrainingConfig
    from whisper_context_biasing_tpu_torch.train import train_and_evaluate
    from whisper_context_biasing_tpu_torch.train.augment import make_augment_fn
    from whisper_context_biasing_tpu_torch.train.lora import (
        init_lora_params,
        load_lora_checkpoint,
        lora_param_count,
        lora_weights,
        make_lora_grad_fn,
    )

    root = pathlib.Path(tmp)
    tok, data = phase14_datasets(root / "corpus")
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop, pad_to_multiple=32)
    longest = max(len(ds.build_label_sequence(i)) for ds in data.values()
                  for i in range(len(ds)))
    require(-(-longest // 32) * 32 < get_config("base.en").flash_decoder_min_seq,
            f"labels of {longest} tokens take the decoder's flash path; the expected "
            "launches assume they do not")
    sd = init_state_dict(get_config("base.en"), 0)
    total = {}
    for fused in (False, True):
        cfg = get_config("base.en", dtype="bfloat16", flash_attention=True, remat="full",
                         **(FUSED_LN if fused else {}))
        out = root / f"lora{'_fused' if fused else ''}"
        tcfg = TrainingConfig(output_dir=str(out), per_device_train_batch_size=BATCH,
                              gradient_accumulation_steps=ACCUM, num_train_epochs=2,
                              eval_steps=2, save_steps=2, logging_steps=1, learning_rate=1e-3,
                              per_device_eval_batch_size=BATCH, generation_max_length=EVAL_MAX_LEN,
                              lora_rank=LORA_RANK, spec_augment=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, hist = train_and_evaluate(cfg, sd, tok, data["train"], data["dev"], coll, tcfg,
                                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
        evals = -(-ENTRY_ROWS["dev"] // BATCH)
        want = expected_train_launches(cfg, 2, s=0, mel=False)
        want["flash_attention"] += evals * cfg.n_audio_layers
        if fused:
            want["fused_ln_matmul"] += evals * 2 * cfg.n_audio_layers
        adapters, _, meta = load_lora_checkpoint(str(out / "checkpoint-2"), device="cuda")
        base = build_model(cfg, sd, device="cuda", train=True)
        merged = lora_weights(base, adapters, tcfg.lora_alpha)
        got = dict(model.named_parameters())
        base_same = all(torch.equal(got[n], p) for n, p in base.named_parameters()
                        if n not in merged)
        merged_same = all(torch.equal(got[n], w) for n, w in merged.items())
        moved = sum(not torch.equal(w, base.get_parameter(n)) for n, w in merged.items())
        losses = [e["loss"] for e in hist if "loss" in e]
        print(f"(a) LoRA rank {LORA_RANK} + SpecAugment, train_and_evaluate (base.en bf16, "
              f"flash{', --fused_ln' if fused else ''}, batch {BATCH} x accum {ACCUM}, 2 steps, "
              f"an eval) on {card}: {lora_param_count(adapters):,} adapter params; losses "
              f"{[round(x, 4) for x in losses]}, eval_wer "
              f"{[e['eval_wer'] for e in hist if 'eval_wer' in e]}; wall {wall:.2f} s  [{card}]")
        print(f"  checkpoint-2 holds the adapters (lora_rank {meta.get('lora_rank')}); the "
              f"returned model: the base bit-equal outside the {len(merged)} adapted "
              f"projections: {base_same}, those equal to base + checkpoint-2's merge: "
              f"{merged_same} ({moved} moved); launches {counts} (the run implies {want})")
        require(len(losses) == 2 and all(np.isfinite(losses)), "no finite LoRA losses")
        require(meta.get("lora_rank") == LORA_RANK, "checkpoint-2 lacks lora_rank")
        require(base_same and merged_same and moved == len(merged),
                "the returned model is not the base with the adapters merged")
        require(counts == want, f"LoRA launches {counts} != {want}")
        add_counts(total, counts)
        del model, base, merged, got, adapters

    # the f32 gate: one LoRA step's loss and adapter gradients
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}
    audio = batch.pop("audio")
    augment = make_augment_fn(SpecAugmentConfig(), 0)
    runs = []
    for kernels in (True, False):
        cfg = get_config("base.en", dtype="float32", flash_attention=kernels, remat="full",
                         **(FUSED_LN if kernels else {}))
        base = build_model(cfg, sd, device="cuda", train=True).requires_grad_(False)
        adapters = init_lora_params(base, LORA_RANK, torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        for top in adapters.values():  # b non-zero, so A gets a gradient too
            for tgts in top.values():
                for ab in tgts.values():
                    ab["b"] = (0.01 * torch.randn(ab["b"].shape, generator=g)).cuda()
        ops.reset_launch_counts()
        flat = audio.flatten(0, 1)
        feats = (ops.log_mel_spectrogram_fused(flat) if kernels else
                 log_mel_spectrogram(flat)).view(*audio.shape[:2], N_MELS, -1)
        b = augment(dict(batch, input_features=feats), 0)
        loss, grads = make_lora_grad_fn(cfg, grad_accum=ACCUM)(adapters, base, b)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        print(f"  f32 LoRA step {'kernel' if kernels else 'plain'} run launches: {counts}")
        require(bool(counts) == kernels, f"f32 LoRA {'kernel' if kernels else 'plain'} run "
                f"launches {counts}")
        runs.append((float(loss), grads))
        del base, adapters
    grads_agree("LoRA step (adapter gradients)", runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    return total


def count_forwards(torch, distill_mod, calls):
    """Record each forward ``train/distill.py`` runs: (cfg, label length,
    whether it records a graph), from which its flash launches follow."""
    real = distill_mod.forward

    def recorded(model, feats, ids):
        calls.append((model.cfg, ids.shape[1], torch.is_grad_enabled()))
        return real(model, feats, ids)

    distill_mod.forward = recorded
    return real


def forward_launches(calls) -> dict:
    """K2 and K4 for recorded forwards: per forward one K2 per encoder layer
    and two per decoder layer at S >= flash_decoder_min_seq; a forward that
    records a graph runs them again in its remat replay and runs K4 once a
    flash use."""
    k2 = k4 = 0
    for cfg, s, grad in calls:
        uses = cfg.n_audio_layers + (2 * cfg.n_text_layers if s >= cfg.flash_decoder_min_seq
                                     else 0)
        remat = grad and cfg.remat == "full"
        k2 += uses * (2 if remat else 1)
        k4 += uses if grad else 0
    return {"flash_attention": k2, "flash_attention_bwd": k4}


def distill_runs(torch, ops, card, init_path, tmp):
    """(b) ``make_distill_step``: a base.en teacher, a tiny.en student, phase
    5's batch (8 x accum 2, raw audio, labels of 449 tokens), bf16, 3 steps:
    step ms and exactly the launches the step implies; the step in f32 with
    every kernel against the all-plain configuration; ``cli.distill`` from
    phase 10's model.safetensors over its corpus. (c) one raw-audio step of a
    large-v3 teacher (128 mels, full width) and a tiny student with its
    vocab (80 mels): K1 exactly twice, and the 128-mel features against the
    plain version's."""
    import json as _json
    import pathlib

    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram
    from whisper_context_biasing_tpu_torch.cli import distill as distill_cli
    from whisper_context_biasing_tpu_torch.models import build_model, get_config, init_state_dict
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        list_checkpoints,
        make_distill_step,
        make_optimizer,
    )
    from whisper_context_biasing_tpu_torch.train import distill as distill_mod

    total = {}
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items() if k != "bias_spans"}
    calls = []
    real = count_forwards(torch, distill_mod, calls)
    try:
        # (b) bf16, 3 steps
        kw = dict(dtype="bfloat16", flash_attention=True, remat="full")
        cfg_t, cfg_d = get_config("base.en", **kw), get_config("tiny.en", **kw)
        teacher = build_model(cfg_t, seed=0, device="cuda")
        student = build_model(cfg_d, seed=1, device="cuda", train=True)
        opt = make_optimizer(peak_lr=1e-4, warmup_steps=0, total_steps=100)
        step = make_distill_step(cfg_d, cfg_t, opt, grad_accum=ACCUM)
        state = init_train_state(student, opt)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls.clear()
        walls, metrics = [], []
        for _ in range(DISTILL_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, teacher, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append({k: round(float(v), 4) for k, v in m.items()})
        counts = dict(ops.launches)
        want = dict(mel=DISTILL_STEPS * ACCUM, **forward_launches(calls))
        print(f"(b) distillation step (base.en teacher, tiny.en student, bf16, flash, remat "
              f"full, batch {BATCH} x accum {ACCUM}, labels {T_TEXT}, raw audio) on {card}:")
        for i, (mt, w) in enumerate(zip(metrics, walls)):
            print(f"  step {i + 1}: {mt}, wall {w * 1e3:.1f} ms  [{card}]")
        print(f"  launches over {DISTILL_STEPS} steps: {counts} (the step implies {want}: per "
              f"microbatch K1 1, K2 {cfg_t.n_audio_layers + 2 * cfg_t.n_text_layers} teacher + "
              f"2 x {cfg_d.n_audio_layers + 2 * cfg_d.n_text_layers} student, K4 "
              f"{cfg_d.n_audio_layers + 2 * cfg_d.n_text_layers})")
        require(all(np.isfinite(v) for mt in metrics for v in mt.values()),
                "non-finite distillation metrics")
        require(counts == want, f"distillation launches {counts} != {want}")
        add_counts(total, counts)
        del teacher, student, state, step, opt

        # the f32 gate
        runs = []
        for kernels in (True, False):
            kw = dict(dtype="float32", flash_attention=kernels, remat="full")
            cfg_t, cfg_d = get_config("base.en", **kw), get_config("tiny.en", **kw)
            teacher = build_model(cfg_t, seed=0, device="cuda")
            student = build_model(cfg_d, seed=1, device="cuda", train=True)
            opt = make_optimizer(peak_lr=1e-4, warmup_steps=0, total_steps=100)
            b = batch
            if not kernels:  # the plain frontend, named outright
                audio = batch["audio"]
                feats = log_mel_spectrogram(audio.flatten(0, 1))
                b = dict({k: v for k, v in batch.items() if k != "audio"},
                         input_features=feats.view(*audio.shape[:2], *feats.shape[1:]))
            ops.reset_launch_counts()
            _, m = make_distill_step(cfg_d, cfg_t, opt, grad_accum=ACCUM)(
                init_train_state(student, opt), teacher, b)
            torch.cuda.synchronize()
            counts = dict(ops.launches)
            print(f"  f32 distillation {'kernel' if kernels else 'plain'} run launches: {counts}")
            require(bool(counts) == kernels, f"f32 distillation run launches {counts}")
            runs.append((float(m["loss"]), [p.grad for p in student.parameters()]))
            del teacher, student, opt
        grads_agree("distillation step (student gradients)", runs[0][0], runs[1][0],
                    runs[0][1], runs[1][1])
        del runs

        # the CLI over phase 10's corpus, from its model.safetensors
        root = pathlib.Path(tmp)
        corpus, out = root / "corpus", root / "draft"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls.clear()
        t0 = time.perf_counter()
        distill_cli.main(["--data_root", str(corpus), "--data_dir", "audio", "--jsonl_data",
                          str(corpus / "jsonl"), "--model", "base.en", "--init_checkpoint",
                          str(init_path), "--draft_model", "tiny.en", "--output", str(out),
                          "--batch", str(BATCH), "--epoch", "1", "--warmup_steps", "0",
                          "--logging_steps", "1", "--eval_batches", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
        want = forward_launches(calls)
        summary = _json.loads((out / "distill_results.json").read_text())
        ckpts = [os.path.basename(c) for c in list_checkpoints(str(out))]
        print(f"  cli.distill (base.en -> tiny.en, phase 10's corpus): {summary}, {ckpts}, "
              f"model.safetensors {(out / 'model.safetensors').stat().st_size / 1e6:.1f} MB, "
              f"wall {wall:.2f} s; launches {counts} ({len(calls)} forwards imply {want})  "
              f"[{card}]")
        require(summary.get("total_steps") == ENTRY_ROWS["train"] // BATCH, "cli.distill steps")
        require(ckpts and (out / "model.safetensors").is_file(), "cli.distill wrote no files")
        require(counts == want, f"cli.distill launches {counts} != {want}")
        add_counts(total, counts)

        # (c) two mel frontends: large-v3 (128 mels) teaching an 80-mel tiny
        cfg_t = get_config("large-v3", dtype="bfloat16", flash_attention=True)
        cfg_d = get_config("tiny", n_vocab=cfg_t.n_vocab, dtype="bfloat16",
                           flash_attention=True, remat="full")
        t0 = time.perf_counter()
        teacher = build_model(cfg_t, init_state_dict(cfg_t, 0, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        student = build_model(cfg_d, seed=1, device="cuda", train=True)
        opt = make_optimizer(peak_lr=1e-4, warmup_steps=0, total_steps=10)
        mb = {k: v[0] for k, v in batch.items()}
        step = make_distill_step(cfg_d, cfg_t, opt)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls.clear()
        t0 = time.perf_counter()
        _, m = step(init_train_state(student, opt), teacher, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
        want = dict(mel=2, **forward_launches(calls))
        err = max_err(ops.log_mel_spectrogram_fused(mb["audio"], n_mels=128),
                      log_mel_spectrogram(mb["audio"], n_mels=128))
        print(f"(c) two mel frontends: large-v3 teacher (128 mels, d {cfg_t.d_model}, "
              f"{cfg_t.n_audio_layers}+{cfg_t.n_text_layers} layers, drawn on the card in "
              f"{init_s:.2f} s) and a tiny student (80 mels, vocab {cfg_d.n_vocab}), batch "
              f"{BATCH}, labels {T_TEXT}, raw audio: one step {wall * 1e3:.1f} ms, loss "
              f"{float(m['loss']):.4f}; launches {counts} (implied {want}); the teacher's "
              f"128-mel features vs the plain version's: max |err| {err:.3e} (atol 1e-4)  "
              f"[{card}]")
        require(np.isfinite(float(m["loss"])), "non-finite two-frontend loss")
        require(counts == want, f"two-frontend launches {counts} != {want}")
        require(err <= 1e-4, f"128-mel features disagree: {err}")
        add_counts(total, counts)
        del teacher, student, opt, step
    finally:
        distill_mod.forward = real
    torch.cuda.empty_cache()
    return total


ACCEPT_SKIPS = ["metric_parity:desc_only_dev", "metric_parity:baseline_test",
                "model_parity:desc_only_dev", "model_parity:baseline_test"]


def acceptance_run(torch, ops, card, tmp):
    """(d) ``cli.acceptance`` on the five configs, offline, config 1 on the
    CPU and 2-5 on the card at full width: ``ok``, the asserts JAX's offline
    run skips skipped, each config's wall and exactly the launches it
    implies: none for config 1; for a decode config K1 one an utterance (the
    dataset's features), K2 one per encoder layer a decode call and K3 one
    per decoder layer a decode step; for config 3's training K1 one a
    training item, K2 twice and K4 once per encoder layer a step (its labels
    stay under ``flash_decoder_min_seq``)."""
    import pathlib

    from whisper_context_biasing_tpu_torch.cli import acceptance
    from whisper_context_biasing_tpu_torch.models import get_config
    from whisper_context_biasing_tpu_torch.train import loop

    steps, per_config = [], {}
    real = {"greedy_decode": loop.greedy_decode, "beam_decode": loop.beam_decode,
            "run_decode_config": acceptance.run_decode_config,
            "run_train_config": acceptance.run_train_config}

    def with_steps(fn):
        def decode(*a, **kw):
            t = {}
            res = fn(*a, timings=t, **kw)
            steps.append(t["steps"])
            return res
        decode.cache_size = fn.cache_size  # evaluate_wer's signature diagnostic
        return decode

    def counted(fn):
        def run(num, *a, **kw):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            steps.clear()
            t0 = time.perf_counter()
            row = fn(num, *a, **kw)
            torch.cuda.synchronize()
            per_config[num] = (dict(ops.launches), list(steps), time.perf_counter() - t0)
            torch.cuda.empty_cache()
            return row
        return run

    loop.greedy_decode = with_steps(real["greedy_decode"])
    loop.beam_decode = with_steps(real["beam_decode"])
    acceptance.run_decode_config = counted(real["run_decode_config"])
    acceptance.run_train_config = counted(real["run_train_config"])
    out = pathlib.Path(tmp) / "acceptance"
    try:
        t0 = time.perf_counter()
        summary = acceptance.main(["--output", str(out), "--max_new", str(ACCEPT_MAX_NEW),
                                   "--device", "cuda"])
        wall = time.perf_counter() - t0
    finally:
        loop.greedy_decode, loop.beam_decode = real["greedy_decode"], real["beam_decode"]
        acceptance.run_decode_config = real["run_decode_config"]
        acceptance.run_train_config = real["run_train_config"]
    total = {}
    models = {1: "tiny.en", 2: "base.en", 3: "small.en", 4: "medium.en", 5: "large-v3"}
    print(f"(d) cli.acceptance, five configs offline (--max_new {ACCEPT_MAX_NEW}), {wall:.1f} s "
          f"on {card}:")
    for row in summary["configs"]:
        num = row["config"]
        counts, st, w = per_config[num]
        cfg = get_config(models[num])
        if num == 1:
            want = {}
        elif row["mode"] == "weightce_train":
            n = row["steps"]
            want = {"mel": n, "flash_attention": 2 * n * cfg.n_audio_layers,
                    "flash_attention_bwd": n * cfg.n_audio_layers}
        else:
            want = {"mel": row["n_utts"], "flash_attention": len(st) * cfg.n_audio_layers,
                    "quant_cross_attention": sum(st) * cfg.n_text_layers}
        want = {k: v for k, v in want.items() if v}
        shown = {k: row[k] for k in ("mode", "n_utts", "wer", "bias_wer", "steps", "first_loss",
                                     "last_loss", "wall_s") if k in row}
        print(f"  config {num} {models[num]}: {shown}; decode calls {len(st)}, steps {st}; "
              f"{w:.2f} s; launches {counts} (implied {want})  [{card}]")
        require(counts == want, f"acceptance config {num} launches {counts} != {want}")
        add_counts(total, counts)
    skipped = sorted(a["assert"] for a in summary["asserts_skipped"])
    print(f"  ok {summary['ok']}, asserts passed {summary['asserts_passed']}, failed "
          f"{summary['asserts_failed']}, skipped {skipped}; probe: "
          f"{summary['asset_probe']['outcome']}")
    require(summary["ok"] and [r["config"] for r in summary["configs"]] == [1, 2, 3, 4, 5],
            "the acceptance sweep failed")
    require(skipped == sorted(ACCEPT_SKIPS), f"acceptance skipped {skipped}")
    require((out / "acceptance.json").is_file(), "no acceptance.json")
    return total


def harnesses(tmp) -> None:
    """(e) the three inspection harnesses, once each, on phase 10's corpus."""
    import contextlib
    import io
    import pathlib

    from whisper_context_biasing_tpu_torch.cli import (
        check_data_collator,
        check_data_loader,
        check_weightce,
    )

    corpus = pathlib.Path(tmp) / "corpus"
    data = ["--data_root", str(corpus), "--data_dir", "audio", "--jsonl_data",
            str(corpus / "jsonl"), "--phase", "train"]
    for name, run in (
            ("check_weightce", lambda: check_weightce.main([])),
            ("check_data_collator", lambda: check_data_collator.main(
                [*data, "--prompt", "--bias_list", "--bias_nums", "3"])),
            ("check_data_loader", lambda: check_data_loader.main(
                [*data, "--prompt", "--bias_list", "--bias_nums", "3"]))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run()
        lines = buf.getvalue().splitlines()
        print(f"(e) cli.{name}: {len(lines)} lines, {time.perf_counter() - t0:.2f} s: "
              f"{lines[-1]}")
        require(lines[-1].startswith("OK:"), f"cli.{name} did not pass")


def training_extensions(torch, ops, card, init_path, tmp):
    """Phase 14; returns the launches of its runs, summed."""
    start = time.perf_counter()
    runs = [lora_runs(torch, ops, card, tmp), distill_runs(torch, ops, card, init_path, tmp),
            acceptance_run(torch, ops, card, tmp)]
    harnesses(tmp)
    print(f"  phase 14 took {time.perf_counter() - start:.1f} s  [{card}]")
    return {k: sum(c.get(k, 0) for c in runs) for k in set().union(*runs)}


# ---------------------------------------------------------------------------
# phase 15: data and tensor parallelism, and the remat policies
# ---------------------------------------------------------------------------

TP = 2                # (b)'s model axis over the two ranks
RANK_TIMEOUT_S = 600  # a rank that runs longer fails the phase
REMAT_POLICIES = ("none", "full", "dots", "wide")


def check_fused_shape(torch, ops, rng, label, n, e, act) -> dict:
    """K5 at one (n, 512) -> e site, f32 and bf16, against its plain version
    with phase 2's limits, timed beside its bound."""
    for dtype in (torch.float32, torch.bfloat16):
        x, g, beta, w, b = fused_inputs(torch, rng, n, e, dtype)
        want = ops.fused_ln_matmul_plain(x, g, beta, w, b, act=act)
        err = max_err(ops.fused_ln_matmul(x, g, beta, w, b, act=act), want)
        limit = 2e-5 if dtype == torch.float32 else 1e-2 * want.float().abs().max().item()
        require(err <= limit, f"fused LN+matmul {dtype} {label} ({n} -> {e}) disagrees: {err}")
    n_ops = 2 * n * D_MODEL * e
    b_ms, b_by = bound((n * D_MODEL + D_MODEL * e + n * e) * 2, n_ops, PEAK_BF16_FLOP_S)
    ms = median_ms(torch, lambda: ops.fused_ln_matmul(x, g, beta, w, b, act=act))
    plain_ms = median_ms(torch, lambda: ops.fused_ln_matmul_plain(x, g, beta, w, b, act=act))
    print(f"K5 fused LN+matmul {label} ({n} x {D_MODEL} -> {e}): bf16 max |err| {err:.3e} "
          f"(1% of max |out|); {ms:.4f} ms = {n_ops / ms / 1e9:.1f} TFLOP/s (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
    return dict(kernel="fused_ln_matmul", shape=f"{n}x{D_MODEL}->{e}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms)


def check_tp_shapes(torch, ops) -> list[dict]:
    """K2, K3, K4 and K5 at the shapes a rank of base.en's tensor-parallel
    mesh (model axis 2, phase 15 (b)) gives them: 4 heads of 64 (D / 2 =
    256): K2 and K4 on the encoder's (8, 1500, 4 x 64), K3 on the (6, 8,
    1536, 256) int8 cross K/V; K5 at E / 2: 768 (QKV), 1024 (MLP) and 256
    (the decoder's cross q); and K2 and K3 at the tiny.en draft's shapes on
    that axis (phase 15 (d)): 3 heads of 64, K2 on (8, 1500, 3 x 64), K3 on
    the (4, 8, 1536, 192) int8 cross K/V. Each as ``check_bucket_shapes``
    holds and times its shapes."""
    rng = np.random.default_rng(51)
    d, heads = D_MODEL // TP, N_HEADS // TP
    print(f"tensor-parallel shapes (model axis {TP}: d {d}, {heads} heads a rank):")
    rows = [check_flash_shape(torch, ops, rng, T_AUDIO, d, heads),
            check_quant_shape(torch, ops, rng, BATCH, T_PAD, T_AUDIO, d, heads),
            check_flash_bwd_shape(torch, ops, rng, T_AUDIO, d, heads)]
    # phase 15 (d)'s tiny.en draft at the same model axis: 3 heads of 64
    dd, dh = DRAFT_D // TP, DRAFT_HEADS // TP
    print(f"  the {DRAFT} draft at model axis {TP}: d {dd}, {dh} heads a rank:")
    rows += [check_flash_shape(torch, ops, rng, T_AUDIO, dd, dh),
             check_quant_shape(torch, ops, rng, BATCH, T_PAD, T_AUDIO, dd, dh, DRAFT_LAYERS)]
    for label, (n, e, act) in {
            "encoder QKV / 2": (BATCH * T_AUDIO, 3 * D_MODEL // TP, None),
            "encoder MLP gelu / 2": (BATCH * T_AUDIO, 4 * D_MODEL // TP, "gelu"),
            "decoder cross q / 2": (BATCH * T_TEXT, D_MODEL // TP, None)}.items():
        rows.append(check_fused_shape(torch, ops, rng, label, n, e, act))
    torch.cuda.empty_cache()
    return rows


def f32_step(torch, ops, mesh=None, batch=None):
    """One f32 step of phase 5's configuration (flash, remat full, mel in the
    step): (loss, {name: whole gradient}, launches). Under ``mesh`` the
    model and the batch are this rank's shards and the gradients gathered
    whole."""
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.parallel import shard_batch, shard_params
    from whisper_context_biasing_tpu_torch.parallel.sharding import gather_tensor
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    if batch is None:
        batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
            np.random.default_rng(7)).items()}
    cfg = get_config("base.en", dtype="float32", flash_attention=True, remat="full")
    model = build_model(cfg, seed=0, device="cuda", train=True)
    if mesh is not None:
        model = shard_params(model, mesh)
        batch = shard_batch(batch, mesh, extra_leading_axes=1)
    opt = make_optimizer(peak_lr=1e-5, warmup_steps=50, total_steps=1000)
    step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM, mel_on_device=True,
                           mesh=mesh)
    ops.reset_launch_counts()
    _, m = step(init_train_state(model, opt), batch)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    grads = {n: gather_tensor(model, n, p.grad) for n, p in model.named_parameters()}
    return float(m["loss"]), grads, counts


def grads_within(label, grads, ref) -> float:
    """|g - g_ref| / |g_ref| over every tensor (phase 6's rule: 1e-4)."""
    diff = sum(((grads[n] - ref[n].to(grads[n].device)).double() ** 2).sum().item()
               for n in ref) ** 0.5
    norm = sum((ref[n].double() ** 2).sum().item() for n in ref) ** 0.5
    require(diff <= 1e-4 * norm, f"{label}: gradients disagree, |g - g_ref| / |g_ref| = "
            f"{diff / norm:.2e} > 1e-4")
    return diff / norm


def serving_inputs(pipe):
    """Phase 4's decode inputs for ``pipe``: phase 3's requests through the
    mel kernel, the prompted prefixes and the bias spans."""
    from whisper_context_biasing_tpu_torch.audio import pad_or_trim
    from whisper_context_biasing_tpu_torch.decode import pack_prefixes

    tok = pipe.tokenizer
    ctx = tok.encode(CONTEXT.lower(), add_special_tokens=False)
    ids, mask = pack_prefixes([[tok.sop] + ctx + [tok.sot]] * BATCH, tok.eot, 32)
    audio = np.stack([pad_or_trim(c, pipe.window_samples)
                      for c in requests(np.random.default_rng(4))])
    return pipe.mel(audio), ids, mask, pipe._spans(BIAS_WORDS, BATCH)


def f32_decodes(torch, pipe, mesh=None):
    """Phase 4's greedy decode and a 5-beam decode of the same inputs, in
    f32 on ``pipe``'s model: (greedy tokens, beam best tokens)."""
    from whisper_context_biasing_tpu_torch.decode import beam_decode, greedy_decode

    mel, ids, mask, spans = serving_inputs(pipe)
    eot = pipe.tokenizer.eot
    kw = dict(max_new=MAX_TOKENS, eot_id=eot, bias_spans=spans, bias_boost=2.0,
              span_pad_id=eot, device="cuda", mesh=mesh)
    g = greedy_decode(pipe.model, mel, ids, mask, **kw)
    b = beam_decode(pipe.model, mel, ids, mask, num_beams=BEAMS, **kw)
    return g.tokens.cpu().numpy(), b.best.cpu().numpy()


def parallel_rank(rank: int, workdir: str) -> int:
    """Phase 15 (b), one of two ranks that share the card over gloo: at mesh
    (1, 2) and then (2, 1) (``auto_mesh(2)``, ``auto_mesh(1)``), the f32
    greedy and 5-beam tokens, an f32 training step's loss and gathered
    gradients against the unsharded references the parent wrote, and the
    bf16 launches of a serving batch, a training step and a fused training
    step; then (d) and (e), the serving routes at each mesh held to the
    parent's unsharded run (``serving_routes``, ``hold_routes``); then (g),
    distillation, LoRA and the sharded checkpoint at each mesh
    (``parallel_train``). Writes ``rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=2, rank=rank)
    from whisper_context_biasing_tpu_torch import Pipeline, ops
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        auto_mesh,
        axis_size,
        shard_batch,
        shard_params,
    )
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    ref = np.load(os.path.join(workdir, "ref_tokens.npz"))
    ref_grads = torch.load(os.path.join(workdir, "ref_grads.pt"))
    spec = json.loads(open(os.path.join(workdir, "spec.json")).read())
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}
    out = {}
    for label, mp in (("tp", TP), ("dp", 1)):
        mesh = auto_mesh(mp)
        shape = (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))
        res = {"mesh": shape}
        walls = {}
        t0 = time.perf_counter()
        pipe = Pipeline("base.en", device="cuda", seed=0, dtype="float32", model_parallelism=mp)
        greedy, beam = f32_decodes(torch, pipe, pipe.mesh)
        walls["f32 greedy + 5 beams"] = time.perf_counter() - t0
        kt, km = ref["greedy"], ref["margins"]
        rows = []
        for i in range(BATCH):  # phase 4's rule: identical, or a near-tie
            diff = np.nonzero(greedy[i] != kt[i])[0]
            if diff.size:
                rows.append((i, int(diff[0]), float(km[i, diff[0]])))
        require(all(gap < 1e-4 for _, _, gap in rows),
                f"rank {rank} mesh {shape}: f32 greedy tokens diverge from phase 4's {rows}")
        require(np.array_equal(beam, ref["beam"]),
                f"rank {rank} mesh {shape}: f32 5-beam tokens differ from the unsharded run's")
        res["greedy_divergences"] = rows
        del pipe
        t0 = time.perf_counter()
        loss, grads, _ = f32_step(torch, ops, mesh, batch)
        walls["f32 training step"] = time.perf_counter() - t0
        rel = abs(loss - spec["loss"]) / abs(spec["loss"])
        require(rel <= 1e-5, f"rank {rank} mesh {shape}: f32 loss {loss} vs {spec['loss']}")
        res.update(loss=loss, loss_rel=rel,
                   grad_rel=grads_within(f"rank {rank} mesh {shape}", grads, ref_grads))
        del grads
        # bf16: the launches of a serving batch and of the training steps
        pipe = Pipeline("base.en", device="cuda", seed=0, model_parallelism=mp)
        kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                      max_tokens=MAX_TOKENS)
        clips = requests(np.random.default_rng(4))
        pipe.transcribe(clips, **kwargs)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
        walls["bf16 serving batch"] = time.perf_counter() - t0
        steps = pipe.last_timings["steps"]
        counts = dict(ops.launches)
        want = {"mel": 1, "flash_attention": N_LAYERS,
                "quant_cross_attention": N_LAYERS * steps}
        require(counts == want, f"rank {rank} mesh {shape}: serving launches {counts} != "
                f"{want}")
        res["serve"] = dict(counts, steps=steps)
        del pipe
        for name, fused in (("train", False), ("fused", True)):
            cfg = get_config("base.en", dtype="bfloat16", flash_attention=True, remat="full",
                             **(FUSED_LN if fused else {}))
            model = shard_params(build_model(cfg, seed=0, device="cuda", train=True), mesh)
            opt = make_optimizer(peak_lr=1e-5, warmup_steps=50, total_steps=1000)
            step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM,
                                   mel_on_device=True, mesh=mesh)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, m = step(init_train_state(model, opt), shard_batch(batch, mesh,
                                                                 extra_leading_axes=1))
            torch.cuda.synchronize()
            walls[f"bf16 {name} step"] = time.perf_counter() - t0
            counts = dict(ops.launches)
            want = expected_train_launches(cfg, 1)
            require(np.isfinite(float(m["loss"])), f"rank {rank}: non-finite bf16 loss")
            require(counts == want, f"rank {rank} mesh {shape}: bf16 {name} step launches "
                    f"{counts} != {want}")
            res[name] = counts
            del model, opt, step
        res["walls_s"] = walls
        out[label] = res
        torch.cuda.empty_cache()
    # (d)-(e): the serving routes at each mesh, held to the parent's
    # unsharded run (which it computes while the ranks run (b))
    path = os.path.join(workdir, "serving_ref.json")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not os.path.exists(path):
        require(time.monotonic() < deadline, f"rank {rank}: no serving references")
        time.sleep(0.2)
    with open(path) as f:
        ref = json.load(f)
    out["serving"] = {}
    for label, mp in (("tp", TP), ("dp", 1)):
        got = serving_routes(torch, ops, mp, host_windows=mp == 1, sampled=mp == 1)
        hold_routes(f"rank {rank} mesh {label}", got, ref, tp=mp > 1)
        out["serving"][label] = got
    # (g): distillation, LoRA and the sharded checkpoint, held to the
    # parent's unsharded references
    path = os.path.join(workdir, "train_ref.pt")
    while not os.path.exists(path):
        require(time.monotonic() < deadline, f"rank {rank}: no training references")
        time.sleep(0.2)
    ref = torch.load(path)
    out["train"] = {label: parallel_train(torch, ops, rank, label, auto_mesh(mp), ref, workdir)
                    for label, mp in (("tp", TP), ("dp", 1))}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def two_ranks(torch, ops, card, f32_tokens, tmp) -> dict:
    """Phase 15 (b): the unsharded f32 references written to ``tmp``, the
    two ranks spawned (this script with ``--parallel-rank``, a ``file://``
    rendezvous in ``tmp``), each waited for with a timeout and killed on
    failure; (d) and (e)'s unsharded run written beside them. Returns both
    ranks' launches of (b), (d) and (e), summed."""
    from whisper_context_biasing_tpu_torch import Pipeline

    workdir = os.path.join(tmp, "parallel")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    pipe = Pipeline("base.en", device="cuda", seed=0, dtype="float32")
    greedy, beam = f32_decodes(torch, pipe)
    del pipe
    kt, km = f32_tokens
    require(np.array_equal(greedy, kt), "the f32 greedy decode no longer gives phase 4's tokens")
    loss, grads, _ = f32_step(torch, ops)
    np.savez(os.path.join(workdir, "ref_tokens.npz"), greedy=kt, margins=km, beam=beam)
    torch.save({n: g.cpu() for n, g in grads.items()}, os.path.join(workdir, "ref_grads.pt"))
    del grads
    torch.cuda.empty_cache()
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump({"loss": loss}, f)
    print(f"  (b) unsharded f32 references (greedy = phase 4's, 5 beams, one training step, "
          f"loss {loss:.7f}) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), workdir], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        # (d)-(e)'s unsharded run while the ranks run (b); they wait for it
        t1 = time.perf_counter()
        serving_ref = serving_routes(torch, ops, 0, sampled=True)
        for name, r in serving_ref.items():
            require(r["launches"] == r["implied"], f"(d) unsharded {name}: launches "
                    f"{r['launches']} != what the loop implies {r['implied']}")
        path = os.path.join(workdir, "serving_ref.json")
        with open(path + ".tmp", "w") as f:
            json.dump(serving_ref, f)
        os.replace(path + ".tmp", path)
        print(f"  (d)-(e) unsharded f32 references in {time.perf_counter() - t1:.1f} s (beside "
              f"the ranks' (b)): " + "; ".join(
                  f"{n} launches {r['launches']} (mel calls, encoder passes, decoder steps "
                  f"{r['loop']}; {r['wall_s']:.2f} s)" for n, r in serving_ref.items()))
        train_ref = parallel_train_refs(torch, ops, os.path.join(tmp, "corpus"), workdir)
        path = os.path.join(workdir, "train_ref.pt")
        torch.save(train_ref, path + ".tmp")
        os.replace(path + ".tmp", path)
        print(f"  (g) unsharded f32 references in {train_ref['wall_s']:.1f} s: distillation "
              f"{[round(m['loss'], 6) for m in train_ref['distill']['metrics']]} "
              f"({train_ref['distill']['wall_s']:.2f} s), LoRA "
              f"{[round(x, 6) for x in train_ref['lora']['losses']]} "
              f"({train_ref['lora']['wall_s']:.2f} s), fused "
              f"{[round(x, 6) for x in train_ref['lora_fused']['losses']]} "
              f"({train_ref['lora_fused']['wall_s']:.2f} s), checkpointed steps "
              f"{[round(x, 6) for x in train_ref['ckpt_losses']]}")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            # a rank that fails ends the phase: its peer would wait for it
            require(all(p.returncode in (None, 0) for p in procs), "a rank failed")
            require(time.monotonic() < deadline, f"a rank ran past {RANK_TIMEOUT_S} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        for r in range(2):
            text = open(os.path.join(workdir, f"rank{r}.log")).read()
            if procs[r].returncode != 0:
                print(f"  rank {r} exited {procs[r].returncode}:\n{text[-4000:]}")
    require(all(p.returncode == 0 for p in procs), "phase 15 (b): a rank failed")
    wall = time.perf_counter() - t0
    total, ranks = {}, []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res = json.load(f)
        for label in ("tp", "dp"):
            x = res[label]
            print(f"  (b) rank {r}, mesh (data, model) = {tuple(x['mesh'])}: f32 greedy tokens "
                  f"= phase 4's ({len(x['greedy_divergences'])} near-tie divergences "
                  f"{x['greedy_divergences']}), 5 beams = the unsharded run's; f32 step loss "
                  f"{x['loss']:.7f} (rel {x['loss_rel']:.2e}, limit 1e-5), gradients "
                  f"|g - g_ref| / |g_ref| = {x['grad_rel']:.2e} (limit 1e-4); bf16 launches: "
                  f"serving {x['serve']}, training step {x['train']}, fused step "
                  f"{x['fused']}")
            print(f"      walls (two ranks time-slicing one card, gloo through the host: "
                  f"no dp or tp figure): "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in x["walls_s"].items()))
            for c in (x["serve"], x["train"], x["fused"]):
                add_counts(total, {k: v for k, v in c.items() if k != "steps"})
            for name, g in res["serving"][label].items():
                same = ("the unsharded run's output" if "divergence" not in g else
                        f"held by {'(e)' if name == 'sampled' else 'phase 4'}'s rule: "
                        f"{g['divergence']}")
                print(f"  (d)-(e) rank {r}, mesh {tuple(x['mesh'])}, {name}: {same}; "
                      f"launches {g['launches']} = what its loop implies (mel "
                      f"calls, encoder passes, decoder steps {g['loop']}"
                      + ("; = the unsharded run's" if label == "tp" and "divergence" not in g
                         else "")
                      + f"), {g['wall_s']:.2f} s")
                add_counts(total, g["launches"])
        ranks.append(res)
    draws = [res["serving"]["dp"]["sampled"]["out"][2] for res in ranks]
    want = serving_ref["sampled"]["out"][2]
    print(f"  (e) the {SAMPLED_T} rung at mesh (2, 1) on CUDA generators: every window took "
          f"it; first uniforms rank 0 {draws[0]}, rank 1 {draws[1]}, unsharded {want}")
    require(draws == [[u] for u in want] and draws[0] != draws[1],
            "(e) the ranks' uniforms are not the unsharded run's rows'")
    for r, res in enumerate(ranks):
        for label in ("tp", "dp"):
            g, shape = res["train"][label], tuple(res[label]["mesh"])
            d = g["distill"]
            print(f"  (g) rank {r}, mesh {shape}: distillation (f32, {G_STEPS} steps) loss rel "
                  f"{d['loss_rel']:.2e} (limit 1e-5), agreement {d['agreement']} = the "
                  f"unsharded run's, gradients {d['grad_rel']:.2e} (limit 1e-4), launches "
                  f"{d['launches']}, {d['wall_s']:.2f} s")
            for name in ("lora", "lora_fused"):
                x = g[name]
                print(f"  (g) rank {r}, mesh {shape}: {name} loop (f32, 2 steps, an eval, a DCP "
                      f"save) loss rel {x['loss_rel']:.2e}, adapter gradients "
                      f"{x['grad_rel']:.2e}, eval_wer {x['wers'][0]} (unsharded "
                      f"{x['wers'][1]}), launches {x['launches']}, {x['wall_s']:.2f} s")
                add_counts(total, x["launches"])
            add_counts(total, d["launches"])
            c = g["ckpt"]
            print(f"  (g) rank {r}, mesh {shape}: checkpointed step {c['step']} "
                  + ("(saved through DCP in " + f"{c['save_s']:.2f} s) " if c["save_s"] else
                     "(resumed from the (1, 2) DCP checkpoint) ")
                  + f"loss {c['loss']:.7f}, rel {c['loss_rel']:.2e} (limit 1e-5)")
    sharded_checkpoint(torch, workdir)
    print(f"  (b), (d), (e), (g): two ranks took {wall:.1f} s (spawn to exit)  [{card}]")
    return total


def sharded_checkpoint(torch, workdir) -> None:
    """(g) in the parent, with no process group: the checkpoint the ranks
    saved at (1, 2) loads whole and bit-equal to their gathered weights;
    each rank's file sizes beside one copy of the tensors."""
    import torch.distributed as dist

    from whisper_context_biasing_tpu_torch.train import load_checkpoint

    require(not dist.is_initialized(), "the parent holds a process group")
    path = os.path.join(workdir, "sharded", "checkpoint-1")
    sd, opt, _ = load_checkpoint(path, ckpt_cfg(), load_opt_state=True)
    whole = torch.load(os.path.join(workdir, "gathered.pt"))
    same = all(torch.equal(sd[n], whole[n]) for n in sd)
    sizes = {d: {f: os.path.getsize(os.path.join(path, d, f))
                 for f in sorted(os.listdir(os.path.join(path, d))) if f.endswith(".distcp")}
             for d in ("params_dcp", "opt_dcp")}
    one_copy = {"params_dcp": sum(t.numel() * 4 for t in sd.values()),
                "opt_dcp": 2 * sum(m.numel() * 4 for m in opt.mu) + 8}
    print(f"  (g) the (1, 2) checkpoint loaded in the parent (no process group): "
          f"{len(sd)} tensors bit-equal to the ranks' gathered weights: {same}; files "
          + "; ".join(f"{d} {sizes[d]} = {sum(sizes[d].values()):,} bytes against one copy "
                      f"{one_copy[d]:,}" for d in sizes))
    require(same, "the sharded checkpoint differs from the gathered weights")
    for d, files in sizes.items():
        require(one_copy[d] <= sum(files.values()) <= 1.05 * one_copy[d],
                f"{d}: {sum(files.values())} bytes against one copy {one_copy[d]}")


def remat_policies(torch, ops, card) -> dict:
    """Phase 15 (c): phase 5's bf16 base.en 8 x 2 step with the --fused_ln
    config under each remat policy: step ms, peak device memory, exact
    launches; then the f32 gradients of each policy against "none"'s."""
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from whisper_context_biasing_tpu_torch.train.step import (
        accumulate_microbatch_grads,
        make_loss_fn,
    )

    gc.collect()  # earlier phases' cycles (the loops' closures) hold device tensors
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}
    layers = N_LAYERS + N_LAYERS
    uses = N_LAYERS + 2 * N_LAYERS           # flash sites a microbatch
    sites = 2 * N_LAYERS + 3 * N_LAYERS      # fused sites a microbatch
    rerun = {"none": (0, 0), "full": (uses, sites), "dots": (uses, sites),
             "wide": (0, layers)}            # the MLP sites' K5 alone
    peaks, total = {}, {}
    for policy in REMAT_POLICIES:
        cfg = get_config("base.en", dtype="bfloat16", flash_attention=True, remat=policy,
                         **FUSED_LN)
        model = build_model(cfg, seed=0, device="cuda", train=True)
        opt = make_optimizer(peak_lr=1e-5, warmup_steps=50, total_steps=1000)
        step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM, mel_on_device=True)
        state = init_train_state(model, opt)
        state, _ = step(state, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peaks[policy] = torch.cuda.max_memory_allocated()
        counts = dict(ops.launches)
        f, u = rerun[policy]
        want = {"mel": ACCUM, "flash_attention": ACCUM * (uses + f),
                "flash_attention_bwd": ACCUM * uses, "fused_ln_matmul": ACCUM * (sites + u)}
        print(f"  (c) remat={policy}: step {ms:.1f} ms, peak device memory "
              f"{peaks[policy] / 2**30:.3f} GiB, loss {float(m['loss']):.4f}, launches "
              f"{counts}  [{card}]")
        require(np.isfinite(float(m["loss"])), f"remat={policy}: non-finite loss")
        require(counts == want, f"remat={policy}: launches {counts} != {want}")
        add_counts(total, counts)
        del model, opt, step, state
        torch.cuda.empty_cache()
    require(peaks["full"] <= peaks["dots"] <= peaks["none"]
            and peaks["full"] <= peaks["wide"] <= peaks["none"],
            f"remat peaks out of order: {peaks}")
    grads = {}
    for policy in REMAT_POLICIES:
        cfg = get_config("base.en", dtype="float32", flash_attention=True, remat=policy,
                         **FUSED_LN)
        model = build_model(cfg, seed=0, device="cuda", train=True)
        accumulate_microbatch_grads(make_loss_fn(cfg, 1.5, mel_on_device=True), model, batch,
                                    ACCUM)
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
        del model
    rels = {p: grads_within(f"f32 remat={p} vs none", grads[p], grads["none"])
            for p in REMAT_POLICIES[1:]}
    print(f"  (c) f32 gradients against remat=none's, |g - g_none| / |g_none|: "
          + ", ".join(f"{p} {r:.2e}" for p, r in rels.items()) + " (limit 1e-4)")
    return total


# ---------------------------------------------------------------------------
# phase 15 (g): distillation, LoRA and the sharded checkpoint under the mesh
# ---------------------------------------------------------------------------

G_OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=100)  # (g)'s checkpoint steps
G_STEPS = 2


def lora_loop_launches(cfg) -> dict:
    """Phase 14 (a)'s loop (2 steps of 8 x 2 on short labels, one eval
    batch): the launches its steps and its eval imply."""
    evals = -(-ENTRY_ROWS["dev"] // BATCH)
    want = expected_train_launches(cfg, 2, s=0, mel=False)
    want["flash_attention"] += evals * cfg.n_audio_layers
    if cfg.fused_ln_qkv:
        want["fused_ln_matmul"] += evals * 2 * cfg.n_audio_layers
    return want


def distill_f32_steps(torch, ops, mesh=None) -> dict:
    """(g) phase 14 (b)'s pair (base.en teacher, tiny.en student, phase 5's
    8 x 2 raw-audio batch, labels of 449 tokens) in f32 with every kernel,
    G_STEPS steps, both models sharded over ``mesh``: each step's metrics,
    the first step's student gradients gathered whole, the launches and
    those the recorded forwards imply."""
    from whisper_context_biasing_tpu_torch.models import build_model, get_config
    from whisper_context_biasing_tpu_torch.parallel import shard_batch, shard_params
    from whisper_context_biasing_tpu_torch.parallel.sharding import gather_tensor
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        make_distill_step,
        make_optimizer,
    )
    from whisper_context_biasing_tpu_torch.train import distill as distill_mod

    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items() if k != "bias_spans"}
    kw = dict(dtype="float32", flash_attention=True, remat="full")
    cfg_t, cfg_d = get_config("base.en", **kw), get_config("tiny.en", **kw)
    teacher = build_model(cfg_t, seed=0, device="cuda")
    student = build_model(cfg_d, seed=1, device="cuda", train=True)
    if mesh is not None:
        teacher, student = shard_params(teacher, mesh), shard_params(student, mesh)
        batch = shard_batch(batch, mesh, extra_leading_axes=1)
    opt = make_optimizer(peak_lr=1e-4, warmup_steps=0, total_steps=100)
    step = make_distill_step(cfg_d, cfg_t, opt, grad_accum=ACCUM, mesh=mesh)
    state = init_train_state(student, opt)
    calls = []
    real = count_forwards(torch, distill_mod, calls)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        metrics, grads = [], None
        t0 = time.perf_counter()
        for _ in range(G_STEPS):
            state, m = step(state, teacher, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if grads is None:
                grads = {n: gather_tensor(student, n, p.grad).cpu()
                         for n, p in student.named_parameters()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
    finally:
        distill_mod.forward = real
    want = dict(mel=G_STEPS * ACCUM, **forward_launches(calls))
    del teacher, student, state, step
    torch.cuda.empty_cache()
    return dict(metrics=metrics, grads=grads, launches=counts, implied=want, wall_s=wall)


def lora_f32_loop(torch, ops, corpus, out, fused, mesh=None) -> dict:
    """(g) phase 14 (a)'s ``train_and_evaluate`` (LoRA rank 8 and
    SpecAugment over phase 10's corpus, 8 x 2, 2 steps, an eval, a save) in
    f32 with every kernel (and ``fused``: --fused_ln) under ``mesh``, its
    checkpoint through the sharded backend: the logged losses, the first
    step's adapter gradients gathered whole, the launches and those the loop
    implies."""
    from whisper_context_biasing_tpu_torch.data import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.models import get_config, init_state_dict
    from whisper_context_biasing_tpu_torch.train import TrainingConfig, train_and_evaluate
    from whisper_context_biasing_tpu_torch.train import lora as lora_mod

    import pathlib

    tok, data = phase14_datasets(pathlib.Path(corpus))
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop, pad_to_multiple=32)
    cfg = get_config("base.en", dtype="float32", flash_attention=True, remat="full",
                     **(FUSED_LN if fused else {}))
    tcfg = TrainingConfig(output_dir=str(out), per_device_train_batch_size=BATCH,
                          gradient_accumulation_steps=ACCUM, num_train_epochs=2,
                          eval_steps=2, save_steps=2, logging_steps=1, learning_rate=1e-3,
                          per_device_eval_batch_size=BATCH, generation_max_length=EVAL_MAX_LEN,
                          lora_rank=LORA_RANK, spec_augment=True, checkpoint_backend="orbax",
                          dataloader_num_workers=2)
    first = []
    real = lora_mod.make_lora_grad_fn

    def recording(*args, **kwargs):  # keeps the first step's adapter gradients
        fn = real(*args, **kwargs)

        def grad_fn(adapters, base, batch):
            loss, grads = fn(adapters, base, batch)
            if not first:
                first.append(([g.clone() for g in grads], adapters, base.tp))
            return loss, grads
        return grad_fn

    lora_mod.make_lora_grad_fn = recording
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, hist = train_and_evaluate(cfg, init_state_dict(get_config("base.en"), 0), tok,
                                     data["train"], data["dev"], coll, tcfg, mesh=mesh,
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launches)
    finally:
        lora_mod.make_lora_grad_fn = real
    grads, adapters, tp = first[0]
    tree: dict = {}
    for ((top, blk, t, ab), _), g in zip(lora_mod._leaves(adapters), grads):
        tree.setdefault(top, {}).setdefault(blk, {}).setdefault(t, {})[ab] = g
    whole, _ = lora_mod.lora_host_arrays(tree, tp=tp)  # collective over "model"
    torch.cuda.empty_cache()
    return dict(losses=[e["loss"] for e in hist if "loss" in e],
                wers=[e["eval_wer"] for e in hist if "eval_wer" in e],
                grads={"/".join(p): torch.from_numpy(x) for p, x in lora_mod._leaves(whole)},
                launches=counts, implied=lora_loop_launches(cfg), wall_s=wall)


def ckpt_cfg():
    from whisper_context_biasing_tpu_torch.models import get_config

    return get_config("base.en", dtype="float32", flash_attention=True, remat="full")


def ckpt_model(torch, mesh=None, state_dict=None):
    """(g)'s checkpointed fine-tune: phase 5's f32 configuration (flash,
    remat full, mel in the step) from the seeded init or ``state_dict``,
    sharded over ``mesh``; (model, step function, optimizer)."""
    from whisper_context_biasing_tpu_torch.models import build_model
    from whisper_context_biasing_tpu_torch.parallel import shard_params
    from whisper_context_biasing_tpu_torch.train import make_optimizer, make_train_step

    cfg = ckpt_cfg()
    model = build_model(cfg, state_dict, seed=0, device="cuda", train=True)
    if mesh is not None:
        model = shard_params(model, mesh)
    opt = make_optimizer(**G_OPT)
    step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM, mel_on_device=True,
                           mesh=mesh)
    return model, step, opt


def parallel_train_refs(torch, ops, corpus, tmp) -> dict:
    """(g)'s unsharded references, in the parent: the distillation steps,
    the two LoRA loops and the checkpointed fine-tune's two losses."""
    from whisper_context_biasing_tpu_torch.train import init_train_state

    t0 = time.perf_counter()
    ref = {"distill": distill_f32_steps(torch, ops)}
    for fused in (False, True):
        name = "lora_fused" if fused else "lora"
        ref[name] = lora_f32_loop(torch, ops, corpus, os.path.join(tmp, f"ref_{name}"), fused)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}
    model, step, opt = ckpt_model(torch)
    state = init_train_state(model, opt)
    ref["ckpt_losses"] = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
    del model, step, opt, state
    torch.cuda.empty_cache()
    for k in ("distill", "lora", "lora_fused"):
        require(ref[k]["launches"] == ref[k]["implied"], f"(g) unsharded {k}: launches "
                f"{ref[k]['launches']} != {ref[k]['implied']}")
    ref["wall_s"] = time.perf_counter() - t0
    return ref


def parallel_train(torch, ops, rank: int, label: str, mesh, ref: dict, workdir: str) -> dict:
    """Phase 15 (g) on one rank at one mesh: the f32 distillation steps and
    the two LoRA loops held to the unsharded references (losses rel 1e-5,
    agreement equal, the first step's gradients phase 6's rule, launches
    exactly what the rank's loop implies: at (1, 2) phase 14's); then at
    (1, 2) a step of the checkpointed fine-tune saved through the sharded
    backend from the card's tensors (and the gathered weights beside it for
    the parent), at (2, 1) that checkpoint resumed for the next step."""
    from whisper_context_biasing_tpu_torch.parallel import gather_params, shard_batch
    from whisper_context_biasing_tpu_torch.parallel.sharding import shard_opt_state
    from whisper_context_biasing_tpu_torch.train import (
        init_train_state,
        load_checkpoint,
        save_checkpoint,
    )

    res = {}
    what = f"(g) rank {rank} mesh {label}"
    got = distill_f32_steps(torch, ops, mesh)
    want = ref["distill"]
    rels = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
            for g, w in zip(got["metrics"], want["metrics"])]
    require(max(rels) <= 1e-5, f"{what}: distillation losses {got['metrics']} vs "
            f"{want['metrics']}")
    require([g["agreement"] for g in got["metrics"]] ==
            [w["agreement"] for w in want["metrics"]], f"{what}: distillation agreement differs")
    require(got["launches"] == got["implied"], f"{what}: distillation launches "
            f"{got['launches']} != {got['implied']}")
    if label == "tp":  # phase 14 (b)'s a step: K1 2, K2 84, K4 24
        require(got["launches"] == {"mel": 2 * G_STEPS, "flash_attention": 84 * G_STEPS,
                                    "flash_attention_bwd": 24 * G_STEPS},
                f"{what}: distillation launches {got['launches']}")
    res["distill"] = dict(loss_rel=max(rels), agreement=[g["agreement"] for g in got["metrics"]],
                          grad_rel=grads_within(f"{what} distillation", got["grads"],
                                                want["grads"]),
                          launches=got["launches"], wall_s=got["wall_s"])
    for fused in (False, True):
        name = "lora_fused" if fused else "lora"
        corpus = os.path.join(os.path.dirname(workdir), "corpus")
        got = lora_f32_loop(torch, ops, corpus, os.path.join(workdir, f"{name}_{label}"), fused,
                            mesh)
        want = ref[name]
        rels = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
        require(len(got["losses"]) == 2 and max(rels) <= 1e-5,
                f"{what}: {name} losses {got['losses']} vs {want['losses']}")
        require(got["launches"] == got["implied"] == want["launches"],
                f"{what}: {name} launches {got['launches']} != {got['implied']}")
        res[name] = dict(loss_rel=max(rels), launches=got["launches"], wall_s=got["wall_s"],
                         wers=[got["wers"], want["wers"]],
                         grad_rel=grads_within(f"{what} {name}", got["grads"], want["grads"]))
    batch = shard_batch({k: torch.from_numpy(v).cuda() for k, v in train_batch(
        np.random.default_rng(7)).items()}, mesh, extra_leading_axes=1)
    path = os.path.join(workdir, "sharded", "checkpoint-1")
    if label == "tp":  # save at (1, 2)
        model, step, opt = ckpt_model(torch, mesh)
        state = init_train_state(model, opt)
        loss = float(step(state, batch)[1]["loss"])
        t0 = time.perf_counter()
        save_checkpoint(os.path.dirname(path), 1, model, state.opt_state, backend="orbax",
                        mesh=mesh)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        whole = {n: t.cpu() for n, t in gather_params(model).items()}
        if rank == 0:
            torch.save(whole, os.path.join(workdir, "gathered.pt"))
        i = 0
    else:  # resume at (2, 1) for the next step
        sd, opt_state, meta = load_checkpoint(path, ckpt_cfg(), load_opt_state=True)
        model, step, opt = ckpt_model(torch, mesh, sd)
        state = init_train_state(model, opt)
        opt_state = shard_opt_state(opt_state, model, mesh)
        opt_state.mu = [m.cuda() for m in opt_state.mu]
        opt_state.nu = [v.cuda() for v in opt_state.nu]
        state.opt_state, state.step = opt_state, meta["step"]
        loss = float(step(state, batch)[1]["loss"])
        save_s, i = None, 1
    rel = abs(loss - ref["ckpt_losses"][i]) / abs(ref["ckpt_losses"][i])
    require(rel <= 1e-5, f"{what}: checkpointed step {i + 1} loss {loss} vs "
            f"{ref['ckpt_losses'][i]}")
    res["ckpt"] = dict(step=i + 1, loss=loss, loss_rel=rel, save_s=save_s)
    del model, step, opt, state
    torch.cuda.empty_cache()
    return res


def world_of_one(torch, ops, Pipeline, card, serve_tokens, init_path, tmp) -> dict:
    """Phase 15 (a): a world of one over NCCL with ``make_mesh(1)``: phase
    5's f32 step gives the unsharded loss (1e-6), a DCP checkpoint of the
    model saved and read back bit-equal, phase 3's requests phase 3's
    tokens and launches, ``cli.train`` under ``torchrun
    --nproc_per_node 1`` runs one step, and ``--model_parallelism 2`` on
    that world raises JAX's ValueError."""
    import torch.distributed as dist

    from whisper_context_biasing_tpu_torch.cli import train as train_cli
    from whisper_context_biasing_tpu_torch.parallel import make_mesh
    from whisper_context_biasing_tpu_torch.train import load_checkpoint, save_checkpoint

    total = {}
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous1", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(1)
        require(tuple(mesh.shape) == (1, 1), f"make_mesh(1) gave {mesh.shape}")
        plain, _, _ = f32_step(torch, ops)
        meshed, _, counts = f32_step(torch, ops, mesh)
        print(f"  (a) world of one (NCCL), mesh (1, 1): f32 step loss {meshed:.7f} vs "
              f"{plain:.7f} without the mesh (limit rel 1e-6)")
        require(abs(meshed - plain) <= 1e-6 * abs(plain), "world-of-one f32 loss differs")
        add_counts(total, counts)
        # (g)'s sharded checkpoint over NCCL: saved from the card, read back whole
        model = ckpt_model(torch, mesh)[0]
        path = save_checkpoint(os.path.join(tmp, "nccl_dcp"), 1, model, backend="orbax",
                               mesh=mesh)
        sd, _, _ = load_checkpoint(path, ckpt_cfg())
        same = all(torch.equal(sd[n], p.detach().cpu()) for n, p in model.named_parameters())
        print(f"  (a) a DCP checkpoint saved over NCCL at (1, 1) and read back: {len(sd)} "
              f"tensors bit-equal: {same}")
        require(same, "the NCCL world's DCP checkpoint differs from the model")
        del model
        pipe = Pipeline("base.en", device="cuda", seed=0)
        pipe.mesh = mesh
        kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0,
                      max_tokens=MAX_TOKENS)
        clips = requests(np.random.default_rng(4))
        ops.reset_launch_counts()
        res = pipe.transcribe(clips, **kwargs)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        same = [r.tokens for r in res] == serve_tokens
        print(f"  (a) phase 3's requests on the mesh: tokens identical to phase 3: {same}; "
              f"launches {counts}")
        require(same, "world-of-one serving tokens differ from phase 3's")
        add_counts(total, counts)
        del pipe
        corpus, out = os.path.join(tmp, "corpus"), os.path.join(tmp, "torchrun_run")
        argv = ["--model", "base.en", "--data_root", corpus, "--data_dir", "audio",
                "--jsonl_data", os.path.join(corpus, "jsonl"), "--output", out,
                "--init_checkpoint", str(init_path), "--batch", str(BATCH),
                "--grad_accum", "1", "--epoch", "0.5", "--eval_steps", "100",
                "--save_steps", "100", "--logging_steps", "1", "--eval_batch", str(BATCH)]
        try:
            train_cli.main([*argv, "--model_parallelism", "2"])
            err = None
        except ValueError as e:
            err = str(e)
        print(f"  (a) cli.train --model_parallelism 2 on the world of one: ValueError "
              f"'{err}'")
        require(err == "1 devices not divisible by model_parallelism=2",
                f"--model_parallelism 2 on a world of one: {err!r}")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", "-m",
                          "whisper_context_biasing_tpu_torch.cli.train", *argv],
                         capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    log = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))] \
        if run.returncode == 0 else []
    print(f"  (a) torchrun --nproc_per_node 1 cli.train: exit {run.returncode}, log {log}, "
          f"{wall:.1f} s wall")
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:])
    require(run.returncode == 0, "cli.train under torchrun failed")
    require([e["step"] for e in log if "loss" in e] == [1]
            and os.path.isfile(os.path.join(out, "test_results.json")),
            "cli.train under torchrun did not run one step and its test eval")
    return total


# phase 15 (d)-(f): the serving routes under the mesh
# ---------------------------------------------------------------------------

SERVE_MEDUSA_HEADS = 2  # (d)'s heads: at 1 and 3 chains
SAMPLED_T = 0.2         # (e)'s rung, forced by a log-prob threshold of 0
SERVE_START_S = 300     # (f): a server that has not bound its port by then fails
SERVE_EXIT_S = 120      # (f): every rank exits within this after SIGTERM


class PassRecorder:
    """The model passes inside, wherever the package holds ``encode_audio``
    and ``decode_tokens``: each encoder pass implies one K2 launch a layer of
    its model, and each single-token decoder pass of an int8 cross-K/V model
    one K3 launch a decoder layer (the other passes take the plain int8 path).
    A greedy step replayed from its captured graph is such a pass too; the
    pass recorded while capturing runs nothing. ``implied(mel_calls)`` is
    the launches the loop reports."""

    def __enter__(self):
        import torch
        from whisper_context_biasing_tpu_torch.decode import greedy
        from whisper_context_biasing_tpu_torch.models import whisper

        self.k2 = self.k3 = self.encoder_passes = self.decoder_steps = 0
        enc, dec = whisper.encode_audio, whisper.decode_tokens

        def encode(model, *a, **kw):
            self.encoder_passes += 1
            self.k2 += model.cfg.n_audio_layers
            return enc(model, *a, **kw)

        def step(model):
            cfg = model.cfg
            if cfg.quantize_cross_kv and cfg.fused_quant_cross:
                self.decoder_steps += 1
                self.k3 += cfg.n_text_layers

        def decode(model, tokens, *a, **kw):
            capturing = tokens.is_cuda and torch.cuda.is_current_stream_capturing()
            if tokens.shape[1] == 1 and not capturing:
                step(model)
            return dec(model, tokens, *a, **kw)

        graph_step = self.graph_step = greedy._StepGraph.step

        def replayed(graph, model, *a):
            graph_step(graph, model, *a)
            if graph.graph is not None:  # this step was a replay
                step(model)

        greedy._StepGraph.step = replayed
        self.patched = []
        for n, m in list(sys.modules.items()):
            if n.startswith("whisper_context_biasing_tpu_torch"):
                for name, fn, new in (("encode_audio", enc, encode),
                                      ("decode_tokens", dec, decode)):
                    if getattr(m, name, None) is fn:
                        setattr(m, name, new)
                        self.patched.append((m, name, fn))
        return self

    def __exit__(self, *exc):
        from whisper_context_biasing_tpu_torch.decode import greedy

        greedy._StepGraph.step = self.graph_step
        for m, name, fn in self.patched:
            setattr(m, name, fn)

    def implied(self, mel_calls: int) -> dict:
        want = {"mel": mel_calls, "flash_attention": self.k2, "quant_cross_attention": self.k3}
        return {k: v for k, v in want.items() if v}


def word_rows(words) -> list:
    return [[w.word, w.start, w.end, w.probability] for w in words]


def serving_routes(torch, ops, mp: int, host_windows: bool = False,
                   sampled: bool = False) -> dict:
    """Phase 15 (d), and (e) with ``sampled``, in f32 with every kernel on
    ``Pipeline("base.en", model_parallelism=mp)`` (0: one device, the
    references): phase 3's requests with phase 13's random tiny.en draft
    (k 4), with the target as its own draft and with 2 Medusa heads at 1 and
    3 chains; phase 11's clips at t=0 with timestamps and words ("long";
    under tensor parallelism its 48 s clip alone, "long48", to keep the
    script's time; the references run both); phase 12's chunked batch
    (``host_windows`` also with the windows cut on the host);
    (e) phase 11's clips on the ladder (0, 0.2) with a log-prob threshold of
    0, so every window takes the 0.2 rung, on a CUDA generator, with each
    row's first uniform. Per route: its output, launches, the launches its
    loop implies, and its mel calls, encoder passes and decoder steps."""
    from whisper_context_biasing_tpu_torch import Pipeline
    from whisper_context_biasing_tpu_torch.decode import (
        greedy,
        transcribe_chunked,
        transcribe_long_batch,
    )
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    pipe = Pipeline("base.en", device=DEVICE, seed=0, dtype="float32", draft_model=DRAFT,
                    speculative_k=SPEC_K, model_parallelism=mp)
    tok = pipe.tokenizer
    mel_calls = counted_mel(pipe)
    draft = pipe.draft
    heads = init_medusa_params(pipe.cfg, SERVE_MEDUSA_HEADS, 0)
    clips = requests(np.random.default_rng(4))
    rng = np.random.default_rng(11)
    long_clips = [synthetic_audio(rng, x) for x in LONG_CLIPS_S]
    kwargs = dict(context=CONTEXT, bias_words=BIAS_WORDS, bias_boost=2.0, max_tokens=MAX_TOKENS)
    chunk_kw = dict(mel_fn=pipe.mel, max_new=MAX_TOKENS, max_batch=CHUNKED_BATCH,
                    pad_batches=True, temperatures=(0.0,), return_segments=True,
                    window_samples=pipe.window_samples, mesh=pipe.mesh, device=DEVICE)

    def short(**attrs):
        for k, v in attrs.items():
            setattr(pipe, k, v)
        return [r.tokens for r in pipe.transcribe(clips, **kwargs)]

    def long_form(clips_):
        pipe.medusa = None
        res = pipe.transcribe(clips_, long_form=True, timestamps=True, word_timestamps=True,
                              temperatures=(0.0,), **kwargs)
        return [[r.tokens for r in res], [[list(x) for x in r.segments] for r in res],
                [word_rows(r.words) for r in res]]

    def chunked(windows):
        toks, segs = transcribe_chunked(pipe.model, tok, chunked_clips(),
                                        device_windows=windows, **chunk_kw)
        return [toks, [[list(x) for x in f] for f in segs]]

    # each sampled decode call's first uniforms, and at every step each
    # row's slack: the distance of its uniform from the CDF bounds of the
    # token it drew (a share of the whole mass)
    draws, slacks = [], []
    real_next, real_sample = greedy.RowDraws.next, greedy.sample_tokens

    def first_draws(self):
        u = real_next(self)
        if not getattr(self, "seen", False):
            self.seen = True
            draws.append(u.tolist())
            slacks.append([])
        self.u = u
        return u

    def sample(lg, temperature, u):
        pick = real_sample(lg, temperature, u)
        probs = torch.softmax(lg / temperature, dim=-1)
        cdf = torch.cumsum(probs, dim=-1)  # as sample_tokens sums it
        x = u * cdf[:, -1]
        hi = cdf.gather(1, pick[:, None])[:, 0]
        lo = hi - probs.gather(1, pick[:, None])[:, 0]
        slack = torch.minimum((x - lo).abs(), (hi - x).abs()) / cdf[:, -1]
        slacks[-1].append(slack.tolist())
        return pick

    def sampled_rung():
        gen = torch.Generator(device=DEVICE).manual_seed(1234)
        greedy.RowDraws.next, greedy.sample_tokens = first_draws, sample
        try:
            toks, info = transcribe_long_batch(
                pipe.model, tok, long_clips, mel_fn=pipe.mel, max_new=MAX_TOKENS,
                temperatures=(0.0, SAMPLED_T), logprob_threshold=0.0,
                compression_ratio_threshold=None, no_speech_threshold=None,
                return_window_info=True, window_samples=pipe.window_samples, generator=gen,
                mesh=pipe.mesh, device=DEVICE)
        finally:
            greedy.RowDraws.next, greedy.sample_tokens = real_next, real_sample
        return [toks, [[w["temperature"] for w in f] for f in info], draws[0], slacks]

    routes = {"draft": lambda: short(draft=draft),
              "self_draft": lambda: short(draft=pipe.model, draft_cfg=pipe.cfg),
              "medusa1": lambda: short(draft=None, medusa=dict(heads, n_chains=1)),
              "medusa3": lambda: short(draft=None, medusa=dict(heads, n_chains=3))}
    if mp != TP:
        routes["long"] = lambda: long_form(long_clips)
    if mp != 1:
        routes["long48"] = lambda: long_form(long_clips[1:])
    routes["chunked"] = lambda: chunked(True)
    if host_windows:
        routes["chunked_host"] = lambda: chunked(False)
    if sampled:
        routes["sampled"] = sampled_rung
    out = {}
    for name, run in routes.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        del mel_calls[:]
        t0 = time.perf_counter()
        # the greedy routes' decode calls, with their top-2 gaps (phase 4's rule)
        with PassRecorder() as rec, PathRecorder(margins=True) as path:
            got = run()
            torch.cuda.synchronize()
        out[name] = dict(out=got, launches=dict(ops.launches), implied=rec.implied(len(mel_calls)),
                         loop=[len(mel_calls), rec.encoder_passes, rec.decoder_steps],
                         wall_s=time.perf_counter() - t0,
                         calls=[{k: None if v is None else v.tolist() for k, v in c.items()
                                 if k != "steps"} for c in path.calls])
    del pipe, routes
    gc.collect()  # counted_mel's closure holds the pipeline in a cycle: free its weights now
    torch.cuda.empty_cache()
    return out


def same_words(a, b) -> bool:
    """Word rows equal, the probabilities within f32 rounding."""
    return (len(a) == len(b) and all(
        len(x) == len(y) and all(u[:3] == v[:3] and abs(u[3] - v[3]) <= 1e-5
                                 for u, v in zip(x, y)) for x, y in zip(a, b)))


def near_tie_only(calls: list, ref_calls: list, first: int = 0) -> tuple[bool, str]:
    """Phase 4's rule on a route's greedy decode calls against the unsharded
    run's: as many calls, and the first divergence at a plain top-2 logit
    gap < 1e-4 (the rest, which it may steer, not compared). Returns (held,
    what diverged where)."""
    if not calls or len(calls) != len(ref_calls):
        return False, f"{len(calls)} decode calls against {len(ref_calls)}"
    for ci, (c, r) in enumerate(zip(calls, ref_calls)):
        diff = np.argwhere(np.asarray(c["tokens"]) != np.asarray(r["tokens"]))
        if diff.size:
            row, step = (int(x) for x in diff[0])
            gap = r["margins"][row][step]
            return gap < 1e-4, (f"decode call {first + ci} row {row} diverges at step {step}, "
                                f"the unsharded top-2 logit gap {gap:.3e} (limit 1e-4)")
    return False, "no decode call diverges"


SLACK = 1e-4  # (e): a draw this close to a CDF bound may flip with f32 sums


def boundary_only(g: dict, want: dict) -> tuple[bool, str]:
    """(e)'s rule when the tokens differ: the ladder's decode calls
    alternate t = 0 (rejected by the threshold) and the sampled rung; a t = 0
    call may diverge only at a near-tie (phase 4's rule), and the first
    sampled call that diverges must do so where the unsharded run's draw lay
    within SLACK of its token's CDF bound (the rest, steered by it, not
    compared)."""
    calls, ref_calls = g["calls"], want["calls"]
    ref_slacks = want["out"][3]
    if len(calls) != len(ref_calls) or len(ref_calls) != 2 * len(ref_slacks):
        return False, f"{len(calls)} decode calls against {len(ref_calls)}"
    notes = []
    for ci, (c, r) in enumerate(zip(calls, ref_calls)):
        diff = np.argwhere(np.asarray(c["tokens"]) != np.asarray(r["tokens"]))
        if not diff.size:
            continue
        row, step = (int(x) for x in diff[0])
        if ci % 2 == 0:
            held, note = near_tie_only([c], [r], ci)
            notes.append(note)
            if not held:
                return False, "; ".join(notes)
            continue
        slack = ref_slacks[ci // 2][step][row]
        notes.append(f"sampled call {ci} row {row} diverges at step {step}, where the "
                     f"unsharded draw lay {slack:.3e} of the mass from its token's CDF bound "
                     f"(limit {SLACK})")
        return slack < SLACK, "; ".join(notes)
    return False, "no decode call diverges"


def hold_routes(label: str, got: dict, ref: dict, tp: bool) -> None:
    """Phase 15 (d)-(e)'s gates for one rank and mesh: every route's output
    equals the unsharded run's (the words' probabilities within f32
    rounding; (e)'s draws are the rank's rows of the unsharded run's; a
    greedy route may diverge only at a near-tie, phase 4's rule), its
    launches are what its loop implies and, under tensor parallelism alone,
    the unsharded run's."""
    for name, g in got.items():
        want = ref["chunked" if name == "chunked_host" else name]
        if name.startswith("long"):
            same = g["out"][:2] == want["out"][:2] and same_words(g["out"][2], want["out"][2])
        elif name == "sampled":
            require(all(t == [SAMPLED_T] * len(t) for t in g["out"][1]),
                    f"{label} sampled: a window missed the {SAMPLED_T} rung")
            same = g["out"][:2] == want["out"][:2]
            if not same:
                same, g["divergence"] = boundary_only(g, want)
        else:
            same = g["out"] == want["out"]
        if not same and name != "sampled":
            same, g["divergence"] = near_tie_only(g["calls"], want["calls"])
        require(same, f"{label} {name}: the output differs from the unsharded run's: "
                f"{g.get('divergence')}")
        require(g["launches"] == g["implied"], f"{label} {name}: launches {g['launches']} != "
                f"what the loop implies {g['implied']}")
        if tp and "divergence" not in g:  # a divergence may take other steps
            require(g["launches"] == want["launches"], f"{label} {name}: launches "
                    f"{g['launches']} != the unsharded run's {want['launches']}")


REPLY_FLOATS = ("avg_logprob", "no_speech_prob", "probability")


def split_floats(x, out: list):
    """A server reply with the model's float outputs (``REPLY_FLOATS``:
    f32 sums in another order under "model") taken out into ``out``."""
    if isinstance(x, dict):
        return {k: (out.append(v) if k in REPLY_FLOATS else split_floats(v, out))
                for k, v in x.items()}
    if isinstance(x, list):
        return [split_floats(v, out) for v in x]
    return x


SERVERS = (("one rank, NCCL", 1, []),
           ("two ranks, gloo, --model_parallelism 2", 2, ["--model_parallelism", "2"]),
           ("two ranks, gloo, --model_parallelism 1", 2, ["--model_parallelism", "1"]))


def serve_rank(argv) -> int:
    """A rank of phase 15 (f)'s server (this script with ``--serve-rank``
    under ``torchrun``): ``cli.serve``'s ``main`` with the model in f32."""
    from whisper_context_biasing_tpu_torch.cli import serve
    from whisper_context_biasing_tpu_torch.models import FAST_OVERRIDES, get_config

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return serve.main(argv, config=get_config("base.en", dtype="float32", **FAST_OVERRIDES))


def start_servers(init_path, tmp) -> list:
    """Phase 15 (f)'s three ``cli.serve`` launches (f32, ``serve_rank``)
    under ``torchrun``, started together, each on a free port with its log
    in ``tmp``: one rank over NCCL (no mesh: the one-device server), then two
    ranks sharing the card (gloo: more ranks than cards) at
    ``--model_parallelism 2`` and 1. Returns [label, process, port, log
    path, start]."""
    import socket

    servers = []
    for label, nproc, extra in SERVERS:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        log_path = os.path.join(tmp, f"serve_{len(servers)}.log")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(nproc), os.path.abspath(__file__), "--serve-rank",
                "--init_checkpoint", str(init_path), "--host", "127.0.0.1", "--port", str(port),
                "--batch", str(BATCH), "--max_wait_ms", "250", "--max_tokens", str(MAX_TOKENS),
                "--timestamps", "--temperatures", "0.0", "--bias_words", *BIAS_WORDS,
                "--bias_boost", "2.0", "--device", DEVICE, *extra]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                    cwd=os.path.dirname(os.path.abspath(__file__)))
        servers.append([label, proc, port, log_path, time.perf_counter()])
    return servers


def stop_servers(servers) -> None:
    """Kill what is left of the servers (after a failure), and say why."""
    for label, proc, _, log_path, _ in servers:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            print(f"  (f) {label} exited {proc.returncode}:\n{open(log_path).read()[-4000:]}")


def drive_servers(card, servers) -> None:
    """Phase 15 (f): each server, once it has bound its port, gets phase 12
    (f)'s posts (8 concurrent with a context, a 75 s post with window info,
    a word-timestamp post) and a stream session (the 75 s clip in 1 s
    chunks), the three at once; the sharded servers' replies equal the
    one-device server's, ``latency_ms`` aside and the model's probabilities
    within 1e-5; SIGTERM to each rank 0 ends every rank with exit 0 within
    SERVE_EXIT_S."""
    import http.client
    import io
    import signal
    import threading
    import wave

    def wav(audio):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    clips = requests(np.random.default_rng(4))
    long_clip = chunked_clips()[1]
    pcm = (np.clip(long_clip, -1, 1) * 32767).astype("<i2")

    def drive(port, out):
        def call(path, body=b"", headers=None):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            c.request("POST", path, body=body, headers=headers or {})
            r = c.getresponse()
            reply = json.loads(r.read())
            c.close()
            reply.pop("latency_ms", None)
            return [r.status, reply]

        t0 = time.perf_counter()
        replies = [None] * BATCH

        def post(i):
            replies[i] = call("/transcribe", wav(clips[i]), {"X-Context": CONTEXT})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        replies.append(call("/transcribe", wav(long_clip), {"X-Window-Info": "1"}))
        replies.append(call("/transcribe", wav(clips[2]), {"X-Word-Timestamps": "1"}))
        status, opened = call("/stream", headers={"X-Context": CONTEXT})
        replies.append(status)
        sid = opened["session"]
        replies += [call(f"/stream/{sid}", pcm[i: i + 16000].tobytes())
                    for i in range(0, pcm.size, 16000)]
        replies.append(call(f"/stream/{sid}/end"))
        out.update(replies=replies, served=time.perf_counter() - t0)

    pids, runs = [], [{} for _ in servers]
    for label, proc, _, log_path, t0 in servers:
        found = None
        while found is None:
            require(proc.poll() is None, f"(f) {label}: the server exited {proc.returncode}")
            require(time.perf_counter() - t0 < SERVE_START_S,
                    f"(f) {label}: no port bound in {SERVE_START_S} s")
            found = re.search(r"serving on \S+ \(\S+, pid (\d+)\)", open(log_path).read())
            time.sleep(0.2)
        pids.append(int(found.group(1)))
    started = time.perf_counter()
    threads = [threading.Thread(target=drive, args=(srv[2], run))
               for srv, run in zip(servers, runs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    served = time.perf_counter() - started
    t1 = time.perf_counter()
    for pid in pids:
        os.kill(pid, signal.SIGTERM)
    codes = [srv[1].wait(timeout=SERVE_EXIT_S) for srv in servers]
    exited = time.perf_counter() - t1
    for (label, *_), run, code in zip(servers, runs, codes):
        require(code == 0, f"(f) {label}: torchrun exited {code} after SIGTERM to rank 0")
        require("replies" in run, f"(f) {label}: the posts did not finish")
        statuses = [r if isinstance(r, int) else r[0] for r in run["replies"]]
        print(f"(f) cli.serve under torchrun, {label}: {len(statuses)} replies, all 200: "
              f"{set(statuses) == {200}}, served in {run['served']:.1f} s (the three at once "
              f"on the card)  [{card}]")
        require(set(statuses) == {200}, f"(f) {label}: statuses {statuses}")
    ref = runs[0]["replies"]
    for (label, *_), run in zip(servers[1:], runs[1:]):
        got_f, want_f = [], []
        same = split_floats(run["replies"], got_f) == split_floats(ref, want_f)
        worst = max((abs(a - b) for a, b in zip(got_f, want_f)), default=0.0)
        print(f"  (f) {label}: replies equal the one-device server's apart from the "
              f"model's {len(want_f)} log-probabilities and word probabilities: {same}; "
              f"those within {worst:.2e} of its (limit 1e-5)")
        require(same and len(got_f) == len(want_f) and worst <= 1e-5,
                f"(f) {label}: the replies differ from the one-device server's")
    require(ref[BATCH][1].get("windows") and ref[BATCH + 1][1].get("words")
            and ref[-1][1]["text"], "(f) the window, word or stream fields are missing")
    print(f"  (f) the three servers bound their ports by {started - servers[0][4]:.1f} s after "
          f"their launch (loaded and warmed up meanwhile), served in {served:.1f} s, and every "
          f"rank of the three exited 0 within {exited:.1f} s of SIGTERM to its rank 0  [{card}]")


def parallelism_and_remat(torch, Pipeline, ops, card, serve_tokens, f32_tokens, init_path,
                          tmp) -> dict:
    """Phase 15: (a) a world of one, (b) two ranks on the card with (d) and
    (e) the serving routes and (g) distillation, LoRA and the sharded
    checkpoint on them, (f) ``cli.serve`` under ``torchrun``, (c) the remat
    policies. Returns the launches of (a), (b), (d), (e), (g) (both ranks)
    and (c)."""
    from concurrent.futures import ThreadPoolExecutor

    start = time.perf_counter()
    total = world_of_one(torch, ops, Pipeline, card, serve_tokens, init_path, tmp)
    t = time.perf_counter()
    print(f"  (a) took {t - start:.1f} s")
    servers = start_servers(init_path, tmp)
    pool = ThreadPoolExecutor(1)
    try:
        served = pool.submit(drive_servers, card, servers)  # (f) beside (b)-(e)
        add_counts(total, two_ranks(torch, ops, card, f32_tokens, tmp))
        print(f"  (b), (d), (e), (g) took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        served.result()
        print(f"  (f) took {time.perf_counter() - t:.1f} s after (e)")
    finally:
        stop_servers(servers)  # after a failure elsewhere, this ends (f)'s posts too
        pool.shutdown()
    t = time.perf_counter()
    add_counts(total, remat_policies(torch, ops, card))
    print(f"  (c) took {time.perf_counter() - t:.1f} s")
    print(f"  phase 15 took {time.perf_counter() - start:.1f} s  [{card}]")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="TABLE_PATH",
                    help="also profile one serving run, one training step and one "
                         "fused training step: device time by kernel, the full profiler "
                         "tables written to TABLE_PATH, TABLE_PATH.train and "
                         "TABLE_PATH.fused")
    ap.add_argument("--kernels-only", metavar="TREE", nargs="?", const=".",
                    help="stop after checking and timing the five kernels (phase 2) and "
                         "print no result line; TREE (default: this checkout) is the "
                         "checkout whose package to run, e.g. an unpacked earlier commit, to "
                         "time two versions in turns on one card")
    ap.add_argument("--flash-only", metavar="TREE", nargs="?", const=".",
                    help="as --kernels-only, for the flash kernels (K2, K4) alone")
    ap.add_argument("--parallel-rank", nargs=2, metavar=("RANK", "WORKDIR"),
                    help=argparse.SUPPRESS)  # phase 15 (b) spawns its ranks this way
    ap.add_argument("--serve-rank", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)  # phase 15 (f)'s servers, under torchrun
    args = ap.parse_args()
    tree = args.kernels_only or args.flash_only

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.parallel_rank:
        return parallel_rank(int(args.parallel_rank[0]), args.parallel_rank[1])
    if args.serve_rank is not None:
        return serve_rank(args.serve_rank)
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    from whisper_context_biasing_tpu_torch import Pipeline, ops
    from whisper_context_biasing_tpu_torch.ops import _build
    from whisper_context_biasing_tpu_torch.utils.flops import H100_BF16_FLOPS

    global PEAK_BF16_FLOP_S
    PEAK_BF16_FLOP_S = H100_BF16_FLOPS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    # true f32 everywhere: the mel frontend and the f32 comparison need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = t0 = time.perf_counter()
    out = _build.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s into {out}")
    print_build_logs(out)
    print_kernel_info(card)
    if args.flash_only and not args.kernels_only:
        check_flash(torch, ops)
        check_flash_bwd(torch, ops)
        print(f"chip_smoke --flash-only {os.path.abspath(tree)} took "
              f"{time.perf_counter() - start:.1f} s  [{card}]")
        return 0

    kernels = [check_mel(torch, ops), check_flash(torch, ops), check_flash_bwd(torch, ops),
               check_quant_cross(torch, ops), check_fused_ln(torch, ops)]
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}, library {k['library_ms']}) [{card}]")
    check_bucket_shapes(torch, ops)
    check_draft_shapes(torch, ops)
    check_width_shapes(torch, ops)
    check_tp_shapes(torch, ops)
    if tree:
        print(f"chip_smoke --kernels-only {os.path.abspath(tree)} took "
              f"{time.perf_counter() - start:.1f} s  [{card}]")
        return 0
    phase = time.perf_counter()
    print(f"phases 1-2 took {phase - start:.1f} s")
    serve_counts, serve_tokens = serve(torch, Pipeline, ops, card, args.profile)
    f32_tokens = f32_agreement(torch, Pipeline, ops)
    train_counts, walls = train(torch, ops, card, args.profile and args.profile + ".train")
    train_f32_agreement(torch, ops)
    print(f"phases 3-6 took {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    fused_counts, _ = train(torch, ops, card, args.profile and args.profile + ".fused",
                            fused=True, baseline=walls)
    train_f32_agreement(torch, ops, fused=True)
    entry_counts = entry_point(torch, ops, card)
    print(f"phases 7-9 took {time.perf_counter() - phase:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        print("phase 10, the reference's entry points (safetensors, Pipeline(checkpoint=), "
              "cli.train, cli.export_hf, cli.evaluation):")
        cli_counts, init_path = entry_points(torch, ops, card, serve_counts, serve_tokens, tmp)
        print("phase 11, long-form and beam serving (Pipeline long-form, beam, sampling, "
              "language id, cli.transcribe):")
        long_counts = long_form_and_beam(torch, Pipeline, ops, card, init_path, tmp)
        print("phase 12, the rest of serving (chunked long-form, word timestamps, window "
              "buckets, streaming, cli.serve):")
        rest_counts = rest_of_serving(torch, Pipeline, ops, card, init_path)
        print("phase 13, speculative and Medusa decoding (a draft, a self-draft, Medusa heads, "
              "cli.medusa, the CLIs and the server with them, long-form, int8 decoder "
              "weights):")
        spec_counts = speculative_and_medusa(torch, Pipeline, ops, card, init_path, tmp)
        print("phase 14, training extensions and the last entry points (LoRA, SpecAugment, "
              "distillation, cli.distill, two mel frontends, cli.acceptance, the check "
              "harnesses):")
        ext_counts = training_extensions(torch, ops, card, init_path, tmp)
        print("phase 15, data and tensor parallelism (a world of one over NCCL, two ranks "
              "on the card over gloo at mesh (1, 2) and (2, 1) with every serving route, "
              "distillation, LoRA and the sharded checkpoint, cli.serve under torchrun) and "
              "the remat policies:")
        par_counts = parallelism_and_remat(torch, Pipeline, ops, card, serve_tokens,
                                           f32_tokens, init_path, tmp)
    # launches: the runs of the main-path phases (3, 5, 7, 9, 10, 11, 12, 13, 14, 15)
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in (serve_counts, train_counts,
                                                          fused_counts, entry_counts,
                                                          cli_counts, long_counts, rest_counts,
                                                          spec_counts, ext_counts, par_counts))
        require(k["launches"] > 0, f"the main path never launched {k['name']}")
    print(f"chip_smoke total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
