"""Batch transcription on the card: the port's counterpart of the JAX
package's ``scripts/transcribe.py``, with its flags plus ``--device``.

    python -m whisper_context_biasing_tpu_torch.cli.transcribe --model base.en \\
        --audio a.wav b.wav [--bias_words aspirin --bias_boost 2.0] \\
        [--context "clinical description"] [--num_beams 5] \\
        [--long [--chunked] --timestamps --format srt --output_dir out/] \\
        [--word_timestamps] [--language auto] [--task translate] \\
        [--init_checkpoint model.safetensors]

Short-form (one window a file: greedy or beam; WAV files decode through the
native C++ runtime where it builds) or, with ``--long``, sequential
long-form with the temperature ladder, the no-speech rule, the VAD gate or
clip ranges, and timestamp segments; ``--long --chunked`` decodes all
windows in parallel (mono 16 kHz 16-bit WAVs cross to the card as int16).
``--word_timestamps`` adds per-word times by cross-attention alignment on
every route; short-form ``--format srt|vtt`` turns it on to time its cues.
On a card the serving fast path is on (the mel, flash and int8
cross-attention kernels, int8 cross-K/V, tanh gelu) unless ``--exact``.
Greedy decoding runs speculatively with the same output: ``--draft_model``
(with ``--draft_checkpoint`` and ``--spec_k``) proposes with a draft model,
``--medusa medusa.npz`` (from ``cli.medusa``; ``--medusa_chains``) with
Medusa heads, which win over a draft; in long-form they drive the t=0 rung.
Under ``torchrun`` every route (short-form, ``--long``, ``--chunked``, with
a draft or Medusa heads) shards its batches over "data" as ``Pipeline``'s
default mesh does, the draft too (the JAX script runs one device); rank 0
writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave

import numpy as np
import torch

from .._device import resolve_device
from ..audio import load_audio, native, pad_or_trim, pcm_to_float32, select_mel_frontend
from ..data.collator import SpeechSeq2SeqCollator
from ..decode import (
    beam_decode_batch,
    decode_batch,
    detect_language,
    find_word_timestamps,
    load_draft,
    medusa_decode_batch,
    resolve_start_tokens,
    speculative_decode_batch,
    transcribe_chunked,
    transcribe_long_batch,
    unpack_long_form,
)
from ..models import (
    FAST_OVERRIDES,
    build_model,
    get_config,
    load_checkpoint_or_safetensors,
    load_medusa,
)
from ..parallel import auto_mesh, initialize_multihost, shard_params
from ..parallel.multihost import process_index
from ..tokenizer import load_tokenizer
from ..utils import warn_missing_assets
from ..utils.subtitles import close_open_segments, format_srt, format_vtt, words_to_segments


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batch transcription")
    p.add_argument("--audio", nargs="+", required=True, help="audio files")
    p.add_argument("--model", default="base.en")
    p.add_argument("--init_checkpoint", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    p.add_argument("--context", default=None,
                   help="conditioning text prepended after <|startofprev|>")
    p.add_argument("--bias_words", nargs="*", default=None)
    p.add_argument("--bias_boost", type=float, default=0.0)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--draft_model", default=None,
                   help="speculative decoding: small draft model family (e.g. tiny.en for "
                        "base.en); output equals plain greedy")
    p.add_argument("--draft_checkpoint", default=None)
    p.add_argument("--spec_k", type=int, default=4,
                   help="draft tokens proposed per verification round")
    p.add_argument("--medusa", default=None,
                   help="medusa.npz from cli.medusa: self-speculative decoding with "
                        "multi-token heads (wins over --draft_model)")
    p.add_argument("--medusa_chains", type=int, default=None,
                   help="Medusa tree chains: branch on head 1's top-N (default: the value "
                        "saved in medusa.npz, else 1)")
    p.add_argument("--beam_early_stopping", choices=["off", "true", "false", "never"],
                   default="off",
                   help="off = frozen-beam pool; true/false/never = HF generate semantics")
    p.add_argument("--max_tokens", type=int, default=224)
    p.add_argument("--long", action="store_true",
                   help="long-form mode: sequential windows with history conditioning")
    p.add_argument("--chunked", action="store_true",
                   help="with --long: decode all windows in parallel with overlapping strides "
                        "and merge (segment-core ownership with --timestamps, LCS token merge "
                        "without); no history conditioning")
    p.add_argument("--vad", action="store_true",
                   help="energy VAD: long-form windows with no detected speech are skipped")
    p.add_argument("--clip_timestamps", default=None,
                   help='decode ONLY these second-ranges, e.g. "0-30,65-90" (long-form; wins '
                        "over --vad)")
    p.add_argument("--timestamps", action="store_true",
                   help="long-form: timestamp-conditioned seeking and <|t|> segment output")
    p.add_argument("--temperatures", type=float, nargs="*",
                   default=[0.0, 0.2, 0.4, 0.6, 0.8, 1.0],
                   help="long-form fallback ladder")
    p.add_argument("--prompt_reset_on_temperature", type=float, default=0.5,
                   help="a window from a rung hotter than this clears the history prompt "
                        "(nan disables)")
    p.add_argument("--best_of", type=int, default=1,
                   help="sampled fallback rungs draw N candidates; the best average "
                        "logprob wins")
    p.add_argument("--compression_ratio_threshold", type=float, default=2.4)
    p.add_argument("--logprob_threshold", type=float, default=-1.0,
                   help="avg token logprob below this triggers fallback; nan disables")
    p.add_argument("--no_speech_threshold", type=float, default=0.6,
                   help="long-form: windows with P(<|nospeech|>) above this (and avg logprob "
                        "below --logprob_threshold) emit nothing; nan disables")
    p.add_argument("--language", default=None,
                   help="multilingual models: a language code, or 'auto' to detect per file")
    p.add_argument("--task", choices=["transcribe", "translate"], default="transcribe")
    p.add_argument("--window_info", action="store_true",
                   help="long-form: per-window QC dicts in the JSON output")
    p.add_argument("--word_timestamps", action="store_true",
                   help="per-word start/end times by cross-attention DTW alignment")
    p.add_argument("--alignment_heads", default=None,
                   help="comma-separated layer:head pairs for alignment (e.g. '4:3,5:0'); "
                        "default: the published set of a stock geometry, else all heads of "
                        "the top half of the decoder layers")
    p.add_argument("--format", choices=["text", "json", "srt", "vtt"], default=None,
                   help="output format; srt/vtt need timed segments (--long --timestamps, or "
                        "word alignment, which short-form turns on)")
    p.add_argument("--output_dir", default=None,
                   help="write one <basename>.<format> file per input")
    p.add_argument("--json", action="store_true", help="alias for --format json")
    p.add_argument("--exact", action="store_true",
                   help="no serving approximations (kernels, int8 cross-K/V, tanh gelu)")
    # the port's own
    p.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return p.parse_args(argv)


def output_format(args) -> str:
    return args.format or ("json" if args.json else "text")


def nan_off(x):
    """A threshold of nan means "disabled"."""
    return None if x is None or x != x else x


def parse_alignment_heads(spec):
    """'4:3,5:0' -> [(4, 3), (5, 0)] (None/empty -> None)."""
    if not spec:
        return None
    try:
        return [tuple(int(x) for x in pair.split(":")) for pair in spec.split(",")]
    except ValueError:
        raise SystemExit(f"--alignment_heads must be comma-separated layer:head pairs, "
                         f"got {spec!r}")


def parse_clip_timestamps(spec):
    """'0-30,65-90' -> [(0.0, 30.0), (65.0, 90.0)] (None/empty -> None)."""
    if not spec:
        return None
    try:
        out = []
        for rng in spec.split(","):
            s, e = rng.split("-")
            out.append((float(s), float(e)))
        return out
    except ValueError:
        raise SystemExit(f"--clip_timestamps must be comma-separated start-end second ranges "
                         f"like '0-30,65-90', got {spec!r}")


def build_starts(args, tokenizer, model, n, mel_thunk):
    """Per-file decode start sequences from --language/--task
    (``resolve_start_tokens``); ``mel_thunk`` computes the detection mel only
    when detection runs. Returns (starts | None, langs)."""
    if not tokenizer.multilingual:
        if args.language or args.task == "translate":
            print("warning: --language/--task need a multilingual model; ignored",
                  file=sys.stderr)
        return None, [None] * n

    def detect():
        detected = detect_language(model, tokenizer, mel_thunk())
        print("detected: " + ", ".join(f"{lang} ({p:.2f})" for lang, p in detected),
              file=sys.stderr)
        return detected

    try:
        return resolve_start_tokens(tokenizer, n, language=args.language, task=args.task,
                                    detect=detect)
    except ValueError as e:
        raise SystemExit(str(e))


def emit(args, fmt, path, text, segments, words=None, language=None, windows=None) -> str:
    """One input file's output in the chosen format."""
    if fmt == "json":
        rec = {"file": path, "text": text}
        if language:
            rec["language"] = language
        if windows is not None:
            rec["windows"] = windows
        if segments is not None:
            rec["segments"] = [{"start": round(a, 3), "end": round(e, 3), "text": t.strip()}
                               for a, e, t in segments]
        if words is not None:
            rec["words"] = [{"word": w.word.strip(), "start": w.start, "end": w.end,
                             "probability": w.probability} for w in words]
        return json.dumps(rec)
    if fmt in ("srt", "vtt"):
        if segments is None:
            raise SystemExit(f"--format {fmt} needs timed segments (--long --timestamps or "
                             "--word_timestamps)")
        return (format_srt if fmt == "srt" else format_vtt)(segments)
    if words is not None:
        stamped = " ".join(f"{w.word.strip()}[{w.start:.2f}-{w.end:.2f}]" for w in words)
        return f"{path}: {stamped or text}"
    if segments is not None and args.timestamps:
        return f"{path}: " + " ".join(f"[{a:.2f}-{e:.2f}]{t}" for a, e, t in segments)
    return f"{path}: {text}"


def write_outputs(args, fmt, rendered) -> None:
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        ext = {"text": "txt", "json": "json", "srt": "srt", "vtt": "vtt"}[fmt]
        for path, out in zip(args.audio, rendered):
            base = os.path.splitext(os.path.basename(path))[0]
            dest = os.path.join(args.output_dir, f"{base}.{ext}")
            with open(dest, "w") as f:
                f.write(out if out.endswith("\n") else out + "\n")
            print(f"wrote {dest}", file=sys.stderr)
    else:
        joiner = "\n" if fmt in ("srt", "vtt") else ""
        for i, out in enumerate(rendered):
            if fmt in ("srt", "vtt") and len(rendered) > 1:
                print(f"# {args.audio[i]}")
            print(out, end=joiner + "\n" if not out.endswith("\n") else joiner)


@torch.no_grad()
def main(argv=None):
    args = parse_args(argv)
    fmt = output_format(args)
    initialize_multihost(device=args.device)
    device = resolve_device(args.device)
    # Pipeline's default mesh: data parallel over a multi-process launch
    mesh = auto_mesh(1)
    tokenizer = load_tokenizer(args.vocab, args.merges,
                               multilingual=not args.model.endswith(".en"))
    fast = device.type == "cuda" and not args.exact
    cfg = get_config(args.model, dtype="bfloat16", **(FAST_OVERRIDES if fast else {}))
    warn_missing_assets(args.vocab, args.init_checkpoint, "transcribe")
    state = None
    if args.init_checkpoint:
        state, cfg = load_checkpoint_or_safetensors(args.init_checkpoint, cfg)
    model = build_model(cfg, state, seed=0, device=device)
    if mesh is not None:
        model = shard_params(model, mesh)
    frontend = select_mel_frontend()

    def make_mel(chunk, n_mels=None):
        return frontend(torch.as_tensor(chunk, dtype=torch.float32, device=device),
                        n_mels=n_mels or cfg.n_mels)

    def draft_model():
        dmodel, dcfg = load_draft(args.draft_model, args.draft_checkpoint,
                                  overrides=FAST_OVERRIDES if fast else {}, target_cfg=cfg,
                                  device=device)
        return (dmodel if mesh is None else shard_params(dmodel, mesh)), dcfg

    contexts = spans = None
    n = len(args.audio)
    if args.context:
        contexts = [tokenizer.encode(args.context.lower(), add_special_tokens=False)] * n
    if args.bias_words:
        coll = SpeechSeq2SeqCollator(pad_token_id=tokenizer.pad_token_id,
                                     decoder_start_token_id=tokenizer.sot,
                                     bias_span_pad_id=tokenizer.eot)
        words = [tokenizer.encode(w.lower(), add_special_tokens=False) for w in args.bias_words]
        spans = coll.pad_bias_spans([words] * n)
    heads = parse_alignment_heads(args.alignment_heads)

    t0 = time.time()
    if (args.vad or args.clip_timestamps) and not args.long:
        print("warning: --vad/--clip_timestamps gate long-form windows; ignored on the "
              "single-window path (use --long)", file=sys.stderr)
    if args.window_info and not args.long:
        print("warning: --window_info reports long-form window QC; ignored on the "
              "single-window path (use --long)", file=sys.stderr)
    if args.long:
        # beams drive the t=0 rung over Medusa and a draft; Medusa wins over
        # a draft, which must share the target's mel
        medusa = draft = None
        if args.medusa:
            medusa = load_medusa(args.medusa, n_chains=args.medusa_chains)
            if args.num_beams > 1:
                print("warning: --num_beams > 1 takes the beam path at temperature 0; "
                      "--medusa heads unused in long-form", file=sys.stderr)
        if args.num_beams > 1 and args.draft_model:
            print("warning: --num_beams > 1 takes the beam path; --draft_model ignored in "
                  "long-form", file=sys.stderr)
        elif medusa is not None and args.draft_model:
            print("warning: --medusa wins over --draft_model; draft ignored", file=sys.stderr)
        elif args.draft_model:
            dmodel, dcfg = draft_model()
            if dcfg.n_mels != cfg.n_mels:
                print("warning: --draft_model n_mels mismatch; speculative long-form "
                      "disabled", file=sys.stderr)
            else:
                draft = (dmodel, dcfg, args.spec_k)
        # the chunked decoder normalizes on the card: mono 16 kHz 16-bit WAVs
        # cross as int16, half the bytes
        raw = [load_audio(p, keep_int16=args.chunked) for p in args.audio]
        # language detection reads the first window of each file
        starts, langs = build_starts(args, tokenizer, model, n, lambda: make_mel(np.stack(
            [pad_or_trim(pcm_to_float32(a[:480000])) for a in raw])))
        common = dict(
            mel_fn=make_mel, max_new=args.max_tokens, contexts=contexts, bias_spans=spans,
            bias_boost=args.bias_boost, use_timestamps=args.timestamps,
            temperatures=tuple(args.temperatures), best_of=args.best_of,
            compression_ratio_threshold=args.compression_ratio_threshold,
            logprob_threshold=nan_off(args.logprob_threshold),
            no_speech_threshold=nan_off(args.no_speech_threshold), start_tokens=starts,
            return_segments=True, num_beams=args.num_beams,
            beam_early_stopping=args.beam_early_stopping,
            word_timestamps=args.word_timestamps, alignment_heads=heads,
            vad=parse_clip_timestamps(args.clip_timestamps) or args.vad,
            return_window_info=args.window_info, medusa=medusa, draft=draft, mesh=mesh,
            device=device)
        if args.chunked:
            out = transcribe_chunked(model, tokenizer, raw, prefix_pad_to_multiple=32, **common)
        else:
            out = transcribe_long_batch(
                model, tokenizer, raw,
                prompt_reset_on_temperature=nan_off(args.prompt_reset_on_temperature), **common)
        hyps, segments, long_words, winfo = unpack_long_form(
            out, return_segments=True, word_timestamps=args.word_timestamps,
            return_window_info=args.window_info)
        audio_seconds = sum(len(a) for a in raw) / 16000
        segs, words = [], []
        for i in range(n):
            lw = long_words[i] if long_words is not None else None
            seg = close_open_segments(segments[i], clip_end=len(raw[i]) / 16000)
            if lw is not None and not args.timestamps:
                seg = words_to_segments(lw)  # word-derived cues
            segs.append(seg)
            words.append(lw)
    else:
        if native.available() and all(p.lower().endswith(".wav") for p in args.audio):
            audio = native.decode_batch(args.audio, fixed_len=480000)
            # true durations from the WAV headers
            true_lengths = []
            for path in args.audio:
                with wave.open(path, "rb") as w:
                    true_lengths.append(min(int(w.getnframes() * 16000 / w.getframerate()),
                                            480000))
        else:
            raw = [load_audio(p) for p in args.audio]
            true_lengths = [min(len(a), 480000) for a in raw]
            audio = np.stack([pad_or_trim(a) for a in raw])
        mel = make_mel(audio)
        starts, langs = build_starts(args, tokenizer, model, n, lambda: mel)
        kwargs = dict(contexts=contexts, max_new=args.max_tokens, bias_spans=spans,
                      bias_boost=args.bias_boost, starts=starts, device=device)

        if args.num_beams > 1:
            for flag in ("draft_model", "medusa"):
                if getattr(args, flag):
                    print(f"warning: --{flag} is greedy-only; ignored with --num_beams > 1",
                          file=sys.stderr)
            hyps = beam_decode_batch(model, tokenizer, mel, num_beams=args.num_beams,
                                     early_stopping=args.beam_early_stopping, mesh=mesh,
                                     **kwargs)
        elif args.medusa:
            hyps = medusa_decode_batch(model, load_medusa(args.medusa,
                                                          n_chains=args.medusa_chains),
                                       tokenizer, mel, mesh=mesh, **kwargs)
        elif args.draft_model:
            dmodel, dcfg = draft_model()
            mel_d = make_mel(audio, n_mels=dcfg.n_mels) if dcfg.n_mels != cfg.n_mels else None
            hyps = speculative_decode_batch(dmodel, model, tokenizer, mel, k=args.spec_k,
                                            input_features_draft=mel_d, mesh=mesh, **kwargs)
        else:
            hyps = decode_batch(model, tokenizer, mel, mesh=mesh, **kwargs)
        audio_seconds = sum(true_lengths) / 16000
        winfo = None
        segs = words = [None] * n
        # srt/vtt need timed segments: word alignment turns on
        if args.word_timestamps or fmt in ("srt", "vtt"):
            words = find_word_timestamps(model, tokenizer, mel, hyps, starts=starts,
                                         num_frames=[t // 320 for t in true_lengths],
                                         alignment_heads=heads)
            segs = [words_to_segments(w) for w in words]
    wall = time.time() - t0
    rendered = []
    for i, (path, h) in enumerate(zip(args.audio, hyps)):
        text = tokenizer.decode(h, skip_special_tokens=True).strip()
        rendered.append(emit(args, fmt, path, text, segs[i], words[i], language=langs[i],
                             windows=winfo[i] if winfo else None))
    if process_index() != 0:  # rank 0 alone writes
        return hyps
    write_outputs(args, fmt, rendered)
    print(f"[{n} files, {audio_seconds:.1f}s audio in {wall:.2f}s "
          f"= {audio_seconds / max(wall, 1e-9):.1f}x realtime]", file=sys.stderr)
    return hyps


if __name__ == "__main__":
    main()
