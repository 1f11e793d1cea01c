"""Acceptance sweep: the five BASELINE.json configs as one command, the
port's counterpart of the JAX package's ``scripts/acceptance.py``, with its
flags plus ``--device``::

    python -m whisper_context_biasing_tpu_torch.cli.acceptance --configs 1,2,3,4,5

Runs each config end to end (decode -> refs_and_pred artifact -> WER/B-WER
-> RTF; config 3 is the WeightCE fine-tune path) and writes one JSON
summary, ``<output>/acceptance.json``, in the JAX script's schema,
asserting the <=1% relative WER delta against the recomputed reference
numbers (BASELINE.md) wherever a config maps to a committed reference
artifact:

  1. whisper-tiny greedy decode, single clip + 10-word bias list (CPU)
  2. whisper-base beam search (k=5) with the bias-list logits processor
  3. whisper-small WeightCE fine-tune (collator + train path)
  4. whisper-medium batched decode with description-prompt conditioning
     -> results/refs_and_pred_desc_only.txt (WER 8.33 / B-WER 45.05)
  5. whisper-large-v3 medical test sweep, no prompt
     -> refs_and_pred_baseline_ko_prompt.txt (WER 12.40 / B-WER 57.28)

Real-asset mode (``--vocab``/``--merges``, ``--weights_dir``,
``--data_root``) and the offline mode (byte-fallback tokenizer, seeded
random weights, synthesized audio for the jsonl rows, the asserts that
need real assets reported as skipped) are the JAX script's; it exits 1
only on a FAIL. Unlike the JAX script's, the asset probe opens no network
connection (``egress`` is null), and it names no host path: the reference
mirror is
``WCB_REFERENCE_ROOT``, further asset roots ``WCB_ASSET_ROOTS``
(``os.pathsep``-separated), beside the HF hub cache.

Config 1 runs on the CPU, as the reference forces it; configs 2-5 run on
``--device`` (the card by default), at the full width of each model,
through the port's kernels: the log-mel kernel for the dataset's features,
the flash forward in the encoders (and the flash backward in config 3's
step), int8 cross-K/V with the int8 cross-attention kernel in the decode
steps. Random weights are drawn on that device. On the CPU the configs are
the JAX script's defaults (no kernel switches).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import wave

import numpy as np
import torch

from .._device import resolve_device
from ..audio import load_audio, pad_or_trim
from ..data import PromptWhisperDataset, SpeechSeq2SeqCollator
from ..metrics import (
    compute_bias_wer,
    compute_bias_wer_from_words,
    corpus_wer,
    parse_refs_and_pred_file,
)
from ..models import (
    build_model,
    get_config,
    init_state_dict,
    load_checkpoint_or_safetensors,
    load_medusa,
)
from ..ops.mel_kernel import log_mel_spectrogram_fused
from ..tokenizer import load_tokenizer
from ..train import TrainingConfig, evaluate_wer, train_and_evaluate
from ..train.checkpoint import is_native_checkpoint

# the reference repo's mirror (its jsonl corpora and eval artifacts), where
# WCB_REFERENCE_ROOT names one
REFERENCE_ROOT = os.environ.get("WCB_REFERENCE_ROOT", "")


def _reference(*parts) -> str:
    """A path in the reference mirror, or "" without one."""
    return os.path.join(REFERENCE_ROOT, *parts) if REFERENCE_ROOT else ""


# committed-artifact ground truth (BASELINE.md; recomputed values)
BASELINES = {
    "desc_only_dev": {"artifact": "results/refs_and_pred_desc_only.txt",
                      "bias": "data/all_dev_with_bias_list.jsonl",
                      "wer": 8.33, "bias_wer": 45.05},
    "baseline_test": {"artifact": "results/refs_and_pred_baseline_ko_prompt.txt",
                      "bias": "data/medical-united-syn-med-75-jsonl/test.jsonl",
                      "wer": 12.40, "bias_wer": 57.28},
}

# the kernel switches of a config on the card
DECODE_KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
TRAIN_KERNELS = dict(flash_attention=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Five-config BASELINE acceptance sweep")
    p.add_argument("--vocab", default=os.environ.get("WCB_VOCAB"))
    p.add_argument("--merges", default=os.environ.get("WCB_MERGES"))
    p.add_argument("--weights_dir", default=os.environ.get("WCB_WEIGHTS_DIR"),
                   help="dir with per-model weights (see module docstring)")
    p.add_argument("--data_root", default=os.environ.get("WCB_DATA_ROOT", ""),
                   help="root of the audio tree (reference --data_root)")
    p.add_argument("--jsonl_root", default=None,
                   help="dir with the reference jsonl corpora "
                        "(default: <reference>/data)")
    p.add_argument("--output", default="acceptance_out")
    p.add_argument("--configs", default="1,2,3,4,5",
                   help="comma-separated subset of configs to run")
    p.add_argument("--limit", type=int, default=0,
                   help="max utterances per decode config (0 = 4 offline / "
                        "full corpus with real assets)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--train_epochs", type=float, default=1)
    p.add_argument("--max_new", type=int, default=224)
    p.add_argument("--medusa", default=os.environ.get("WCB_MEDUSA"),
                   help="medusa.npz: self-speculative eval decode for the "
                        "greedy configs (identical WER, faster sweep)")
    p.add_argument("--medusa_chains", type=int, default=None,
                   help="override the npz-stamped n_chains (tree-attention "
                        "chain branching width)")
    p.add_argument("--wer_tolerance", type=float, default=0.01,
                   help="relative WER delta allowed vs baseline (north star: 1%%)")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of configs 2-5 (config 1 runs on the CPU)")
    return p.parse_args(argv)


def probe_assets(args):
    """Best-effort real-asset discovery, recorded in the summary: scans the
    HF hub cache and the asset roots for a Whisper tokenizer, per-model
    weights and corpus audio, auto-wires anything found into ``args``, and
    reports why the model-parity asserts stayed skipped."""
    probe = {"probed": [], "found": {}, "egress": None}

    hub_cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    extra = os.environ.get("WCB_ASSET_ROOTS", "")
    roots = [os.path.join(hub_cache, "hub"), *filter(None, extra.split(os.pathsep)),
             _reference("assets")]
    tok_pats = ["**/tokenizer.json", "**/vocab.json"]
    wts_pats = ["**/model.safetensors", "**/params.npz", "**/*whisper*/**/*.safetensors"]
    audio_pats = ["**/*.wav", "**/*.mp3", "**/*.flac"]
    for root in filter(None, roots):
        probe["probed"].append(root)
        if not os.path.isdir(root):
            continue

        def first(pats):
            for pat in pats:
                hits = glob.glob(os.path.join(root, pat), recursive=True)
                if hits:
                    return sorted(hits)[0]
            return None

        for key, pats in (("tokenizer", tok_pats), ("weights", wts_pats),
                          ("audio", audio_pats)):
            hit = first(pats)
            if hit and key not in probe["found"]:
                probe["found"][key] = hit

    # reference mirror: jsonl text corpora are committed, audio is not —
    # record both facts so the summary names the gap precisely
    ref_audio = None
    for pat in ("**/*.wav", "**/*.mp3") if REFERENCE_ROOT else ():
        hits = glob.glob(_reference(pat), recursive=True)
        if hits:
            ref_audio = hits[0]
            break
    probe["reference_mirror"] = {
        "jsonl": os.path.isdir(_reference("data", "medical-united-syn-med-75-jsonl")),
        "audio": ref_audio,
        "eval_artifacts": os.path.isfile(_reference("results",
                                                    "refs_and_pred_desc_only.txt")),
    }

    # the JAX script tries a 3 s TCP connect to the Hub here; the port opens
    # no connection, so hub egress stays unknown
    probe["egress_error"] = "not probed: the sweep opens no network connection"

    # auto-wire discoveries (explicit flags/env always win)
    tok = probe["found"].get("tokenizer")
    if tok and not args.vocab:
        if tok.endswith("vocab.json"):
            merges = os.path.join(os.path.dirname(tok), "merges.txt")
            if os.path.isfile(merges):
                args.vocab, args.merges = tok, merges
        else:
            args.vocab = tok
    wts = probe["found"].get("weights")
    if wts and not args.weights_dir:
        args.weights_dir = os.path.dirname(os.path.dirname(wts))

    missing = [k for k in ("tokenizer", "weights", "audio") if k not in probe["found"]]
    if missing:
        probe["outcome"] = (
            "unresolved: no " + "/".join(missing) + " in any probed root, "
            + "hub egress not probed"
            + "; model-parity asserts stay skipped (offline mode)")
    else:
        probe["outcome"] = "resolved: real-asset mode armed"
    return probe


def resolve_weights(weights_dir, model):
    if not weights_dir:
        return None
    for cand in (
        os.path.join(weights_dir, model, "model.safetensors"),
        os.path.join(weights_dir, f"{model}.safetensors"),
        os.path.join(weights_dir, model),
    ):
        if os.path.isfile(cand) or is_native_checkpoint(cand):
            return cand
    return None


def load_rows(jsonl_root, rel, limit):
    """Rows from a reference jsonl; builtin sample rows if unavailable."""
    path = os.path.join(jsonl_root, rel) if jsonl_root else None
    rows = []
    if path and os.path.isfile(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
                if limit and len(rows) >= limit:
                    break
    if not rows:  # no reference mounted: minimal self-contained sample
        rows = [
            {"id": "0", "file": "s0.mp3", "text": "Take aspirin twice daily.",
             "description": "Aspirin for cardiac prophylaxis.",
             "bias_words": ["aspirin"]},
            {"id": "1", "file": "s1.mp3", "text": "Promisec treats acid reflux.",
             "description": "Promisec proton pump inhibitor.",
             "bias_words": ["Promisec"]},
        ][: limit or 2]
    return rows


def stage_corpus(out_dir, phase, rows, data_root, rel_audio_dir):
    """Write <out>/jsonl/<phase>.jsonl; synthesize WAVs for rows whose real
    audio is missing. Returns (base_path, jsonl_dir, audio_seconds, real_audio)."""
    jsonl_dir = os.path.join(out_dir, "jsonl")
    os.makedirs(jsonl_dir, exist_ok=True)
    real_base = os.path.join(data_root, rel_audio_dir) if data_root else ""
    have_real = bool(real_base) and all(
        os.path.isfile(os.path.join(real_base, phase, r["file"])) for r in rows)
    audio_s = 0.0
    if have_real:
        base = real_base
        for r in rows:
            audio_s += len(load_audio(os.path.join(base, phase, r["file"]))) / 16000.0
    else:
        base = os.path.join(out_dir, "audio")
        d = os.path.join(base, phase)
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(0)
        rows = [dict(r, file=os.path.splitext(r["file"])[0] + ".wav") for r in rows]
        for r in rows:
            secs = 2.0
            sig = (rng.standard_normal(int(16000 * secs)) * 3000).astype(np.int16)
            with wave.open(os.path.join(d, r["file"]), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(sig.tobytes())
            audio_s += secs
    with open(os.path.join(jsonl_dir, f"{phase}.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return base, jsonl_dir, audio_s, have_real


def metric_parity_asserts(tolerance):
    """Offline-provable: the metric stack must reproduce BASELINE.md from
    the committed reference artifacts."""
    out = []
    for key, b in BASELINES.items():
        art, bias_path = _reference(b["artifact"]), _reference(b["bias"])
        if not (os.path.isfile(art) and os.path.isfile(bias_path)):
            out.append({"assert": f"metric_parity:{key}", "status": "skipped",
                        "reason": "reference artifacts not mounted"})
            continue
        refs, preds = parse_refs_and_pred_file(art)
        wer = 100 * corpus_wer(refs, preds)
        bias_lists = []
        with open(bias_path) as f:
            for line in f:
                if line.strip():
                    bias_lists.append(
                        [w.lower() for w in json.loads(line).get("bias_words", [])])
        bwer = compute_bias_wer_from_words(refs, preds, bias_lists).bias_wer
        ok = (abs(wer - b["wer"]) / b["wer"] <= tolerance
              and abs(bwer - b["bias_wer"]) / b["bias_wer"] <= tolerance)
        out.append({"assert": f"metric_parity:{key}", "status": "pass" if ok else "FAIL",
                    "wer": round(wer, 4), "bias_wer": round(bwer, 4),
                    "expected": {"wer": b["wer"], "bias_wer": b["bias_wer"]}})
    return out


def card_features(n_mels: int, device: torch.device):
    """The dataset's feature extractor on ``device``: the mel kernel on a
    30 s window, (n_mels, 3000) numpy, as ``log_mel_spectrogram_np`` gives."""
    def extract(audio):
        x = torch.from_numpy(pad_or_trim(audio)).to(device)
        return log_mel_spectrogram_fused(x[None], n_mels=n_mels)[0].cpu().numpy()

    return extract


def _config_and_weights(num, model, args, device, kernels):
    """(cfg, state dict, weights path or None): real weights when
    ``--weights_dir`` has them, else the seeded init drawn on ``device``."""
    cfg = get_config(model, **(kernels if device.type == "cuda" else {}))
    weights = resolve_weights(args.weights_dir, model)
    if weights:
        params, cfg = load_checkpoint_or_safetensors(weights, cfg)
    else:
        print(f"[config {num}] no weights for {model}: random init — "
              "outputs are not real transcripts")
        params = init_state_dict(cfg, 0, device=device)
    return cfg, params, weights


def _dataset_kwargs(cfg, device):
    if device.type == "cuda":
        return dict(n_mels=cfg.n_mels, feature_extractor=card_features(cfg.n_mels, device))
    return dict(n_mels=cfg.n_mels)


def run_decode_config(num, model, args, tok, *, phase, jsonl_rel, prompt,
                      bias_list, bias_nums, num_beams, bias_boost,
                      baseline_key=None, force_cpu=False, limit=None):
    out_dir = os.path.join(args.output, f"config{num}_{model}")
    os.makedirs(out_dir, exist_ok=True)
    jsonl_root = args.jsonl_root or _reference("data")
    rows = load_rows(jsonl_root, jsonl_rel, limit)
    base, jsonl_dir, audio_s, real_audio = stage_corpus(
        out_dir, phase, rows, args.data_root, os.path.dirname(jsonl_rel))

    device = resolve_device("cpu" if force_cpu else args.device)
    cfg, params, weights = _config_and_weights(num, model, args, device, DECODE_KERNELS)
    net = build_model(cfg, params, device=device)
    del params
    collator = SpeechSeq2SeqCollator(
        pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
        decoder_prev_token_id=tok.sop, pad_to_multiple=32,
        bias_span_pad_id=tok.eot)
    ds = PromptWhisperDataset(
        base_path=base, jsonl_data=jsonl_dir, phase=phase, tokenizer=tok,
        prompt=prompt, bias_list=bias_list, bias_nums=bias_nums,
        **_dataset_kwargs(cfg, device))
    rp = os.path.join(out_dir, "refs_and_pred.txt")
    t0 = time.monotonic()
    medusa = None
    if args.medusa and num_beams == 1:
        medusa = load_medusa(args.medusa, n_chains=args.medusa_chains)
    result = evaluate_wer(
        net, tok, ds, collator, min(args.batch, len(ds)),
        args.max_new, refs_pred_file=rp, prompt_generation=prompt,
        bias_boost=bias_boost, num_beams=num_beams, medusa=medusa)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    bias = compute_bias_wer(rp, ds.all_bias_spans(), tok)
    del net

    row = {
        "config": num, "model": model, "mode": "decode",
        "num_beams": num_beams, "prompt": prompt, "bias_list": bias_list,
        "n_utts": len(rows), "wer": result["wer"], "bias_wer": bias["bias_wer"],
        "audio_s": round(audio_s, 2), "wall_s": round(wall, 2),
        # the wall includes the kernels' first-use build and the card's
        # start-up; a throughput number needs a full corpus
        "rtf": round(audio_s / wall, 2) if wall else None,
        "rtf_includes_compile": True,
        "real_weights": bool(weights), "real_audio": real_audio,
        "real_tokenizer": bool(args.vocab), "artifact": rp, "asserts": [],
    }
    if baseline_key:
        b = BASELINES[baseline_key]
        if weights and real_audio and args.vocab and not limit:
            # arms only on the full corpus: a --limit-truncated subset's WER
            # is not comparable to the full-corpus baseline numbers
            delta = abs(result["wer"] - b["wer"]) / b["wer"]
            row["asserts"].append({
                "assert": f"model_parity:{baseline_key}",
                "status": "pass" if delta <= args.wer_tolerance else "FAIL",
                "wer": result["wer"], "expected_wer": b["wer"],
                "rel_delta": round(delta, 4)})
        else:
            missing = [n for n, v in (("weights", weights), ("audio", real_audio),
                                      ("tokenizer", args.vocab)) if not v]
            if limit:
                missing.append(f"full corpus (truncated to {limit} by --limit)")
            row["asserts"].append({
                "assert": f"model_parity:{baseline_key}", "status": "skipped",
                "reason": f"needs real {'+'.join(missing)}"})
    return row


def run_train_config(num, model, args, tok, limit):
    """Config 3: the WeightCE fine-tune through the full train path."""
    out_dir = os.path.join(args.output, f"config{num}_{model}")
    os.makedirs(out_dir, exist_ok=True)
    jsonl_root = args.jsonl_root or _reference("data")
    rows = load_rows(jsonl_root, "train_dev_5000_suffer.jsonl", limit)
    # train_dev_5000_suffer rows have no descriptions/bias lists — attach
    # empty ones so the prompted-train path exercises its no-context branch
    rows = [dict(r, description=r.get("description", ""),
                 bias_words=r.get("bias_words", [])) for r in rows]
    base, jsonl_dir, audio_s, real_audio = stage_corpus(
        out_dir, "train", rows, args.data_root, "")
    # dev may stage to a different base than train (e.g. real train audio
    # but synthesized dev) — keep each phase's resolved base
    dev_base, _, _, _ = stage_corpus(
        out_dir, "dev", rows[: max(2, len(rows) // 4)], args.data_root, "")

    device = resolve_device(args.device)
    cfg, params, weights = _config_and_weights(num, model, args, device, TRAIN_KERNELS)
    collator = SpeechSeq2SeqCollator(
        pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
        decoder_prev_token_id=tok.sop, pad_to_multiple=32,
        bias_span_pad_id=tok.eot)
    # train_dev_5000_suffer.jsonl carries neither descriptions nor bias
    # words — prompt only when the corpus actually has bias annotations
    has_bias = any(r.get("bias_words") for r in rows)
    mk = dict(jsonl_data=jsonl_dir, tokenizer=tok,
              prompt=has_bias, bias_list=has_bias,
              bias_nums=5 if has_bias else 0, **_dataset_kwargs(cfg, device))
    train_ds = PromptWhisperDataset(phase="train", base_path=base, **mk)
    dev_ds = PromptWhisperDataset(phase="dev", base_path=dev_base, **mk)
    bsz = min(args.batch, max(1, len(train_ds) // 2))
    tcfg = TrainingConfig(
        output_dir=out_dir, per_device_train_batch_size=bsz,
        per_device_eval_batch_size=min(2, bsz), gradient_accumulation_steps=1,
        learning_rate=1e-5, num_train_epochs=args.train_epochs,
        warmup_steps=1, eval_steps=10 ** 6, save_steps=10 ** 6,
        logging_steps=1, bias_weight=1.5, generation_max_length=32)
    t0 = time.monotonic()
    net, hist = train_and_evaluate(cfg, params, tok, train_ds, dev_ds, collator, tcfg,
                                   device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    del net, params
    losses = [e["loss"] for e in hist if "loss" in e]
    return {
        "config": num, "model": model, "mode": "weightce_train",
        "n_utts": len(rows), "steps": len(losses),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(losses[-1], 4) if losses else None,
        "audio_s": round(audio_s, 2), "wall_s": round(wall, 2),
        "train_audio_s_per_s": round(audio_s * args.train_epochs / wall, 2) if wall else None,
        "real_weights": bool(weights), "real_audio": real_audio,
        "real_tokenizer": bool(args.vocab),
        "asserts": [{
            "assert": "train_loss_finite",
            "status": "pass" if losses and all(np.isfinite(losses)) else "FAIL",
        }],
    }


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    probe = probe_assets(args)
    print(f"asset probe: {probe['outcome']}")
    wanted = {int(c) for c in args.configs.split(",") if c.strip()}
    if wanted - {1}:
        resolve_device(args.device)  # the card before any config runs
    tok_en = load_tokenizer(args.vocab, args.merges)
    tok_ml = load_tokenizer(args.vocab, args.merges, multilingual=True)
    if not args.vocab:
        print("byte-fallback vocab / random weights — outputs are not real "
              "transcripts; model-parity asserts will be skipped")
    offline_limit = args.limit or 4
    limit = args.limit if (args.weights_dir and args.data_root) else offline_limit

    rows = []
    if 1 in wanted:  # tiny greedy, single clip + 10-word bias list, CPU
        rows.append(run_decode_config(
            1, "tiny.en", args, tok_en, phase="test",
            jsonl_rel="medical-united-syn-med-test-jsonl/test.jsonl",
            prompt=False, bias_list=True, bias_nums=10, num_beams=1,
            bias_boost=1.0, force_cpu=True, limit=1))
    if 2 in wanted:  # base beam k=5 + bias processor on dev
        rows.append(run_decode_config(
            2, "base.en", args, tok_en, phase="dev",
            jsonl_rel="medical-united-syn-med-75-jsonl/dev.jsonl",
            prompt=False, bias_list=True, bias_nums=10, num_beams=5,
            bias_boost=1.0, limit=limit))
    if 3 in wanted:  # small WeightCE fine-tune
        rows.append(run_train_config(3, "small.en", args, tok_en, limit=limit))
    if 4 in wanted:  # medium desc-prompt decode (desc_only variant)
        rows.append(run_decode_config(
            4, "medium.en", args, tok_en, phase="dev",
            jsonl_rel="medical-united-syn-med-75-jsonl/dev.jsonl",
            prompt=True, bias_list=False, bias_nums=0, num_beams=1,
            bias_boost=0.0, baseline_key="desc_only_dev",
            limit=min(limit, 2) if not args.weights_dir else limit))
    if 5 in wanted:  # large-v3 full test sweep, no prompt
        rows.append(run_decode_config(
            5, "large-v3", args, tok_ml, phase="test",
            jsonl_rel="medical-united-syn-med-75-jsonl/test.jsonl",
            prompt=False, bias_list=False, bias_nums=0, num_beams=1,
            bias_boost=0.0, baseline_key="baseline_test",
            limit=min(limit, 2) if not args.weights_dir else limit))

    metric_asserts = metric_parity_asserts(args.wer_tolerance)
    all_asserts = metric_asserts + [a for r in rows for a in r["asserts"]]
    skipped = [a for a in all_asserts if a["status"] == "skipped"]
    failed = [a for a in all_asserts if a["status"] == "FAIL"]
    summary = {
        "asset_probe": probe,
        "configs": rows,
        "metric_parity": metric_asserts,
        "asserts_passed": sum(a["status"] == "pass" for a in all_asserts),
        "asserts_failed": len(failed),
        "asserts_skipped": [
            {"assert": a["assert"], "reason": a.get("reason", "")} for a in skipped
        ],
        "ok": not failed,
    }
    with open(os.path.join(args.output, "acceptance.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    if failed:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
