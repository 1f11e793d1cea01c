"""Evaluate a trained Whisper medical context-biasing model on the card: the
port's counterpart of the JAX package's ``scripts/evaluation.py``, with its
flags.

CLI surface preserved from the reference ``scripts/evaluation.py:21-37``.
Two modes, as in the reference: ``--final_model`` (a checkpoint path via
--model_path: an HF ``model.safetensors`` or a native checkpoint-N dir) and
``--best_checkpoint`` (lowest recorded eval_wer under --output,
scripts/evaluation.py:75-94). The eval dataset is built WITHOUT the bias-list
args, matching the reference quirk (eval prompting is desc-only or none,
scripts/evaluation.py:133-142). The model is ``get_config(--model)`` with no
kernel switches, and decodes up to 224 tokens::

    python -m whisper_context_biasing_tpu_torch.cli.evaluation --model base.en \\
        --data_root corpus --data_dir audio --jsonl_data corpus/jsonl \\
        --output results --best_checkpoint

Under ``torchrun`` the decode batches shard over "data" and the weights over
"model" by ``--model_parallelism`` (``cli/__init__.py``); rank 0 writes.

Fixed deviation (documented): the reference's ``save_refs_and_preds`` writes
"ref: … | pred: …" lines that its own B-WER parser cannot read (it expects
"Ref :/Pred:"), which breaks --only_eval_bias_wer; we always write the
canonical artifact format.
"""

from __future__ import annotations

import argparse
import json
import os

from .._device import resolve_device
from ..config import DATA_DIR, DATA_ROOT, JSONL_DATA
from ..data import PromptWhisperDataset, SpeechSeq2SeqCollator
from ..metrics import compute_bias_wer
from ..models import (
    build_model,
    get_config,
    init_state_dict,
    load_checkpoint_or_safetensors,
    load_medusa,
)
from ..parallel import auto_mesh, initialize_multihost, shard_params
from ..parallel.multihost import process_index
from ..tokenizer import load_tokenizer
from ..train import evaluate_wer, find_best_checkpoint, load_checkpoint
from ..utils import hub, warn_missing_assets
from . import report_devices


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate Whisper medical model with context biasing")
    p.add_argument("--output", type=str, default="results")
    p.add_argument("--bias_weight", type=float, default=1.5)
    p.add_argument("--data_root", type=str, default=DATA_ROOT)
    p.add_argument("--data_dir", type=str, default=DATA_DIR)
    p.add_argument("--jsonl_data", type=str, default=JSONL_DATA)
    p.add_argument("--prompt", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--only_eval_bias_wer", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hub_model_id", type=str, default=None,
                   help="with --best_checkpoint: sync this Hub repo into --output first")
    p.add_argument("--refs_pred_file", type=str, default=None)
    p.add_argument("--final_model", action="store_true", default=False)
    p.add_argument("--best_checkpoint", action="store_true", default=False)
    p.add_argument("--hf_token", type=str, default=None)
    # the JAX package's additions
    p.add_argument("--model", type=str, default="base.en")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint dir (native) or model.safetensors (HF)")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--merges", type=str, default=None)
    p.add_argument("--prompt_generation", action="store_true")
    p.add_argument("--bias_boost", type=float, default=0.0)
    p.add_argument("--num_beams", type=int, default=1, help="> 1: beam search")
    p.add_argument("--medusa", type=str, default=None,
                   help="medusa.npz (cli.medusa): self-speculative greedy decode, the same "
                        "tokens as plain greedy (beams win with --num_beams > 1)")
    p.add_argument("--medusa_chains", type=int, default=None,
                   help="Medusa tree chains: branch on head 1's top-N (default: the value "
                        "saved in medusa.npz, else 1)")
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="1: data parallel over every process (torchrun); N > 1: "
                        "data x model mesh; 0: no mesh")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (cpu for tests)")
    return p.parse_args(argv)


def load_model(args, model_cfg, path):
    """(state dict, cfg) from a native checkpoint, an HF safetensors file, or
    the seeded init (seed 0) without a path."""
    warn_missing_assets(args.vocab, path, "evaluation")
    if path:
        return load_checkpoint_or_safetensors(path, model_cfg)
    return init_state_dict(model_cfg, 0), model_cfg


def run_eval(args, state_dict, model_cfg, tokenizer, data_test, collator, bias_spans,
             model_name, mesh=None):
    refs_pred_file = args.refs_pred_file or os.path.join(args.output, "refs_and_pred.txt")
    model = build_model(model_cfg, state_dict, device=args.device)
    if mesh is not None:
        model = shard_params(model, mesh)
    medusa = load_medusa(args.medusa, n_chains=args.medusa_chains) if args.medusa else None
    result = evaluate_wer(
        model, tokenizer, data_test, collator, args.batch, 224,
        refs_pred_file=refs_pred_file,
        prompt_generation=args.prompt_generation, bias_boost=args.bias_boost,
        num_beams=args.num_beams, medusa=medusa, mesh=mesh,
    )
    if process_index() != 0:  # rank 0 alone writes
        return
    if not args.only_eval_bias_wer:
        print(f"{model_name} Test set evaluation results:", result)
        with open(os.path.join(args.output, f"{model_name}_test_results.json"), "w") as f:
            json.dump(result, f, indent=4)

    bias_result = compute_bias_wer(refs_pred_file, bias_spans, tokenizer)
    print(f"{model_name} Bias WER result:", bias_result)
    with open(os.path.join(args.output, f"{model_name}_bias_wer_results.json"), "w") as f:
        json.dump(bias_result, f, indent=4)


def locate_best_checkpoint(output: str, hub_model_id: str | None,
                           hf_token: str | None) -> str | None:
    """--best_checkpoint resolution with the reference's flag semantics
    (reference scripts/evaluation.py:154-155,213): when a hub repo is named,
    download the WHOLE repo into ``output`` first, then scan trainer_state
    histories for the lowest eval_wer. Gated + offline-safe: when the sync
    no-ops (no network / no huggingface_hub) the scan sees whatever already
    sits under ``output`` — the local-only behavior."""
    if hub_model_id:
        print(f"Syncing {hub_model_id} into {output} ...")
        hub.sync_from_hub(hub_model_id, output, hf_token)
    return find_best_checkpoint(output)


def main(argv=None):
    args = parse_args(argv)
    initialize_multihost(device=args.device)
    args.device = resolve_device(args.device)
    # the JAX script's auto-mesh (data parallel by default, data x model
    # with --model_parallelism > 1, none with 0)
    mesh = auto_mesh(args.model_parallelism)
    report_devices(args.device, mesh)
    tokenizer = load_tokenizer(args.vocab, args.merges,
                               multilingual=not args.model.endswith(".en"))
    model_cfg = get_config(args.model)
    collator = SpeechSeq2SeqCollator(
        pad_token_id=tokenizer.pad_token_id,
        decoder_start_token_id=tokenizer.sot,
        decoder_prev_token_id=tokenizer.sop,
        pad_to_multiple=32,
        # match the decode/loss span_pad_id (eot); see cli/train.py
        bias_span_pad_id=tokenizer.eot,
    )

    test_jsonl = os.path.join(args.jsonl_data, "test.jsonl")
    if not os.path.isfile(test_jsonl):
        raise FileNotFoundError(f"Test JSONL file not found: {test_jsonl}")

    # NOTE: no bias_list/bias_nums/bias_desc — reference eval quirk replicated
    data_test = PromptWhisperDataset(
        base_path=os.path.join(args.data_root, args.data_dir),
        jsonl_data=args.jsonl_data, phase="test", tokenizer=tokenizer,
        prompt=args.prompt, random=args.random,
        n_mels=model_cfg.n_mels,  # 128 for large-v3
    )
    if len(data_test) == 0:
        raise ValueError("Test dataset is empty")
    print(f"Test data length: {len(data_test)}")
    bias_spans = data_test.all_bias_spans()

    os.makedirs(args.output, exist_ok=True)
    if not args.final_model and not args.best_checkpoint:
        print("choose a mode: --final_model or --best_checkpoint")
        return

    if args.final_model:
        state_dict, model_cfg2 = load_model(args, model_cfg, args.model_path)
        run_eval(args, state_dict, model_cfg2, tokenizer, data_test, collator,
                 bias_spans, "refs_and_pred", mesh)

    if args.best_checkpoint:
        best = locate_best_checkpoint(args.output, args.hub_model_id, args.hf_token)
        if not best:
            print("No valid checkpoint found in output dir for evaluation.")
            return
        print(f"Loading best checkpoint from: {best}")
        state_dict, _, _ = load_checkpoint(best, model_cfg)
        run_eval(args, state_dict, model_cfg, tokenizer, data_test, collator,
                 bias_spans, "refs_and_pred", mesh)


if __name__ == "__main__":
    main()
