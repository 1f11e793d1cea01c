"""Train the Whisper medical context-biasing model on the card: the port's
counterpart of the JAX package's ``scripts/train.py``, with its flags.

CLI surface preserved from the reference ``scripts/train.py:26-45`` with the
documented dead flags fixed (SURVEY.md §7): ``--lr``/``--epoch`` are honored
(defaults = the values the reference hardcodes: lr 1e-5, 5 epochs), hub sync
is optional/gated, and bias spans are collected tokenizer-only instead of
decoding the whole test audio set::

    python -m whisper_context_biasing_tpu_torch.cli.train --model base.en \\
        --init_checkpoint model.safetensors --data_root corpus --data_dir audio \\
        --jsonl_data corpus/jsonl --output results --prompt --bias_list \\
        --flash_attention --fused_ln

``--flash_attention`` runs the flash forward and backward kernels, and
``--fused_ln`` the fused LayerNorm+matmul kernel, in the training step and
the evaluations' encoder. ``--lora_rank N`` trains LoRA adapters over the
frozen model (checkpoints hold the adapters; the test evaluation and the
export see the merged weights), ``--spec_augment`` masks the features in
the step. ``--remat`` takes the JAX policies (full, dots, wide, none).
``--checkpoint_backend orbax`` writes the sharded DCP layout
(``train/checkpoint.py``). Under ``torchrun`` the run is data / tensor
parallel by ``--model_parallelism`` (``cli/__init__.py``), LoRA included.
``--device`` (default
``cuda``) is the port's own flag; see ``cli/__init__.py`` for the other
deviations.
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
    get_config,
    init_state_dict,
    load_checkpoint_or_safetensors,
    save_safetensors,
)
from ..parallel import auto_mesh, gather_params, initialize_multihost, shard_batch
from ..parallel.multihost import process_index
from ..tokenizer import load_tokenizer
from ..train import TrainingConfig, evaluate_wer, latest_checkpoint, train_and_evaluate
from ..utils import push_to_hub_if_exists, upload_results_to_hub, warn_missing_assets
from . import report_devices


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Whisper medical model with context biasing")
    # reference surface (scripts/train.py:26-45)
    p.add_argument("--output", type=str, default="results")
    p.add_argument("--data_root", type=str, default=DATA_ROOT)
    p.add_argument("--data_dir", type=str, default=DATA_DIR)
    p.add_argument("--jsonl_data", type=str, default=JSONL_DATA)
    p.add_argument("--refs_pred_file", type=str, default=None)
    p.add_argument("--bias_weight", type=float, default=1.5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epoch", type=float, default=5)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--hub_model_id", type=str, default=None,
                   help="Hub repo to sync with; skipped with a warning offline")
    p.add_argument("--hf_token", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--prompt", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--bias_list", action="store_true")
    p.add_argument("--bias_nums", type=int, default=0)
    p.add_argument("--bias_desc", action="store_true")
    # the JAX package's additions
    p.add_argument("--model", type=str, default="base.en")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--merges", type=str, default=None)
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="HF model.safetensors or native checkpoint-N dir")
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="1: data parallel over every process (torchrun); N > 1: "
                        "data x model mesh; 0: no mesh")
    p.add_argument("--eval_steps", type=int, default=135)
    p.add_argument("--save_steps", type=int, default=135)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--eval_batch", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=4)
    p.add_argument("--prompt_generation", action="store_true",
                   help="condition eval generation on the context prefix")
    p.add_argument("--bias_boost", type=float, default=0.0,
                   help="decode-time bias-span logit bonus")
    p.add_argument("--flash_attention", action="store_true",
                   help="flash attention kernels (forward and backward) in the "
                        "encoder and the training decoder")
    p.add_argument("--fused_ln", action="store_true",
                   help="fused LayerNorm+QKV and LayerNorm+bias+gelu kernel "
                        "(ops/fused_block.py)")
    p.add_argument("--remat", default="auto",
                   choices=["auto", "full", "dots", "wide", "none"],
                   help="rematerialization policy for transformer blocks: "
                        "auto = full (recompute each block), dots (keep the "
                        "matmul outputs), wide (recompute the MLP alone), none")
    p.add_argument("--freeze_encoder", action="store_true",
                   help="train the decoder only (reference freeze_encoder())")
    p.add_argument("--lora_rank", type=int, default=0,
                   help=">0: LoRA fine-tune — train rank-r adapters on the "
                        "attention q/v projections instead of all weights "
                        "(checkpoints hold the adapters; eval/export see merged "
                        "weights)")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--speed_perturb", type=float, nargs="*", default=None,
                   help="sox-style speed augmentation factors, e.g. "
                        "0.9 1.0 1.1 (train phase only; one drawn per "
                        "sample per epoch, deterministic)")
    p.add_argument("--spec_augment", action="store_true",
                   help="SpecAugment mel masking in the train step (2 freq + 2 "
                        "time masks, mean fill; train-time only)")
    p.add_argument("--checkpoint_backend", choices=["npz", "orbax"], default="npz",
                   help="npz: the JAX package's files, gathered whole; orbax: "
                        "torch.distributed.checkpoint dirs (params_dcp/, opt_dcp/), "
                        "each rank writing its own shards")
    p.add_argument("--seed", type=int, default=42)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for tests)")
    return p.parse_args(argv)


def training_config(args) -> TrainingConfig:
    return TrainingConfig(
        output_dir=args.output,
        per_device_train_batch_size=args.batch,
        per_device_eval_batch_size=args.eval_batch,
        gradient_accumulation_steps=args.grad_accum,
        learning_rate=args.lr,
        num_train_epochs=args.epoch,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
        logging_steps=args.logging_steps,
        bias_weight=args.bias_weight,
        freeze_encoder=args.freeze_encoder,
        prompt_generation=args.prompt_generation,
        bias_boost=args.bias_boost,
        seed=args.seed,
        hub_model_id=args.hub_model_id,
        hub_token=args.hf_token,
        checkpoint_backend=args.checkpoint_backend,
        spec_augment=args.spec_augment,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
    )


def model_config(args):
    # auto = full: recompute in the backward, the least device memory
    remat = "full" if args.remat == "auto" else args.remat
    return get_config(args.model, flash_attention=args.flash_attention,
                      fused_ln_qkv=args.fused_ln, fused_ln_mlp=args.fused_ln, remat=remat)


def main(argv=None):
    args = parse_args(argv)
    print(f"Arguments: {vars(args)}")
    initialize_multihost(device=args.device)
    device = resolve_device(args.device)
    # the JAX script's auto-mesh: data parallel over every process by
    # default, data x model with --model_parallelism > 1, none with 0
    mesh = auto_mesh(args.model_parallelism, batch_divisor=args.batch)
    report_devices(device, mesh)
    lead = process_index() == 0
    # --resume with an existing checkpoint restores real weights; don't
    # tell the operator the run is random-init in that case
    resumable = args.resume and latest_checkpoint(args.output)
    warn_missing_assets(args.vocab, args.init_checkpoint or resumable, "train")

    if args.speed_perturb and any(f <= 0 for f in args.speed_perturb):
        raise SystemExit(f"--speed_perturb factors must be > 0, got {args.speed_perturb}")
    tokenizer = load_tokenizer(args.vocab, args.merges,
                               multilingual=not args.model.endswith(".en"))
    model_cfg = model_config(args)
    collator = SpeechSeq2SeqCollator(
        pad_token_id=tokenizer.pad_token_id,
        decoder_start_token_id=tokenizer.sot,
        decoder_prev_token_id=tokenizer.sop,
        pad_to_multiple=32,
        # must match the loss's span_pad_id (cfg.pad_token_id == eot): for
        # multilingual models eot is 50257, not the .en default 50256
        bias_span_pad_id=tokenizer.eot,
    )

    for phase in ("train", "dev", "test"):
        path = os.path.join(args.jsonl_data, f"{phase}.jsonl")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"JSONL file not found: {path}")

    ds_kwargs = dict(
        base_path=os.path.join(args.data_root, args.data_dir),
        jsonl_data=args.jsonl_data, tokenizer=tokenizer,
        prompt=args.prompt, random=args.random, bias_list=args.bias_list,
        bias_nums=args.bias_nums, bias_desc=args.bias_desc, seed=args.seed,
        n_mels=model_cfg.n_mels,  # 128 for large-v3
        # dataset gates on phase, so dev/test are never perturbed
        speed_perturb=tuple(args.speed_perturb) if args.speed_perturb else None,
    )
    data_train = PromptWhisperDataset(phase="train", **ds_kwargs)
    data_eval = PromptWhisperDataset(phase="dev", **ds_kwargs)
    data_test = PromptWhisperDataset(phase="test", **ds_kwargs)
    for name, ds in (("train", data_train), ("dev", data_eval), ("test", data_test)):
        if len(ds) == 0:
            raise ValueError(f"{name} dataset is empty")
        print(f"{name} data length: {len(ds)}")

    # spans need only the tokenizer (fixes scripts/train.py:163 audio decode)
    bias_spans = data_test.all_bias_spans()

    # model init: a native checkpoint or an HF safetensors file, else seeded
    if args.init_checkpoint:
        params, model_cfg = load_checkpoint_or_safetensors(args.init_checkpoint, model_cfg)
    else:
        print("no init checkpoint given: seeded random init")
        params = init_state_dict(model_cfg, args.seed)

    tcfg = training_config(args)
    shard_fn = None
    if mesh is not None:
        def shard_fn(b):
            return shard_batch(b, mesh, extra_leading_axes=1 if args.grad_accum > 1 else 0)
    print("Starting training...")
    model, log_history = train_and_evaluate(
        model_cfg, params, tokenizer, data_train, data_eval, collator, tcfg,
        resume=args.resume, shard_fn=shard_fn, mesh=mesh, device=device,
    )

    print("Starting final evaluation on test set...")
    refs_pred_file = args.refs_pred_file or os.path.join(args.output, "refs_and_pred.txt")
    result = evaluate_wer(
        model, tokenizer, data_test, collator,
        tcfg.per_device_eval_batch_size, tcfg.generation_max_length - 1,
        refs_pred_file=refs_pred_file,
        prompt_generation=args.prompt_generation, bias_boost=args.bias_boost, mesh=mesh,
    )
    full = gather_params(model) if args.hub_model_id and args.hf_token else None
    if not lead:
        return model, log_history
    print("Test set evaluation results:", result)
    with open(os.path.join(args.output, "test_results.json"), "w") as f:
        json.dump(result, f, indent=4)

    print("Calculating bias WER...")
    bias_result = compute_bias_wer(refs_pred_file, bias_spans, tokenizer)
    print("Bias WER result:", bias_result)
    bias_file = os.path.join(args.output, "bias_wer_results.json")
    with open(bias_file, "w") as f:
        json.dump(bias_result, f, indent=4)

    # hub sync parity (reference scripts/train.py:285-307), gated offline
    if args.hub_model_id and args.hf_token:
        # the reference's hub artifacts are HF checkpoints: export the final
        # weights in transformers-loadable form alongside the native ones
        try:
            save_safetensors(full, model_cfg, args.output)
        except Exception as e:  # noqa: BLE001 — sync must not fail training
            print(f"HF export skipped: {e}")

        upload_results_to_hub(os.path.join(args.output, "test_results.json"),
                              args.hub_model_id, "results/test_results.json", args.hf_token)
        upload_results_to_hub(bias_file, args.hub_model_id,
                              "results/bias_wer_results.json", args.hf_token)
        push_to_hub_if_exists(args.output, args.hub_model_id, args.hf_token)
    return model, log_history


if __name__ == "__main__":
    main()
