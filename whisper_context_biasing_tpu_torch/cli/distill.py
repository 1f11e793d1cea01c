"""Distill a speculative-decoding draft from a trained target: the port's
counterpart of the JAX package's ``scripts/distill.py``, with its flags plus
``--device``.

    python -m whisper_context_biasing_tpu_torch.cli.distill --model base.en \\
        --init_checkpoint results/checkpoint-N --draft_model tiny.en \\
        --data_root corpus --data_dir audio --jsonl_data corpus/jsonl --output draft/

Trains the small draft that ``cli.transcribe --draft_model`` and ``cli.serve
--draft_model`` consume by matching the frozen target's output distribution
on the prompted corpus (``train/distill.py``), and prints the dev-set top-1
agreement, the speculative acceptance rate, at every evaluation. Writes
``checkpoint-N/`` dirs, ``distill_results.json`` and the draft's
``model.safetensors`` (the port's own writer) into ``--output``. A draft
whose mel frontend differs from the target's (an 80-mel draft for the
128-mel large-v3) reads raw audio, and the mel kernel runs once per
frontend inside the step. On a card both models run the flash kernels;
without ``--init_checkpoint`` the target is the port's seeded init
(``--seed``), the draft's ``--seed + 1``. Under ``torchrun`` both models
shard over the mesh of ``--model_parallelism`` (``cli/__init__.py``) and
rank 0 writes the files; ``--checkpoint_backend orbax`` writes the sharded
DCP layout (``train/checkpoint.py``)::

    torchrun --nproc_per_node 2 -m whisper_context_biasing_tpu_torch.cli.distill \
        --model_parallelism 2 --checkpoint_backend orbax ...
"""

from __future__ import annotations

import argparse
import json
import os

from .._device import resolve_device
from ..config import DATA_DIR, JSONL_DATA
from ..data import PromptWhisperDataset, SpeechSeq2SeqCollator
from ..models import get_config, init_state_dict, load_checkpoint_or_safetensors, save_safetensors
from ..parallel import auto_mesh, initialize_multihost
from ..parallel.multihost import process_index
from ..parallel.sharding import gather_tensor
from ..tokenizer import load_tokenizer
from ..train import DistillConfig, distill_and_evaluate
from ..utils import warn_missing_assets
from . import report_devices


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Distill a speculative-decode draft model")
    # corpus flags shared with cli/train.py
    p.add_argument("--output", type=str, default="draft")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--data_dir", type=str, default=DATA_DIR)
    p.add_argument("--jsonl_data", type=str, default=JSONL_DATA)
    p.add_argument("--prompt", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--bias_list", action="store_true")
    p.add_argument("--bias_nums", type=int, default=0)
    p.add_argument("--bias_desc", action="store_true")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--merges", type=str, default=None)
    # target (teacher, frozen)
    p.add_argument("--model", type=str, default="base.en",
                   help="target model family (the serving model)")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="target weights: HF safetensors or checkpoint-N dir")
    # draft (student)
    p.add_argument("--draft_model", type=str, default="tiny.en",
                   help="draft model family to train")
    p.add_argument("--draft_init", type=str, default=None,
                   help="optional draft init (safetensors / checkpoint-N); the seeded "
                        "init otherwise")
    # schedule
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epoch", type=float, default=3)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--hard_weight", type=float, default=0.5,
                   help="mix of ground-truth CE vs teacher KL (0 = pure "
                        "distillation, 1 = plain training)")
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--eval_batches", type=int, default=16)
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="1: data parallel over every process (one per card, "
                        "torchrun); N>1: data x model mesh; 0: no mesh")
    p.add_argument("--checkpoint_backend", choices=["npz", "orbax"], default="npz",
                   help="npz: the JAX package's files, gathered whole; orbax: "
                        "torch.distributed.checkpoint dirs (params_dcp/, opt_dcp/), "
                        "each rank writing its own shards")
    p.add_argument("--seed", type=int, default=42)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(f"Arguments: {vars(args)}")
    initialize_multihost(device=args.device)
    device = resolve_device(args.device)
    warn_missing_assets(args.vocab, args.init_checkpoint, "distill")

    tokenizer = load_tokenizer(args.vocab, args.merges,
                               multilingual=not args.model.endswith(".en"))
    kernels = dict(flash_attention=device.type == "cuda")
    cfg_t = get_config(args.model, **kernels)
    cfg_d = get_config(args.draft_model, **kernels)
    if cfg_d.n_vocab != cfg_t.n_vocab:
        raise SystemExit(
            f"--draft_model {args.draft_model} (vocab {cfg_d.n_vocab}) does "
            f"not share a token space with --model {args.model} (vocab "
            f"{cfg_t.n_vocab}); pick a draft of the same lingual family")

    # teacher weights
    if args.init_checkpoint:
        params_t, cfg_t = load_checkpoint_or_safetensors(args.init_checkpoint, cfg_t)
    else:
        print("no --init_checkpoint: RANDOM target weights — the distilled "
              "draft will match a random teacher (smoke runs only)")
        params_t = init_state_dict(cfg_t, args.seed)
    # student init
    if args.draft_init:
        params_d, cfg_d = load_checkpoint_or_safetensors(args.draft_init, cfg_d)
    else:
        params_d = init_state_dict(cfg_d, args.seed + 1)

    mixed_mels = cfg_d.n_mels != cfg_t.n_mels
    if mixed_mels:
        print(f"mixed mel frontends (draft {cfg_d.n_mels} / target "
              f"{cfg_t.n_mels}): shipping raw audio, the mel kernel in the step")
    collator = SpeechSeq2SeqCollator(
        pad_token_id=tokenizer.pad_token_id,
        decoder_start_token_id=tokenizer.sot,
        decoder_prev_token_id=tokenizer.sop,
        pad_to_multiple=32,
        bias_span_pad_id=tokenizer.eot,
    )
    ds_kwargs = dict(
        base_path=os.path.join(args.data_root, args.data_dir),
        jsonl_data=args.jsonl_data, tokenizer=tokenizer,
        prompt=args.prompt, random=args.random, bias_list=args.bias_list,
        bias_nums=args.bias_nums, bias_desc=args.bias_desc, seed=args.seed,
        n_mels=cfg_t.n_mels, return_audio=mixed_mels,
    )
    data_train = PromptWhisperDataset(phase="train", **ds_kwargs)
    data_eval = PromptWhisperDataset(phase="dev", **ds_kwargs)
    for name, ds in (("train", data_train), ("dev", data_eval)):
        if len(ds) == 0:
            raise ValueError(f"{name} dataset is empty")
        print(f"{name} data length: {len(ds)}")

    # the JAX script's auto-mesh, built where it builds it: both models
    # shard over it inside distill_and_evaluate
    mesh = auto_mesh(args.model_parallelism, batch_divisor=args.batch)
    report_devices(device, mesh)
    dcfg = DistillConfig(
        output_dir=args.output,
        per_device_train_batch_size=args.batch,
        gradient_accumulation_steps=args.grad_accum,
        learning_rate=args.lr,
        num_train_epochs=args.epoch,
        warmup_steps=args.warmup_steps,
        temperature=args.temperature,
        hard_weight=args.hard_weight,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
        logging_steps=args.logging_steps,
        eval_batches=args.eval_batches,
        seed=args.seed,
        checkpoint_backend=args.checkpoint_backend,
    )
    print("Starting distillation...")
    draft, log_history = distill_and_evaluate(
        cfg_d, params_d, cfg_t, params_t, data_train, data_eval, collator, dcfg,
        mesh=mesh, device=device)
    # the whole draft (collective over "model"), for rank 0's export
    full = {n: gather_tensor(draft, n, p.detach()) for n, p in draft.named_parameters()}
    if process_index() != 0:
        return draft, log_history

    summary = next((h for h in reversed(log_history) if "best_agreement" in h), {})
    print(f"Distillation done: best dev agreement "
          f"{summary.get('best_agreement', float('nan')):.4f} at step "
          f"{summary.get('best_step', -1)}")
    with open(os.path.join(args.output, "distill_results.json"), "w") as f:
        json.dump(summary, f, indent=2)

    # HF-loadable export of the final draft beside the native checkpoints
    save_safetensors(full, cfg_d, args.output)
    print(f"safetensors export: {args.output}/model.safetensors")
    return draft, log_history


if __name__ == "__main__":
    main()
