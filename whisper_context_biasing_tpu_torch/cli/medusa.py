"""Train Medusa multi-token heads for self-speculative serving: the port's
counterpart of the JAX package's ``scripts/medusa.py``, with its flags plus
``--device``.

    python -m whisper_context_biasing_tpu_torch.cli.medusa --model base.en \\
        --init_checkpoint model.safetensors --data_root corpus --data_dir audio \\
        --jsonl_data corpus/jsonl --medusa_heads 4 --output medusa_out/

Fits the K prediction heads that ``cli.transcribe --medusa``,
``cli.serve --medusa`` and ``Pipeline(medusa=...)`` consume
(``models/medusa.py``) on the frozen serving model's hidden states, and
writes ``medusa.npz`` (the JAX package's layout, with ``--medusa_chains``
stamped in), ``medusa_results.json`` and ``medusa_log.jsonl`` into
``--output``. Prints per-head dev accuracy and the expected accepted tokens
per verify round. On a card the frozen forward runs the flash kernels (the
encoder, and the decoder at label lengths of at least
``flash_decoder_min_seq``); without ``--init_checkpoint`` the base is the
port's seeded init (``--seed``).
"""

from __future__ import annotations

import argparse
import os

from .._device import resolve_device
from ..config import DATA_DIR, JSONL_DATA
from ..data import PromptWhisperDataset, SpeechSeq2SeqCollator
from ..models import build_model, get_config, init_medusa_params, load_checkpoint_or_safetensors
from ..tokenizer import load_tokenizer
from ..train import MedusaConfig, train_medusa_heads
from ..utils import warn_missing_assets


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Medusa heads")
    p.add_argument("--output", type=str, default="medusa_out")
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
    p.add_argument("--model", type=str, default="base.en")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="serving model weights (safetensors / checkpoint-N)")
    p.add_argument("--medusa_heads", type=int, default=4)
    p.add_argument("--medusa_chains", type=int, default=1,
                   help="stamped into medusa.npz: decode-time branching on head 1's top-S "
                        "candidates (tree-attention chains)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epoch", type=float, default=2)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--eval_batches", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(f"Arguments: {vars(args)}")
    device = resolve_device(args.device)
    warn_missing_assets(args.vocab, args.init_checkpoint, "medusa")

    tokenizer = load_tokenizer(args.vocab, args.merges,
                               multilingual=not args.model.endswith(".en"))
    cfg = get_config(args.model, flash_attention=device.type == "cuda")
    state = None
    if args.init_checkpoint:
        state, cfg = load_checkpoint_or_safetensors(args.init_checkpoint, cfg)
    else:
        print("no --init_checkpoint: RANDOM base weights (smoke runs only)")
    model = build_model(cfg, state, seed=args.seed, device=device)

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
        n_mels=cfg.n_mels,
    )
    data_train = PromptWhisperDataset(phase="train", **ds_kwargs)
    data_eval = PromptWhisperDataset(phase="dev", **ds_kwargs)
    for name, ds in (("train", data_train), ("dev", data_eval)):
        if len(ds) == 0:
            raise ValueError(f"{name} dataset is empty")
        print(f"{name} data length: {len(ds)}")

    medusa = init_medusa_params(cfg, args.medusa_heads, args.seed)
    mcfg = MedusaConfig(
        output_dir=args.output, n_heads=args.medusa_heads, n_chains=args.medusa_chains,
        per_device_train_batch_size=args.batch, learning_rate=args.lr,
        num_train_epochs=args.epoch, warmup_steps=args.warmup_steps,
        eval_steps=args.eval_steps, logging_steps=args.logging_steps,
        eval_batches=args.eval_batches, seed=args.seed)
    print("Training Medusa heads...")
    heads, hist = train_medusa_heads(cfg, model, medusa, data_train, data_eval, collator, mcfg)
    summary = hist[-1]
    print(f"Done: dev head accuracy {summary['eval_head_acc']}, expected "
          f"{summary['eval_tokens_per_round']} tokens/verify-round ({args.output}/medusa.npz)")
    return heads, hist


if __name__ == "__main__":
    main()
