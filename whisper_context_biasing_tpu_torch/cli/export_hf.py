"""Export a native checkpoint to HF Whisper format (model.safetensors): the
port's counterpart of the JAX package's ``scripts/export_hf.py``, with its
flags. Models fine-tuned here load in transformers and any HF tooling::

    python -m whisper_context_biasing_tpu_torch.cli.export_hf --model base.en \\
        --checkpoint results/checkpoint-405 --out exported/
"""

from __future__ import annotations

import argparse
import os

from ..models import get_config, load_checkpoint_or_safetensors, save_safetensors
from ..train.checkpoint import is_native_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export native checkpoint to HF format")
    p.add_argument("--model", default="base.en",
                   help="architecture name (sets dims for native checkpoints)")
    p.add_argument("--checkpoint", required=True,
                   help="native checkpoint-N dir (params.npz or params_dcp/) or "
                        "an HF safetensors file/dir (roundtrip)")
    p.add_argument("--out", required=True,
                   help="output directory (or .safetensors path)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    native = is_native_checkpoint(args.checkpoint)
    # native checkpoints need --model for dims; HF inputs carry their own
    # dims — inferring them prevents silently truncating a bigger model
    cfg = get_config(args.model) if native else None
    state_dict, cfg = load_checkpoint_or_safetensors(args.checkpoint, cfg)
    save_safetensors(state_dict, cfg, args.out)
    dest = (args.out if args.out.endswith(".safetensors")
            else os.path.join(args.out, "model.safetensors"))
    print(f"exported {args.model} weights -> {dest}")


if __name__ == "__main__":
    main()
