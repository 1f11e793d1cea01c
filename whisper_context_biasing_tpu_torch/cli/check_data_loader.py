"""Inspection harness for prompt construction: the port's counterpart of
the JAX package's ``scripts/check_data_loader.py`` (reference
scripts/check_data_loader.py parity)::

    python -m whisper_context_biasing_tpu_torch.cli.check_data_loader \\
        --data_root corpus --data_dir audio --jsonl_data corpus/jsonl \\
        --prompt --bias_list --bias_nums 3

Prints each sample's label sequence split into context and transcript at
the special tokens, checks the bias list's composition against
``bias_nums``, locates the "Relate terms:" marker of strategy 3, and
reports the bias / non-bias shares. Runs on the CPU and reads no audio."""

from __future__ import annotations

import argparse
import os

from ..config import DATA_DIR, DATA_ROOT, JSONL_DATA
from ..data import PromptWhisperDataset
from ..tokenizer import load_tokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default=DATA_ROOT)
    p.add_argument("--data_dir", default=DATA_DIR)
    p.add_argument("--jsonl_data", default=JSONL_DATA)
    p.add_argument("--phase", default="test")
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--prompt", action="store_true")
    p.add_argument("--bias_list", action="store_true")
    p.add_argument("--bias_nums", type=int, default=0)
    p.add_argument("--bias_desc", action="store_true")
    p.add_argument("--random", action=argparse.BooleanOptionalAction, default=True,
                   help="5%% train-phase prompt perturbation (reference "
                        "check forces it on, check_data_loader.py:48; "
                        "--no-random disables)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    return p.parse_args(argv)


def split_context(tok, seq):
    if seq[0] != tok.sop:
        return [], seq
    sot_at = seq.index(tok.sot)
    return seq[1:sot_at], seq[sot_at:]


def main(argv=None):
    args = parse_args(argv)
    tok = load_tokenizer(args.vocab, args.merges)
    ds = PromptWhisperDataset(
        base_path=os.path.join(args.data_root, args.data_dir),
        jsonl_data=args.jsonl_data, phase=args.phase, tokenizer=tok,
        prompt=args.prompt, bias_list=args.bias_list, random=args.random,
        bias_nums=args.bias_nums, bias_desc=args.bias_desc,
    )
    print(f"dataset: {len(ds)} samples; bias_pool={len(ds.bias_pool)}, "
          f"non_bias_pool={len(ds.non_bias_pool)}, prompts={len(ds.prompt_pool)}")

    relate = tok.encode("Relate terms: ", add_special_tokens=False)
    for i in range(min(args.samples, len(ds))):
        seq = ds.build_label_sequence(i)
        ctx, transcript = split_context(tok, seq)
        _, _, _, text, bias_words = ds.data[i]
        print(f"\n=== Sample {i} ===")
        print(f"text:       {text}")
        print(f"bias_words: {bias_words}")
        print(f"label len:  {len(seq)} (context {len(ctx)} + transcript {len(transcript)})")
        print(f"context:    {tok.decode(ctx)[:160]}")
        print(f"transcript: {tok.decode(transcript, skip_special_tokens=True)[:160]}")

        assert transcript == tok.encode(text.lower()), "transcript tokens diverged"

        if args.bias_list and args.bias_nums > 0:
            # locate the Relate terms marker (strategy 3/4) and the bias section
            marker_at = next(
                (k for k in range(len(ctx) - len(relate) + 1)
                 if ctx[k:k + len(relate)] == relate), None)
            if args.prompt:
                assert marker_at is not None, "'Relate terms:' marker missing"
                print(f"'Relate terms:' marker at context token {marker_at}")
                bias_sec = ctx[marker_at + len(relate):] if not args.bias_desc else None
            else:
                bias_sec = ctx
            if bias_sec is not None:
                words = tok.decode(bias_sec).split()
                own = sum(1 for w in bias_words if w.lower() in tok.decode(bias_sec))
                in_pool = sum(1 for w in words if w in ds.bias_pool)
                print(f"bias section: {len(words)} words, {own}/{len(bias_words)} own bias "
                      f"words present, {100 * in_pool / max(1, len(words)):.0f}% from bias pool")
                # the dataset truncates to bias_nums: own words beyond the
                # cap are legitimately absent
                expected = min(len([w for w in bias_words if w]),
                               ds.bias_nums or 0) if ds.bias_nums else \
                    len([w for w in bias_words if w])
                assert own >= expected, "own bias word missing"
    print("\nOK: prompt construction invariants hold.")
    return ds


if __name__ == "__main__":
    main()
