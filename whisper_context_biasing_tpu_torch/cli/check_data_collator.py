"""Inspection harness for the collator contract: the port's counterpart of
the JAX package's ``scripts/check_data_collator.py`` (reference
scripts/check_data_collator.py parity)::

    python -m whisper_context_biasing_tpu_torch.cli.check_data_collator \\
        --data_root corpus --data_dir audio --jsonl_data corpus/jsonl --prompt

Takes the first batch of a dataset and prints the aligned labels-before /
decoder_input_ids / labels-after table that verifies the shift by one and
the -100 masking, then asserts that contract for every sample. Runs on the
CPU."""

from __future__ import annotations

import argparse
import os

from ..config import DATA_DIR, DATA_ROOT, JSONL_DATA
from ..data import PromptWhisperDataset, SpeechSeq2SeqCollator
from ..tokenizer import load_tokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default=DATA_ROOT)
    p.add_argument("--data_dir", default=DATA_DIR)
    p.add_argument("--jsonl_data", default=JSONL_DATA)
    p.add_argument("--phase", default="test")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt", action="store_true")
    p.add_argument("--bias_list", action="store_true")
    p.add_argument("--bias_nums", type=int, default=0)
    p.add_argument("--bias_desc", action="store_true")
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    tok = load_tokenizer(args.vocab, args.merges)
    ds = PromptWhisperDataset(
        base_path=os.path.join(args.data_root, args.data_dir),
        jsonl_data=args.jsonl_data, phase=args.phase, tokenizer=tok,
        prompt=args.prompt, bias_list=args.bias_list,
        bias_nums=args.bias_nums, bias_desc=args.bias_desc,
    )
    coll = SpeechSeq2SeqCollator(
        pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
        decoder_prev_token_id=tok.sop,
    )
    items = [ds[i] for i in range(min(args.batch, len(ds)))]
    batch = coll(items)

    print(f"input_features: {batch['input_features'].shape}")
    print(f"labels:         {batch['labels'].shape}")
    print(f"decoder_input:  {batch['decoder_input_ids'].shape}")
    if "bias_spans" in batch:
        print(f"bias_spans:     {batch['bias_spans'].shape}")

    for i in range(len(items)):
        before = items[i]["labels"].tolist()
        dec = batch["decoder_input_ids"][i].tolist()
        after = batch["labels"][i].tolist()
        print(f"\n=== Sample {i} ===")
        print(f"{'Pos':<5} {'before':<10} {'dec_input':<10} {'label':<10} decoded(label)")
        print("-" * 60)
        for t in range(len(dec)):
            b = before[t] if t < len(before) else ""
            lab = after[t]
            dec_s = tok.decode([lab]) if lab >= 0 else "(-100)"
            print(f"{t:<5} {str(b):<10} {dec[t]:<10} {lab:<10} {dec_s[:24]}")

        # invariant checks (the collator contract)
        n = len(before)
        assert dec[: n - 1] == before[:-1], "decoder_input_ids != labels[:-1]"
        sot_at = before.index(tok.sot)
        # sot at position 0 (unprompted) has no prompt region: a raw
        # `after[: sot_at - 1]` would wrap to after[:-1] and fail spuriously
        prompt_end = max(sot_at - 1, 0)
        assert all(x == -100 for x in after[:prompt_end]), "prompt not masked"
        assert after[prompt_end: n - 1] == before[prompt_end + 1:], "transcript corrupted"
        assert all(x == -100 for x in after[n - 1:]), "padding not masked"
    print("\nOK: shift/mask contract holds for all samples.")
    return batch


if __name__ == "__main__":
    main()
