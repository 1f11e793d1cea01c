"""Offline corpus preparation CLI (the reference's data/convert_bias_list.ipynb
pipeline as a script), the port's counterpart of the JAX package's
``scripts/prepare_data.py``: manifest -> train/dev split -> descriptions ->
bias-word extraction -> final {id, file, text, description, bias_words} jsonl.

Labeling backends: --labeler llm (needs the ``openai`` package,
OPENAI_API_KEY and network, like the reference), --labeler lexicon
(NER-style jsonl via --lexicon), or --labeler rule (offline heuristic,
default)."""

from __future__ import annotations

import argparse
import os
import random

from ..data.prepare import (
    build_manifest,
    extract_bias_words,
    label_descriptions,
    lexicon_from_labeled,
    split_train_dev,
    write_jsonl,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True,
                   help="transcript jsonl or directory of per-utterance json files")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_train", type=int, default=4250)
    p.add_argument("--n_dev", type=int, default=750)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--labeler", choices=("rule", "lexicon", "llm"), default="rule")
    p.add_argument("--lexicon", default=None,
                   help="NER-style jsonl (entities=[{word,type}]) for --labeler lexicon")
    p.add_argument("--llm_model", default="gpt-3.5-turbo")
    p.add_argument("--test_source", default=None,
                   help="optional separate transcript source for the test split")
    return p.parse_args(argv)


def make_llm(model):
    from openai import OpenAI  # gated: requires network + key

    client = OpenAI()

    def ask(prompt: str) -> str:
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}]
        )
        return resp.choices[0].message.content or ""

    return ask


def main(argv=None):
    args = parse_args(argv)
    if not os.path.isdir(args.source):
        raise SystemExit(f"--source directory not found: {args.source}")
    rows = build_manifest(args.source)
    print(f"manifest: {len(rows)} rows")
    if not rows:
        raise SystemExit(f"no transcript rows found under {args.source}")
    if args.n_train + args.n_dev <= len(rows):
        train, dev = split_train_dev(rows, args.n_train, args.n_dev, args.seed)
    else:
        # seeded shuffle so the fallback split is representative and
        # reproducible (a head/tail cut of walk order groups by prefix)
        shuffled = list(rows)
        random.Random(args.seed).shuffle(shuffled)
        cut = int(len(shuffled) * 0.85)
        train, dev = shuffled[:cut], shuffled[cut:]
        print(f"requested split too large; using {len(train)}/{len(dev)}")

    if args.labeler == "lexicon" and not args.lexicon:
        raise SystemExit("--labeler lexicon requires --lexicon")
    llm = make_llm(args.llm_model) if args.labeler == "llm" else None
    lexicon = lexicon_from_labeled(args.lexicon) if args.labeler == "lexicon" else None

    splits = {"train": train, "dev": dev}
    if args.test_source:
        splits["test"] = build_manifest(args.test_source)

    for name, split_rows in splits.items():
        labeled = label_descriptions(split_rows, llm)
        labeled = extract_bias_words(labeled, llm, lexicon)
        out = os.path.join(args.out_dir, f"{name}.jsonl")
        write_jsonl(labeled, out)
        n_bias = sum(1 for r in labeled if r["bias_words"])
        print(f"{name}: {len(labeled)} rows -> {out} ({n_bias} rows with bias words)")


if __name__ == "__main__":
    main()
