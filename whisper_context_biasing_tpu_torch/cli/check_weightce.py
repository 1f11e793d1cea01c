"""Inspection harness for the weighted-CE loss: the port's counterpart of
the JAX package's ``scripts/check_WeightCE.py`` (reference
scripts/check_WeightCE.py parity)::

    python -m whisper_context_biasing_tpu_torch.cli.check_weightce

Fabricates labels and logits from a sample sentence and its bias words,
prints the per-position token / weight / match table, and cross-checks the
port's vectorized ``bias_span_weights`` against a literal host-side replica
of the harness algorithm. Runs on the CPU."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..tokenizer import load_tokenizer
from ..train import bias_span_weights, weighted_ce_loss

PAD = 50256
WHISPER_SPECIAL_TOKENS = {50256, 50257, 50258, 50358, 50362}


def get_sample_data(tokenizer, max_len=76, vocab=51864, seed=0):
    """Sample fabrication mirroring reference scripts/check_WeightCE.py:72-106."""
    text = ("Rekool-L tab, which contains rabeprazole, helps alleviate "
            "symptoms of acid reflux and heartburn.")
    bias_words = ["Rekool-L", "rabeprazole", "acid reflux", "heartburn"]

    tokens = tokenizer.encode(text.lower())
    labels = [-100] * 10 + tokens
    labels = labels[:max_len] + [-100] * max(0, max_len - len(labels))

    spans = [tokenizer.encode(w.lower(), add_special_tokens=False) for w in bias_words]
    k = max(len(s) for s in spans)
    spans = [s + [PAD] * (k - len(s)) for s in spans]

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((1, max_len, vocab)).astype(np.float32)
    return logits, np.asarray([labels], np.int32), np.asarray([spans], np.int32), bias_words


def parse_args(argv=None):
    return argparse.ArgumentParser(
        description="WeightCE span weights against the harness replica").parse_args(argv)


def main(argv=None):
    parse_args(argv)
    tokenizer = load_tokenizer()
    logits, labels, spans, bias_words = get_sample_data(tokenizer)

    weights = bias_span_weights(torch.from_numpy(labels), torch.from_numpy(spans), 1.5).numpy()
    loss = float(weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(spans), 1.5))
    print(f"Computed Loss: {loss:.6f}\n")

    for i in range(labels.shape[0]):
        print(f"=== Sample {i} ===")
        print(f"Bias words: {bias_words}")
        print(f"{'Position':<10} {'Label Token':<14} {'Decoded':<22} {'Weight':<8} {'Match'}")
        print("-" * 70)
        for pos in range(labels.shape[1]):
            tok = int(labels[i, pos])
            decoded = tokenizer.decode([tok]) if tok >= 0 else "(masked)"
            w = float(weights[i, pos])
            match = "Yes" if w != 1.0 else "No"
            print(f"{pos:<10} {tok:<14} {decoded[:20]:<22} {w:<8.2f} {match}")

    # cross-check vs the literal harness algorithm
    ref_w = np.ones(labels.shape, np.float32)
    for i in range(labels.shape[0]):
        for span in spans[i]:
            span = [int(t) for t in span if t != PAD]
            if not span:
                continue
            n = len(span)
            for j in range(labels.shape[1] - n + 1):
                if labels[i, j:j + n].tolist() == span:
                    for kk in range(n):
                        if int(labels[i, j + kk]) not in WHISPER_SPECIAL_TOKENS:
                            ref_w[i, j + kk] = 1.5
    assert np.array_equal(weights, ref_w), "weight mismatch vs harness replica!"
    print("\nOK: vectorized weights identical to the harness replica.")
    return weights, loss


if __name__ == "__main__":
    main()
