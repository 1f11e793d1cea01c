"""Prediction scoring + artifact writing (the reference ``compute_wer`` flow,
utils/compute_metric.py:92-163).

Contract preserved:
  * label ids with -100 replaced by the pad token
  * everything up to (and including) the first <|startoftranscript|> is cut
    from both labels and predictions — with the REAL sot id (the reference
    hardcodes 20257, a typo that defangs the cut; result-equivalent because
    the collator already masks prompt labels and special tokens are skipped
    at decode — SURVEY.md §7 quirk list says fix)
  * decode with specials skipped, drop 'ignore_time_segment_in_scoring' rows
  * BasicTextNormalizer on both sides
  * artifact: ``Ref : {ref}\\nPred:{pred}\\n\\n`` lines (B-WER parses this file)
  * score: corpus WER * 100
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .normalizer import BasicTextNormalizer
from .wer import corpus_wer

IGNORE_SEGMENT = "ignore_time_segment_in_scoring"


def _cut_after_first(ids: Sequence[int], token: int) -> list[int]:
    ids = list(ids)
    if token in ids:
        return ids[ids.index(token) + 1 :]
    return ids


def score_predictions(
    pred_ids: Sequence[Sequence[int]],
    label_ids: Sequence[Sequence[int]],
    tokenizer,
    refs_pred_file: str | None = None,
) -> dict:
    """Returns {"wer": percent}; optionally writes the refs/pred artifact."""
    normalizer = BasicTextNormalizer()
    sot = tokenizer.sot
    pad = tokenizer.pad_token_id

    results: list[tuple[str, str]] = []
    for pred, label in zip(pred_ids, label_ids):
        label = [pad if t == -100 else int(t) for t in np.asarray(label).tolist()]
        pred = [int(t) for t in np.asarray(pred).tolist()]
        label = _cut_after_first(label, sot)
        pred = _cut_after_first(pred, sot)
        label_str = tokenizer.decode(label, skip_special_tokens=True)
        pred_str = tokenizer.decode(pred, skip_special_tokens=True)
        if label_str == IGNORE_SEGMENT:
            continue
        results.append((normalizer(label_str), normalizer(pred_str)))

    if refs_pred_file:
        os.makedirs(os.path.dirname(refs_pred_file) or ".", exist_ok=True)
        with open(refs_pred_file, "w", encoding="utf-8") as f:
            for ref, pred in results:
                # the reference writes "Pred:{pred}" and its parser slices
                # column 6 — correct only because real-vocab decodes start
                # with a space; pad when they don't so the artifact stays
                # parser-safe (byte-identical for space-leading preds)
                if not pred.startswith(" "):
                    pred = " " + pred
                f.write(f"Ref : {ref}\n")
                f.write(f"Pred:{pred}\n\n")

    refs = [r for r, _ in results]
    preds = [p for _, p in results]
    if not refs:
        return {"wer": 0.0}
    return {"wer": 100.0 * corpus_wer(refs, preds)}
