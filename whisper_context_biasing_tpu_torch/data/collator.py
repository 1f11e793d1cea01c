"""Batch collation.

Rebuild of the reference collator contract
(data_utils/data_collator.py:27-127), producing numpy arrays ready for device
put:

  * ``input_features``: stacked (B, n_mels, 3000) float32
  * teacher-forcing shift: ``decoder_input_ids = padded[:, :-1]``,
    ``labels = padded[:, 1:]`` (data_collator.py:90-91)
  * label padding -> -100 via the attention mask (data_collator.py:94-96)
  * prompt masking: all label positions before the first
    ``decoder_start_token_id`` (<|startoftranscript|>) -> -100
    (data_collator.py:98-102); rows without a SOT are left unmasked
    (argmax-of-zeros = 0 quirk, replicated)
  * ``bias_spans`` -> dense (B, max_n_spans, max_span_len) int32 padded with
    50256, with an all-zeros (B, 1, 1) fallback when no sample has spans
    (data_collator.py:107-125 — the fallback is zeros, not 50256, replicated)

TPU-first additions (static shapes for XLA, no recompilation per batch):
  * ``pad_to_multiple``: label length padded up to a multiple
  * ``max_target_length`` / ``max_spans``: hard static shapes
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

IGNORE_INDEX = -100
BIAS_SPAN_PAD_ID = 50256


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class SpeechSeq2SeqCollator:
    pad_token_id: int
    decoder_start_token_id: int
    decoder_prev_token_id: int | None = None
    pad_to_multiple: int | None = None
    max_target_length: int | None = None
    max_spans: tuple[int, int] | None = None  # (max_n_spans, max_span_len), static
    # bucket dynamic span dims to a multiple so decode/serving paths reuse a
    # handful of compiled programs instead of one per distinct (N, K)
    span_pad_multiple: int | None = None
    # multilingual models: pass tokenizer.eot (50257); default is the .en
    # layout's eot (the reference's hardcoded 50256 contract)
    bias_span_pad_id: int = BIAS_SPAN_PAD_ID

    def __call__(self, features: Sequence[dict]) -> dict:
        batch: dict = {}

        if "input_features" in features[0]:
            batch["input_features"] = np.stack(
                [np.asarray(f["input_features"], dtype=np.float32) for f in features]
            )
        elif "audio" in features[0]:
            # raw-audio path: mel runs batched on device (the fused Pallas
            # frontend); fixed 30 s window for static shapes
            fixed = 480000
            audio = np.zeros((len(features), fixed), dtype=np.float32)
            for i, f in enumerate(features):
                a = np.asarray(f["audio"], np.float32)[:fixed]
                audio[i, : len(a)] = a
            batch["audio"] = audio

        label_seqs = [np.asarray(f["labels"], dtype=np.int64) for f in features]
        longest = max(len(s) for s in label_seqs)
        if self.max_target_length and longest > self.max_target_length:
            raise ValueError(
                f"label sequence of length {longest} exceeds static "
                f"max_target_length {self.max_target_length}"
            )
        padded_len = longest
        if self.pad_to_multiple:
            padded_len = _ceil_to(padded_len, self.pad_to_multiple)
        if self.max_target_length:
            # HARD static shape: every batch pads to exactly this length
            # (ceil-to-multiple must not push a longest==max batch past it)
            padded_len = self.max_target_length

        padded = np.full((len(label_seqs), padded_len), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(label_seqs), padded_len), dtype=np.int64)
        for i, s in enumerate(label_seqs):
            padded[i, : len(s)] = s
            mask[i, : len(s)] = 1

        decoder_input_ids = padded[:, :-1].copy()
        labels = padded[:, 1:].copy()
        labels_mask = mask[:, 1:]
        labels[labels_mask != 1] = IGNORE_INDEX

        if self.decoder_prev_token_id is not None:
            # first <|startoftranscript|> per row; argmax yields 0 when absent,
            # masking nothing — same as the reference
            sot_pos = np.argmax(labels == self.decoder_start_token_id, axis=1)
            prompt_mask = np.arange(labels.shape[1])[None, :] < sot_pos[:, None]
            labels = np.where(prompt_mask, IGNORE_INDEX, labels)

        batch["labels"] = labels.astype(np.int32)
        batch["decoder_input_ids"] = decoder_input_ids.astype(np.int32)

        if "bias_spans" in features[0]:
            batch["bias_spans"] = self.pad_bias_spans([f["bias_spans"] for f in features])
        return batch

    def pad_bias_spans(self, raw_spans: Sequence[Sequence[Sequence[int]]]) -> np.ndarray:
        max_span_len = max((len(s) for sample in raw_spans for s in sample), default=0)
        max_n_spans = max((len(sample) for sample in raw_spans), default=0)
        if self.span_pad_multiple and max_span_len > 0:
            m = self.span_pad_multiple
            max_span_len = ((max_span_len + m - 1) // m) * m
            max_n_spans = ((max_n_spans + m - 1) // m) * m
        if self.max_spans is not None:
            static_n, static_k = self.max_spans
            if max_n_spans > static_n or max_span_len > static_k:
                raise ValueError(
                    f"bias spans ({max_n_spans}, {max_span_len}) exceed static "
                    f"max_spans {self.max_spans}"
                )
            max_n_spans, max_span_len = static_n, static_k

        if max_span_len == 0 or max_n_spans == 0:
            # all-empty fallback: zeros, shape (B, 1, 1) (data_collator.py:114-117)
            return np.zeros((len(raw_spans), 1, 1), dtype=np.int32)

        out = np.full((len(raw_spans), max_n_spans, max_span_len),
                      self.bias_span_pad_id, dtype=np.int32)
        for i, sample in enumerate(raw_spans):
            for j, span in enumerate(sample):
                out[i, j, : len(span)] = span
        return out
