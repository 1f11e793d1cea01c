"""Data layer: the prompted jsonl dataset, the batch collator's bias-span
padding contract, the threaded loader with device prefetch, and the offline
corpus preparation (``data/prepare.py``)."""

from .collator import BIAS_SPAN_PAD_ID, IGNORE_INDEX, SpeechSeq2SeqCollator
from .dataset import PromptWhisperDataset, read_jsonl
from .prefetch import BatchLoader, batched_indices, prefetch_to_device

__all__ = [
    "BIAS_SPAN_PAD_ID",
    "SpeechSeq2SeqCollator",
    "IGNORE_INDEX",
    "PromptWhisperDataset",
    "read_jsonl",
    "BatchLoader",
    "batched_indices",
    "prefetch_to_device",
]
