"""Prompted jsonl dataset.

Behavior-compatible rebuild of the reference's ``PromptWhisperDataset``
(data_utils/data_loader.py:58-376): a map-style dataset over
``{jsonl_data}/{phase}.jsonl`` rows ``{id, file, text, description,
bias_words[]}`` producing ``{"input_features", "labels", "bias_spans"}``.

Prompt strategies (ids match SURVEY.md §2 C2):
  1 desc-only      (prompt):                [sop] + desc[:190]                + label
  2 bias-list-only (bias_list, bias_nums>0):[sop] + bias_seq                  + label
  3 desc+bias      (both, not bias_desc):   [sop] + desc[:150] + "Relate terms: " + bias_seq + label
  4 bias+desc      (both, bias_desc):       [sop] + "Relate terms: " + bias_seq + desc[:150] + label

where ``label = tokenizer.encode(text.lower())`` WITH special tokens
(data_loader.py:175 — labels carry <|sot|><|notimestamps|>…<|eot|>), the
bias sequence is the sample's own bias words plus random draws from the
corpus-wide bias pool up to ``bias_nums`` joined by encoded spaces
(data_loader.py:209-243), and with ``random=True`` in a train phase the
description is replaced by a random one with probability 5%
(data_loader.py:190-193).

Deliberate fixes over the reference (SURVEY.md §7 quirk list):
  * ``get_bias_spans`` needs only the tokenizer — callers no longer decode the
    full audio set just to read spans (scripts/train.py:163 quirk)
  * RNG is instance-seeded for reproducibility instead of global
  * dead ``audio_type`` arg is accepted but unused, documented here

A copy of the JAX package's ``data/dataset.py`` on the port's host-side
audio loading (``audio.load_audio``: WAV, and the corpus's ``.mp3`` through
libmpg123) and its numpy log-mel; the items are numpy arrays,
the same as the JAX package's.
"""

from __future__ import annotations

import json
import os
import random as _random
from typing import Callable, Sequence

import numpy as np

from ..audio import load_audio, log_mel_spectrogram_np

_PUNCT_STRIP = (",", "?", ".", "!", ";")


def read_jsonl(path: str) -> list[dict]:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"jsonl file not found: {path}")
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"[WARNING] ignoring malformed json line: {line.strip()[:80]}")
    return rows


class PromptWhisperDataset:
    def __init__(
        self,
        base_path: str,
        jsonl_data: str,
        phase: str,
        feature_extractor: Callable[[np.ndarray], np.ndarray] | None = None,
        tokenizer=None,
        prompt: bool = False,
        bias_list: bool = False,
        audio_type: str = ".wav",  # accepted for API parity; unused (as in the reference)
        sample_rate: int = 16000,
        random: bool = False,
        bias_nums: int = 0,
        bias_desc: bool = False,
        seed: int | None = 0,
        return_audio: bool = False,
        n_mels: int = 80,  # 128 for large-v3; used by the default extractor
        speed_perturb: tuple[float, ...] | None = None,  # e.g. (0.9, 1.0, 1.1):
                          # classic sox-style speed augmentation (train phase
                          # only; resample-based, pitch shifts with speed).
                          # Per-(seed, epoch, idx) draw like the 5% text
                          # perturbation, so epochs re-draw deterministically
    ):
        if tokenizer is None:
            raise ValueError("tokenizer is required")
        self.base_path = base_path
        self.jsonl_data = jsonl_data
        self.phase = phase
        self.sample_rate = sample_rate
        self.prompt = prompt
        self.bias_list = bias_list
        self.random_prompt = random
        self.bias_nums = bias_nums
        self.bias_desc = bias_desc
        self.tokenizer = tokenizer
        self.feature_extractor = feature_extractor or (
            lambda audio: log_mel_spectrogram_np(audio, n_mels=n_mels)
        )
        self.return_audio = return_audio
        self.speed_perturb = tuple(speed_perturb) if speed_perturb else None
        # load-time draws (per-sample random prompt) use one seeded stream;
        # per-__getitem__ draws derive from (seed, epoch_hint, idx) so
        # threaded loading stays deterministic AND each epoch re-draws the
        # 5% perturbation (reference semantics: fresh torch.rand per access,
        # data_loader.py:190). BatchLoader bumps epoch_hint per epoch.
        self._seed = seed or 0
        self.epoch_hint = 0
        self.rng = _random.Random(seed)

        rows = read_jsonl(os.path.join(jsonl_data, f"{phase}.jsonl"))

        # prompt pool: every non-empty description (data_loader.py:82-99)
        self.prompt_pool = [r.get("description", "") for r in rows if r.get("description", "")]

        # bias / non-bias pools (data_loader.py:101-122)
        self.bias_pool: set[str] = set()
        self.non_bias_pool: set[str] = set()
        for r in rows:
            for w in r.get("bias_words", []):
                self.bias_pool.add(w.lower())
        for r in rows:
            for w in r.get("text", "").lower().split():
                cleaned = "".join(ch for ch in w if ch not in _PUNCT_STRIP)
                if cleaned and cleaned not in self.bias_pool:
                    self.non_bias_pool.add(cleaned)

        # per-sample records; one random prompt drawn at load time per sample
        # (data_loader.py:144)
        self.data: list[list] = []
        for r in rows:
            fn = r.get("file", "")
            if not fn:
                continue
            self.data.append([
                fn,
                r.get("description", ""),
                self.rng.choice(self.prompt_pool) if self.prompt_pool else "",
                r.get("text", ""),
                r.get("bias_words", []),
            ])

    def __len__(self) -> int:
        return len(self.data)

    # -- spans (tokenizer-only; no audio decode) -------------------------------

    def get_bias_spans(self, idx: int) -> list[list[int]]:
        """Token-id spans of each bias word (data_loader.py:163-167):
        ``encode(word.lower())`` without specials, empty encodings dropped."""
        spans = []
        for word in self.data[idx][4]:
            ids = self.tokenizer.encode(word.lower(), add_special_tokens=False)
            if ids:
                spans.append(ids)
        return spans

    def all_bias_spans(self) -> list[list[list[int]]]:
        return [self.get_bias_spans(i) for i in range(len(self))]

    # -- prompt construction ----------------------------------------------------

    def _item_rng(self, idx: int, stream: int = 0) -> _random.Random:
        """Deterministic per-(seed, epoch, index) RNG: immune to thread
        scheduling in BatchLoader, reproducible across resumed runs.
        ``stream`` derives an independent sequence for a second per-item
        draw (speed perturbation vs prompt perturbation)."""
        return _random.Random(
            (self._seed * 1_000_003 + self.epoch_hint) * 2_654_435_761
            + idx + stream * 1_000_000_007)

    def _select_prompt_text(self, description: str, random_prompt: str,
                            rng: _random.Random) -> str:
        """5% context perturbation, train phase only (data_loader.py:187-193)."""
        if not self.random_prompt or "train" not in self.phase:
            return description
        return random_prompt if rng.random() < 0.05 else description

    def _encode_prompt(self, text: str, max_len: int, idx) -> list[int]:
        if not text:
            print(f"Error extracting prompt of {idx}: prompt text is empty")
            return []
        ids = self.tokenizer.encode(text.lower(), add_special_tokens=False)
        return ids[:max_len]

    def _build_bias_word_list(self, bias_words: Sequence[str], idx,
                              rng: _random.Random) -> list[str]:
        """Own bias words + random pool fill up to bias_nums
        (data_loader.py:209-231). The single sample() either fills the list
        or exhausts the pool, so no retry loop is needed."""
        if not self.bias_pool:
            raise ValueError(f"bias_pool is empty for sample {idx}")
        words = [w.lower() for w in bias_words]
        remaining = self.bias_nums - len(words)
        if remaining > 0:
            available = sorted(self.bias_pool - set(words))
            if available:
                words.extend(rng.sample(available, min(remaining, len(available))))
        return words[: self.bias_nums]

    def _encode_bias_sequence(self, words: Sequence[str], idx) -> list[int]:
        """Space-joined encodings (data_loader.py:233-243)."""
        space = self.tokenizer.encode(" ", add_special_tokens=False)
        out: list[int] = []
        for i, w in enumerate(words):
            out.extend(self.tokenizer.encode(w, add_special_tokens=False))
            if i < len(words) - 1:
                out.extend(space)
        if not out:
            print(f"Warning: encoded bias sequence empty for sample {idx}: {words}")
        return out

    def build_label_sequence(self, idx: int) -> list[int]:
        """The full label sequence including context prefix and specials."""
        _, description, random_prompt, text, bias_words = self.data[idx]
        label = self.tokenizer.encode(text.lower())  # WITH specials
        use_bias = self.bias_list and self.bias_nums > 0
        if not (self.prompt or use_bias):
            return list(label)

        rng = self._item_rng(idx)
        sop = self.tokenizer.convert_tokens_to_ids("<|startofprev|>")
        if self.prompt and not use_bias:  # strategy 1
            ptxt = self._select_prompt_text(description, random_prompt, rng)
            return [sop] + self._encode_prompt(ptxt, 190, idx) + list(label)
        if not self.prompt and use_bias:  # strategy 2
            words = self._build_bias_word_list(bias_words, idx, rng)
            return [sop] + self._encode_bias_sequence(words, idx) + list(label)
        # strategies 3 & 4
        ptxt = self._select_prompt_text(description, random_prompt, rng)
        enc_prompt = self._encode_prompt(ptxt, 150, idx)
        relate = self.tokenizer.encode("Relate terms: ", add_special_tokens=False)
        words = self._build_bias_word_list(bias_words, idx, rng)
        enc_bias = self._encode_bias_sequence(words, idx)
        if not self.bias_desc:  # strategy 3
            return [sop] + enc_prompt + relate + enc_bias + list(label)
        return [sop] + relate + enc_bias + enc_prompt + list(label)  # strategy 4

    # -- items -------------------------------------------------------------------

    def get_audio(self, idx: int) -> np.ndarray:
        path = os.path.join(self.base_path, self.phase, self.data[idx][0])
        return load_audio(path, self.sample_rate)

    def _maybe_speed_perturb(self, audio: np.ndarray, idx: int) -> np.ndarray:
        if not self.speed_perturb or "train" not in self.phase:
            return audio
        factor = self._item_rng(idx, stream=1).choice(self.speed_perturb)
        if factor == 1.0:
            return audio
        # sox `speed` semantics: pretend the samples are at rate*factor and
        # resample back — duration scales by 1/factor, pitch by factor
        from ..audio import resample

        return resample(audio, int(round(self.sample_rate * factor)),
                        self.sample_rate)

    def __getitem__(self, idx: int) -> dict:
        try:
            audio = self._maybe_speed_perturb(self.get_audio(idx), idx)
            item = {
                "labels": np.asarray(self.build_label_sequence(idx), dtype=np.int32),
                "bias_spans": self.get_bias_spans(idx),
            }
            if self.return_audio:
                item["audio"] = audio
            else:
                item["input_features"] = np.asarray(
                    self.feature_extractor(audio), dtype=np.float32
                )
            return item
        except Exception as e:
            print(f"Error processing sample {idx}, file: {self.data[idx][0]}: {e}")
            raise
