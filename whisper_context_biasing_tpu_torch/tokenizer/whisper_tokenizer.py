"""Whisper tokenizer: byte-level BPE + the Whisper special-token id layout.

Reproduces the id-space contract the reference relies on (all cites are
reference files):

  * ``<|endoftext|>`` is the pad token; bias-span padding id 50256
    (data_utils/data_collator.py:119-125)
  * ``<|startoftranscript|>`` = 50257 (.en layout) is the collator's
    prompt-mask boundary (data_utils/data_collator.py:98-102)
  * ``<|startofprev|>`` introduces the conditioning context
    (data_utils/data_loader.py:183)
  * ``encode(text)`` with specials yields
    ``<|startoftranscript|> <|notimestamps|> ... <|endoftext|>`` for
    English-only models (the labels contract, data_utils/data_loader.py:175)
  * the special set {50256, 50257, 50258, 50358, 50362} named in
    scripts/check_WeightCE.py:9 falls out of this layout

Special-token layout (public Whisper definition). For English-only models the
base GPT-2 vocab occupies ids 0..50256 (``<|endoftext|>`` = 50256) and
specials stack from 50257; for multilingual models specials stack from 50257
starting with a fresh ``<|endoftext|>``:

    .en  : sot=50257, langs 50258..50356, translate=50357, transcribe=50358,
           startoflm=50359, startofprev=50360, nospeech=50361,
           notimestamps=50362, timestamps 50363..51863   (vocab 51864)
    multi: eot=50257, sot=50258, langs 50259..50358(+yue for v3),
           then the six task specials, timestamps ...     (vocab 51865/51866)
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .bpe import ByteLevelBPE

# Whisper language codes in canonical order (public constant; 99 languages,
# large-v3 appends "yue").
LANGUAGES: tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl",
    "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro",
    "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy",
    "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu",
    "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km",
    "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi", "lo",
    "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl", "mg",
    "as", "tt", "haw", "ln", "ha", "ba", "jw", "su", "yue",
)

N_TIMESTAMP_TOKENS = 1501  # <|0.00|> .. <|30.00|> in 0.02 s steps


class WhisperTokenizer:
    """Framework tokenizer with the reference-compatible API subset:
    ``encode``, ``decode``, ``batch_decode``, ``convert_tokens_to_ids``,
    ``pad_token_id``, ``eos_token_id``."""

    def __init__(
        self,
        bpe: ByteLevelBPE | None = None,
        multilingual: bool = False,
        num_languages: int = 99,
        language: str = "en",
        task: str = "transcribe",
        predict_timestamps: bool = False,
    ):
        self.bpe = bpe if bpe is not None else ByteLevelBPE.byte_fallback()
        self.multilingual = multilingual
        self.num_languages = num_languages
        self.language = language
        self.task = task
        self.predict_timestamps = predict_timestamps

        base = 50257  # GPT-2 byte-level BPE id-space extent
        specials: list[str] = []
        if multilingual:
            specials.append("<|endoftext|>")
        specials.append("<|startoftranscript|>")
        specials.extend(f"<|{lang}|>" for lang in LANGUAGES[:num_languages])
        specials.extend(
            ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
             "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
        )
        self._special_to_id: dict[str, int] = {}
        next_id = base
        if not multilingual:
            # GPT-2's own <|endoftext|> sits inside the base vocab at 50256.
            self._special_to_id["<|endoftext|>"] = 50256
        for name in specials:
            self._special_to_id[name] = next_id
            next_id += 1
        self.timestamp_begin = next_id
        for i in range(N_TIMESTAMP_TOKENS):
            self._special_to_id[f"<|{i * 0.02:.2f}|>"] = next_id
            next_id += 1
        self.vocab_size = next_id
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}

        self.eot = self._special_to_id["<|endoftext|>"]
        self.sot = self._special_to_id["<|startoftranscript|>"]
        self.sop = self._special_to_id["<|startofprev|>"]
        self.no_timestamps = self._special_to_id["<|notimestamps|>"]
        self.transcribe = self._special_to_id["<|transcribe|>"]
        self.translate = self._special_to_id["<|translate|>"]
        self.no_speech = self._special_to_id["<|nospeech|>"]

    # -- HF-compatible surface ---------------------------------------------------

    @property
    def pad_token_id(self) -> int:
        return self.eot

    @property
    def eos_token_id(self) -> int:
        return self.eot

    def convert_tokens_to_ids(self, token: str) -> int | None:
        if token in self._special_to_id:
            return self._special_to_id[token]
        return self.bpe.encoder.get(token)

    @property
    def prefix_tokens(self) -> list[int]:
        """The forced decoder prefix that ``encode(..., add_special_tokens=True)``
        prepends: ``[sot]`` (+ lang + task when multilingual) + ``[notimestamps]``
        unless timestamps are being predicted."""
        prefix = [self.sot]
        if self.multilingual:
            lang_id = self._special_to_id.get(f"<|{self.language}|>")
            if lang_id is None:
                raise ValueError(f"unknown language: {self.language}")
            prefix.append(lang_id)
            prefix.append(self.transcribe if self.task == "transcribe" else self.translate)
        if not self.predict_timestamps:
            prefix.append(self.no_timestamps)
        return prefix

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = self.bpe.encode(text)
        if add_special_tokens:
            return self.prefix_tokens + ids + [self.eot]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        """Minimal BatchEncoding shim: ``tokenizer(text).input_ids``."""

        class _Enc:
            def __init__(enc_self, input_ids):
                enc_self.input_ids = input_ids

        return _Enc(self.encode(text, add_special_tokens=add_special_tokens))

    def is_special(self, token_id: int) -> bool:
        return int(token_id) in self._id_to_special

    @property
    def special_ids(self) -> frozenset[int]:
        return frozenset(self._id_to_special)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        out: list[str] = []
        plain: list[int] = []

        def flush():
            if plain:
                out.append(self.bpe.decode(plain))
                plain.clear()

        for raw in ids:
            i = int(raw)
            if i < 0:
                continue  # -100 label fill etc.
            if i in self._id_to_special:
                if not skip_special_tokens:
                    flush()
                    out.append(self._id_to_special[i])
            elif i >= self.timestamp_begin:
                # timestamp tokens are not BPE ids; render like specials
                if not skip_special_tokens:
                    flush()
                    out.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                plain.append(i)
        flush()
        return "".join(out)

    def batch_decode(
        self, batch: Sequence[Iterable[int]], skip_special_tokens: bool = False
    ) -> list[str]:
        return [self.decode(ids, skip_special_tokens=skip_special_tokens) for ids in batch]

    def timestamp_value(self, token_id: int) -> float | None:
        """Seconds encoded by a timestamp token, or None."""
        i = int(token_id)
        if self.timestamp_begin <= i < self.timestamp_begin + N_TIMESTAMP_TOKENS:
            return (i - self.timestamp_begin) * 0.02
        return None

    def split_timestamp_segments(
        self, ids: Iterable[int]
    ) -> list[tuple[float, float | None, str]]:
        """Split a timestamped token stream into (start_s, end_s, text)
        segments (for models decoded with predict_timestamps)."""
        segments: list[tuple[float, float | None, str]] = []
        start: float | None = None
        buf: list[int] = []
        for raw in ids:
            t = self.timestamp_value(int(raw))
            if t is None:
                if not self.is_special(int(raw)) and int(raw) >= 0:
                    buf.append(int(raw))
                continue
            if start is None:
                start = t
            elif buf:
                segments.append((start, t, self.bpe.decode(buf)))
                buf, start = [], None
            else:
                start = t
        if buf:
            segments.append((start or 0.0, None, self.bpe.decode(buf)))
        return segments


def load_tokenizer(
    vocab_path: str | None = None,
    merges_path: str | None = None,
    multilingual: bool = False,
    num_languages: int = 99,
    **kwargs,
) -> WhisperTokenizer:
    """Build a tokenizer: real GPT-2/Whisper vocab when files are given
    (``vocab.json``+``merges.txt``, or a single HF ``tokenizer.json`` as
    ``vocab_path``), otherwise the deterministic offline byte-fallback
    vocab."""
    if vocab_path is not None and vocab_path.endswith("tokenizer.json"):
        bpe = ByteLevelBPE.from_tokenizer_json(vocab_path)
    elif vocab_path is not None and merges_path is not None:
        bpe = ByteLevelBPE.from_files(vocab_path, merges_path)
    else:
        bpe = ByteLevelBPE.byte_fallback()
    return WhisperTokenizer(bpe, multilingual=multilingual, num_languages=num_languages, **kwargs)
