"""Language identification (multilingual models).

The counterpart of the JAX package's ``decode/language.py``: Whisper detects
the spoken language from the decoder's first-step distribution after
``<|startoftranscript|>``, restricted to the language tokens. One encoder
pass (or the caller's encoder states) and one full-sequence decoder step;
only a (B, n_lang) probability matrix comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.whisper import Whisper, decode_tokens, encode_audio
from ..tokenizer.whisper_tokenizer import LANGUAGES


def resolve_start_tokens(
    tokenizer,
    n: int,
    language: str | None = None,
    task: str = "transcribe",
    detect=None,
) -> tuple[list[list[int]] | None, list[str | None]]:
    """The one place start sequences for language/task forcing are built
    (the transcribe CLI and ``Pipeline`` route here).

    Returns ``(starts, langs)`` for ``n`` rows: ``None`` starts means the
    default bare ``[<|sot|>]`` prefix. ``language`` is a code, ``"auto"``,
    or None; ``task="translate"`` without a language implies detection.
    ``detect`` is a zero-arg callable returning per-row ``(lang, prob)``
    pairs, required only when detection is implied. Raises ``ValueError``
    for unknown codes, non-multilingual misuse, or a missing detector."""
    if not tokenizer.multilingual:
        if language or task == "translate":
            raise ValueError("language/task forcing needs a multilingual model/tokenizer")
        return None, [None] * n
    if not language and task == "transcribe":
        return None, [None] * n
    task_id = tokenizer.translate if task == "translate" else tokenizer.transcribe
    if language and language != "auto":
        # validate against the language list, not the special-token map:
        # every special ("transcribe", "0.00", ...) has a <|...|> token
        if language not in LANGUAGES[: tokenizer.num_languages]:
            raise ValueError(f"unknown language code: {language}")
        lid = tokenizer.convert_tokens_to_ids(f"<|{language}|>")
        return [[tokenizer.sot, lid, task_id]] * n, [language] * n
    if detect is None:
        raise ValueError("language detection needed (language='auto', or translate without a "
                         "language) but no detector was provided")
    starts, langs = [], []
    for lang, _ in detect():
        starts.append([tokenizer.sot, tokenizer.convert_tokens_to_ids(f"<|{lang}|>"), task_id])
        langs.append(lang)
    return starts, langs


@torch.no_grad()
def detect_language(model: Whisper, tokenizer, mel=None, *,
                    enc_out: torch.Tensor | None = None) -> list[tuple[str, float]]:
    """Per-clip ``(language_code, probability)`` for a batch of log-mels
    (B, n_mels, frames), or for encoder states ``enc_out`` the caller
    already has. Needs a multilingual tokenizer."""
    if not tokenizer.multilingual:
        raise ValueError("language detection needs a multilingual model/tokenizer")
    langs = LANGUAGES[: tokenizer.num_languages]
    lang_ids = [tokenizer.convert_tokens_to_ids(f"<|{lang}|>") for lang in langs]
    device = next(model.parameters()).device
    if enc_out is None:
        feats = mel if isinstance(mel, torch.Tensor) else torch.as_tensor(np.asarray(mel))
        enc_out = encode_audio(model, feats.to(device=device, dtype=torch.float32))
    tokens = torch.full((enc_out.shape[0], 1), tokenizer.sot, dtype=torch.int64, device=device)
    logits, _ = decode_tokens(model, tokens, enc_out=enc_out)
    ids = torch.as_tensor(lang_ids, dtype=torch.int64, device=device)
    probs = torch.softmax(logits[:, 0].float()[:, ids], dim=-1).cpu().numpy()
    best = probs.argmax(axis=-1)
    return [(langs[i], float(probs[r, i])) for r, i in enumerate(best)]
