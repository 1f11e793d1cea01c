"""Offline corpus preparation — the reference's GPT-3.5 labeling notebook
(data/convert_bias_list.ipynb, SURVEY.md §2 C14) rebuilt as a library; a
copy of the JAX package's ``data/prepare.py`` on the port's ``read_jsonl``:

  1. manifest building: walk transcript files / jsonl -> rows
     ``{id, file, text}`` (notebook cell 0)
  2. train/dev sampling with a fixed seed (cells 1-2)
  3. per-utterance *description* generation (cells 5, 9-12)
  4. *bias-word* extraction restricted to clinical-entity categories
     (cell 14)
  5. merge -> final ``{id, file, text, description, bias_words}`` jsonl
     (cells 15-22)

Labeling backends are pluggable: an LLM callable (the reference used the
OpenAI API; any ``fn(prompt) -> str`` works), a lexicon matcher seeded from
NER-style files like the reference's ``bias_words_labeled.jsonl``, and a
rule-based heuristic for brand-like out-of-vocabulary terms so the pipeline
is fully functional offline.
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Callable, Iterable, Sequence

from .dataset import read_jsonl

# entity categories the reference restricts bias words to (notebook cell 14)
BIAS_CATEGORIES = {"DRUGCHEMICAL", "DIAGNOSTICS", "MEDDEVICETECHNIQUE"}

_WORD_RE = re.compile(r"[A-Za-z][A-Za-z0-9'\-]+")

# small high-frequency English vocabulary for the OOV heuristic
_COMMON = frozenset("""
the a an and or but of to in for on with at by from as is are was were be been
being have has had do does did will would can could should may might must not
no yes this that these those it its he she they we you i your his her their our
take takes taking taken use uses using used make makes made help helps helping
daily twice once before after during against about between into over under
doctor patient medication medicine treatment symptom symptoms relief pain
blood pressure heart health healthcare provider prescription dose dosage tablet
tab capsule effective commonly common used treat treating treats reduce reduces
body skin eye ear nose throat stomach liver kidney severe mild allergies
allergy infection fever cold cough check consult sure keep ensure if when while
might also more most less least very works work recommended available known
""".split())


def build_manifest(
    source: str, audio_suffix: str = ".mp3", text_key: str = "text"
) -> list[dict]:
    """Rows {id, file, text} from a jsonl file or a directory of per-utterance
    json files (the notebook's walk over transcript dumps)."""
    rows: list[dict] = []
    if os.path.isfile(source):
        for r in read_jsonl(source):
            rows.append({
                "id": r.get("id", str(len(rows))),
                "file": r.get("file", ""),
                "text": r.get(text_key, ""),
            })
        return rows
    for root, _, files in sorted(os.walk(source)):
        for fn in sorted(files):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(root, fn), encoding="utf-8") as f:
                d = json.load(f)
            rid = d.get("id", os.path.splitext(fn)[0])
            rows.append({
                "id": rid,
                "file": d.get("file", os.path.splitext(fn)[0] + audio_suffix),
                "text": d.get(text_key, ""),
            })
    return rows


def split_train_dev(
    rows: Sequence[dict], n_train: int, n_dev: int, seed: int = 0
) -> tuple[list[dict], list[dict]]:
    """Shuffled sample split (notebook's 4250/750 draw)."""
    rng = random.Random(seed)
    shuffled = list(rows)
    rng.shuffle(shuffled)
    if n_train + n_dev > len(shuffled):
        raise ValueError(f"asked for {n_train}+{n_dev} from {len(shuffled)} rows")
    return shuffled[:n_train], shuffled[n_train : n_train + n_dev]


# ---------------------------------------------------------------------------
# description generation
# ---------------------------------------------------------------------------

DESCRIPTION_PROMPT = (
    "Write one short clinical-context description sentence for the following "
    "medical utterance. Mention the clinical purpose. Utterance: {text}"
)


def label_descriptions(
    rows: Iterable[dict],
    llm: Callable[[str], str] | None = None,
) -> list[dict]:
    """Add a ``description`` to each row. With an LLM callable, ask it (the
    reference's GPT-3.5 flow); otherwise fall back to description := text —
    exactly the degenerate labeling visible in the committed test split
    (data/medical-united-syn-med-test-jsonl/test.jsonl rows where description
    equals the transcript)."""
    out = []
    for r in rows:
        r = dict(r)
        if llm is not None:
            r["description"] = llm(DESCRIPTION_PROMPT.format(text=r["text"])).strip()
        else:
            r["description"] = r["text"]
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# bias-word extraction
# ---------------------------------------------------------------------------

BIAS_PROMPT = (
    "Extract the drug, device, and diagnostic names (categories DRUGCHEMICAL, "
    "DIAGNOSTICS, MEDDEVICETECHNIQUE) from this utterance as a JSON list of "
    "strings. Utterance: {text}"
)


def lexicon_from_labeled(path: str, categories: set[str] = BIAS_CATEGORIES) -> set[str]:
    """Build a bias lexicon from an NER-style jsonl (the reference's
    data/bias_words_labeled.jsonl schema: entities=[{word, type}])."""
    lex: set[str] = set()
    for r in read_jsonl(path):
        for ent in r.get("entities", []):
            if ent.get("type") in categories and ent.get("word"):
                lex.add(ent["word"].lower())
    return lex


def _rule_candidates(text: str, corpus_df: dict[str, int], n_rows: int) -> list[str]:
    """Heuristic brand-name detector: rare, non-common-English tokens."""
    out = []
    for m in _WORD_RE.finditer(text):
        w = m.group(0)
        lw = w.lower().strip("-'")
        if len(lw) < 4 or lw in _COMMON:
            continue
        # rare across the corpus (brand names are utterance-specific)
        if corpus_df.get(lw, 0) > max(2, n_rows // 100):
            continue
        out.append(w)
    # dedup preserving order
    seen: set[str] = set()
    uniq = []
    for w in out:
        if w.lower() not in seen:
            seen.add(w.lower())
            uniq.append(w)
    return uniq


def extract_bias_words(
    rows: Iterable[dict],
    llm: Callable[[str], str] | None = None,
    lexicon: set[str] | None = None,
) -> list[dict]:
    """Add ``bias_words`` per row. Priority: LLM JSON output (reference flow)
    > lexicon matches > rule-based rare-token heuristic."""
    rows = [dict(r) for r in rows]
    if llm is not None:
        for r in rows:
            raw = llm(BIAS_PROMPT.format(text=r["text"]))
            try:
                words = json.loads(raw)
                r["bias_words"] = [str(w) for w in words if str(w).strip()]
            except (json.JSONDecodeError, TypeError):
                r["bias_words"] = []
        return rows

    if lexicon:
        lex_lower = {w.lower() for w in lexicon}
        for r in rows:
            text_l = r["text"].lower()
            hits = [w for w in lex_lower if w in text_l]
            # keep the surface form from the utterance when possible
            words = []
            for h in sorted(hits, key=len, reverse=True):
                m = re.search(re.escape(h), r["text"], re.IGNORECASE)
                words.append(m.group(0) if m else h)
            r["bias_words"] = words
        return rows

    # rule-based fallback
    df: dict[str, int] = {}
    for r in rows:
        for w in {m.group(0).lower() for m in _WORD_RE.finditer(r["text"])}:
            df[w] = df.get(w, 0) + 1
    for r in rows:
        r["bias_words"] = _rule_candidates(r["text"], df, len(rows))
    return rows


def write_jsonl(rows: Iterable[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
