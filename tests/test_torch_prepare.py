"""Port parity: the offline corpus preparation (``data/prepare.py``) and its
CLI (``cli.prepare_data``) against the JAX package's, on the inputs of
tests/test_utils_and_prepare.py, with the rule, lexicon and (fake) LLM
labelers: the same rows and the same jsonl files."""

import importlib.util
import json
import os
import sys

import pytest

from whisper_context_biasing_tpu.data import prepare as jax_prepare
from whisper_context_biasing_tpu_torch.cli import prepare_data
from whisper_context_biasing_tpu_torch.data import prepare

ROWS = [
    {"id": "0", "file": "a.mp3", "text": "Take zovirax daily for relief."},
    {"id": "1", "file": "b.mp3", "text": "The nebulizer helps with asthma."},
    {"id": "2", "file": "c.mp3", "text": "Check with your doctor before use."},
]
NER = [{"id": "x", "entities": [
    {"word": "zovirax", "type": "DRUGCHEMICAL"},
    {"word": "nebulizer", "type": "MEDDEVICETECHNIQUE"},
    {"word": "asthma", "type": "DISEASESYMPTOM"},  # excluded category
]}]


def fake_llm(prompt: str) -> str:
    """Descriptions for the description prompt, a JSON list (or, for one
    utterance, not JSON) for the bias-word prompt."""
    if prompt.startswith("Extract"):
        return "not json" if "doctor" in prompt else '["Zovirax", "nebulizer"]'
    return f"  A clinical note of {len(prompt)} characters. "


def _both(fn_name, *args, **kw):
    return getattr(prepare, fn_name)(*args, **kw), getattr(jax_prepare, fn_name)(*args, **kw)


def test_manifest_from_jsonl_and_dir(tmp_path):
    prepare.write_jsonl(ROWS, str(tmp_path / "src.jsonl"))
    got, want = _both("build_manifest", str(tmp_path / "src.jsonl"))
    assert got == want and len(got) == 3
    d = tmp_path / "utts"
    d.mkdir()
    for r in ROWS:
        (d / f"{r['id']}.json").write_text(json.dumps({"id": r["id"], "text": r["text"]}))
    got, want = _both("build_manifest", str(d))
    assert got == want and got[0]["file"] == "0.mp3"


def test_split_matches_jax():
    rows = [{"id": str(i)} for i in range(10)]
    assert prepare.split_train_dev(rows, 7, 3, seed=1) == jax_prepare.split_train_dev(
        rows, 7, 3, seed=1)
    with pytest.raises(ValueError):
        prepare.split_train_dev(rows, 9, 5)


@pytest.mark.parametrize("llm", [None, fake_llm], ids=["fallback", "llm"])
def test_descriptions_and_bias_words_match_jax(llm):
    got, want = _both("label_descriptions", ROWS, llm)
    assert got == want
    got, want = _both("extract_bias_words", got, llm)
    assert got == want
    if llm is None:
        assert "zovirax" in [w.lower() for w in got[0]["bias_words"]]


def test_lexicon_matches_jax(tmp_path):
    prepare.write_jsonl(NER, str(tmp_path / "ner.jsonl"))
    lex, jlex = _both("lexicon_from_labeled", str(tmp_path / "ner.jsonl"))
    assert lex == jlex == {"zovirax", "nebulizer"}
    got, want = _both("extract_bias_words", ROWS, lexicon=lex)
    assert got == want and [w.lower() for w in got[1]["bias_words"]] == ["nebulizer"]


def _jax_script():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "wcb_prepare_data", os.path.join(repo, "scripts", "prepare_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d):
    return {f: (d / f).read_text() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("labeler", ["rule", "lexicon", "llm"])
def test_cli_writes_the_jax_scripts_files(tmp_path, monkeypatch, labeler):
    src = tmp_path / "utts"
    src.mkdir()
    for i in range(8):
        r = ROWS[i % 3]
        (src / f"{i}.json").write_text(json.dumps({"id": str(i), "text": r["text"]}))
    prepare.write_jsonl(NER, str(tmp_path / "ner.jsonl"))
    args = ["--source", str(src), "--n_train", "5", "--n_dev", "2", "--seed", "3",
            "--labeler", labeler, "--test_source", str(src)]
    if labeler == "lexicon":
        args += ["--lexicon", str(tmp_path / "ner.jsonl")]
    script = _jax_script()
    for mod in (script, prepare_data):  # no network: the LLM is the fake one
        monkeypatch.setattr(mod, "make_llm", lambda model: fake_llm)
    prepare_data.main(args + ["--out_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", *args,
                                      "--out_dir", str(tmp_path / "jax")])
    script.main()
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert set(got) == {"train.jsonl", "dev.jsonl", "test.jsonl"}
    # a split larger than the corpus falls back to the seeded 85/15 cut
    prepare_data.main(["--source", str(src), "--n_train", "50",
                       "--out_dir", str(tmp_path / "big")])
    assert len(_files(tmp_path / "big")["train.jsonl"].splitlines()) == 6


def test_cli_refuses_bad_sources(tmp_path):
    with pytest.raises(SystemExit, match="not found"):
        prepare_data.main(["--source", str(tmp_path / "none"), "--out_dir", str(tmp_path)])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no transcript rows"):
        prepare_data.main(["--source", str(tmp_path / "empty"), "--out_dir", str(tmp_path)])
    (tmp_path / "empty" / "0.json").write_text('{"text": "x"}')
    with pytest.raises(SystemExit, match="requires --lexicon"):
        prepare_data.main(["--source", str(tmp_path / "empty"), "--out_dir", str(tmp_path),
                           "--labeler", "lexicon"])
