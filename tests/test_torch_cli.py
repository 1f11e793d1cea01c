"""Port parity: the command-line entry points (``cli/train.py``,
``cli/evaluation.py``, ``cli/export_hf.py``) against the JAX package's
scripts, run in-process on the same synthetic WAV corpus and the same
initial weights (a safetensors file the JAX package writes).

Both packages' ``get_config`` are replaced by a narrow config with the real
audio window (the dataset's mel is 3000 frames) and the kernel switches the
command line asks for, and both run on one device (``--model_parallelism
0``; the port with ``--device cpu``). The compare: the same
``TrainingConfig`` fields and ``get_config`` arguments for each command
line, equal ``test_results.json``, ``bias_wer_results.json`` and
``refs_and_pred.txt``, losses at rel 1e-5, byte-equal exported files, the
offline Hub cases of ``--best_checkpoint``, ``cli/medusa.py`` against
``scripts/medusa.py`` (flags, the ``MedusaConfig`` a command line gives, and
the heads it writes reaching ``evaluate_wer`` through ``cli/evaluation.py
--medusa`` as the JAX script's do), the three inspection harnesses
(``cli/check_weightce.py``, ``cli/check_data_collator.py``,
``cli/check_data_loader.py``) printing the JAX scripts' tables on the same
inputs, every flag once refused as not ported taken (the run goes on to
read the missing data), and the JAX scripts' ``ValueError`` for a
``--model_parallelism`` the world does not divide."""

import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import sys
import wave

import numpy as np
import pytest

import whisper_context_biasing_tpu.models as jax_models
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import save_safetensors as jax_save_safetensors
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.cli import evaluation, export_hf, train
from whisper_context_biasing_tpu_torch.cli import medusa as medusa_cli
from whisper_context_biasing_tpu_torch.models import tiny_test_config
from whisper_context_biasing_tpu_torch.utils import hub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# narrow, with the real audio window: PromptWhisperDataset's mel is 3000 frames
NARROW = dict(n_audio_ctx=1500, d_model=16, n_heads=2, n_audio_layers=1, n_text_layers=1)
ROWS = {"train": 4, "dev": 2, "test": 2}
WORDS = ["aspirin", "metformin", "lisinopril"]


@functools.cache
def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"wcb_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return jax_script(name).main()


def narrow_config(tiny, calls=None):
    """A ``get_config`` stand-in: records its arguments, returns the narrow
    config with them applied."""
    def get_config(name, **kw):
        if calls is not None:
            calls.append((name, kw))
        return tiny(**NARROW, **kw)
    return get_config


def patch_narrow(monkeypatch):
    """Both packages' CLIs build the narrow config; returns the call logs."""
    calls = {"port": [], "jax": []}
    for mod in (train, evaluation, export_hf, medusa_cli):
        monkeypatch.setattr(mod, "get_config", narrow_config(tiny_test_config, calls["port"]))
    for name in ("train", "evaluation", "medusa"):
        monkeypatch.setattr(jax_script(name), "get_config",
                            narrow_config(jax_tiny, calls["jax"]))
    # scripts/export_hf.py imports it inside main()
    monkeypatch.setattr(jax_models, "get_config", narrow_config(jax_tiny, calls["jax"]))
    return calls


@pytest.fixture
def narrow(monkeypatch):
    return patch_narrow(monkeypatch)


def write_corpus(root):
    """jsonl rows with descriptions and bias words, and 1-2 s WAV clips."""
    rng = np.random.default_rng(0)
    (root / "jsonl").mkdir(parents=True)
    for phase, n in ROWS.items():
        (root / "audio" / phase).mkdir(parents=True)
        with open(root / "jsonl" / f"{phase}.jsonl", "w") as f:
            for i in range(n):
                words = WORDS[i % 3: i % 3 + 1 + i % 2]
                f.write(json.dumps({"id": str(i), "file": f"{phase}{i}.wav",
                                    "text": f"Patient {i} takes {' and '.join(words)}.",
                                    "description": "medication review",
                                    "bias_words": words}) + "\n")
                pcm = (rng.standard_normal(16000 + 8000 * i) * 3000).astype("<i2")
                with wave.open(str(root / "audio" / phase / f"{phase}{i}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(root)
    init = root / "init"
    jcfg = jax_tiny(**NARROW)
    jax_save_safetensors(jax_init(jcfg, 0), jcfg, str(init))
    return root, str(init / "model.safetensors")


def data_args(root):
    return ["--data_root", str(root), "--data_dir", "audio",
            "--jsonl_data", str(root / "jsonl")]


def train_args(root, init, out):
    return [*data_args(root), "--output", str(out), "--init_checkpoint", init,
            "--prompt", "--bias_list", "--batch", "2", "--grad_accum", "1", "--epoch", "1",
            "--eval_steps", "2", "--save_steps", "2", "--logging_steps", "1",
            "--eval_batch", "2", "--model_parallelism", "0"]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The train CLI of each package on the corpus, from the same file."""
    root, init = corpus
    mp = pytest.MonkeyPatch()
    try:
        calls = patch_narrow(mp)
        out = {k: tmp_path_factory.mktemp(k) for k in ("port", "jax")}
        train.main(train_args(root, init, out["port"]) + ["--device", "cpu"])
        run_jax(mp, "train", train_args(root, init, out["jax"]))
    finally:
        mp.undo()
    return dict(root=root, init=init, calls=calls, **out)


def read(path):
    with open(path) as f:
        return f.read()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def test_train_cli_results_match_jax(runs):
    for name in ("test_results.json", "bias_wer_results.json", "refs_and_pred.txt"):
        got, want = read(runs["port"] / name), read(runs["jax"] / name)
        assert got == want, name
    assert json.loads(read(runs["port"] / "test_results.json")).keys() == {"wer"}
    assert len(read(runs["port"] / "refs_and_pred.txt").split("Ref :")) == ROWS["test"] + 1


def test_train_cli_losses_match_jax(runs):
    hist = [json.loads(read(runs[k] / "checkpoint-2" / "trainer_state.json"))["log_history"]
            for k in ("port", "jax")]
    assert [sorted(e) for e in hist[0]] == [sorted(e) for e in hist[1]]
    assert [e["step"] for e in hist[0]] == [1, 2, 2]
    for got, want in zip(*hist):
        if "loss" in want:
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        else:
            assert got["eval_wer"] == want["eval_wer"]
    assert runs["calls"]["port"] == runs["calls"]["jax"]


# command lines -> (TrainingConfig, get_config arguments), both packages
ARGVS = {
    "defaults": [],
    "reference_flags": ["--bias_weight", "2.5", "--batch", "4", "--epoch", "2.5", "--lr", "3e-5",
                        "--bias_nums", "3", "--bias_desc", "--random", "--eval_steps", "7",
                        "--save_steps", "9", "--logging_steps", "3", "--eval_batch", "5",
                        "--grad_accum", "2", "--seed", "7"],
    "kernels": ["--flash_attention", "--fused_ln", "--remat", "none", "--freeze_encoder",
                "--prompt_generation", "--bias_boost", "1.5", "--lora_alpha", "8"],
    "hub": ["--hub_model_id", "org/model", "--hf_token", "tkn", "--speed_perturb", "0.9",
            "1.1"],
}


class Captured(Exception):
    pass


@pytest.mark.parametrize("case", list(ARGVS))
def test_train_argv_maps_like_jax(case, corpus, narrow, monkeypatch, tmp_path):
    root, _ = corpus
    argv = [*data_args(root), "--output", str(tmp_path), "--model_parallelism", "0",
            *ARGVS[case]]
    got = {}

    def capture(side):
        def train_and_evaluate(model_cfg, params, tokenizer, dtrain, deval, coll, tcfg, **kw):
            got[side] = (dataclasses.asdict(tcfg), model_cfg, kw.get("resume"))
            raise Captured
        return train_and_evaluate

    monkeypatch.setattr(train, "train_and_evaluate", capture("port"))
    monkeypatch.setattr(jax_script("train"), "train_and_evaluate", capture("jax"))
    with pytest.raises(Captured):
        train.main(argv + ["--device", "cpu"])
    with pytest.raises(Captured):
        run_jax(monkeypatch, "train", argv)
    (tcfg, cfg, resume), (jtcfg, jcfg, jresume) = got["port"], got["jax"]
    assert tcfg == {k: v for k, v in jtcfg.items() if k in tcfg}
    assert resume == jresume
    assert narrow["port"] == narrow["jax"]
    for field in ("flash_attention", "fused_ln_qkv", "fused_ln_mlp", "remat", "d_model"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_parse_args_defaults_match_jax(monkeypatch):
    for name, mod in (("train", train), ("evaluation", evaluation)):
        monkeypatch.setattr(sys, "argv", [f"{name}.py"])
        want = vars(jax_script(name).parse_args())
        got = vars(mod.parse_args([]))
        assert got.pop("device") == "cuda"
        assert got == want, name


# ---------------------------------------------------------------------------
# evaluation and export
# ---------------------------------------------------------------------------

def eval_args(runs, out, *mode):
    return [*data_args(runs["root"]), "--output", str(out), "--batch", "2",
            "--model_parallelism", "0", *mode]


def test_evaluation_final_model_matches_jax(runs, narrow, monkeypatch, tmp_path):
    mode = ("--final_model", "--model_path", runs["init"], "--prompt")
    evaluation.main(eval_args(runs, tmp_path / "port", *mode) + ["--device", "cpu"])
    run_jax(monkeypatch, "evaluation", eval_args(runs, tmp_path / "jax", *mode))
    for name in ("refs_and_pred.txt", "refs_and_pred_test_results.json",
                 "refs_and_pred_bias_wer_results.json"):
        assert read(tmp_path / "port" / name) == read(tmp_path / "jax" / name), name
    assert narrow["port"] == narrow["jax"] == [("base.en", {})]


def test_evaluation_best_checkpoint_matches_jax(runs, narrow, monkeypatch, tmp_path):
    for side in ("port", "jax"):
        shutil.copytree(runs["port"] / "checkpoint-2", tmp_path / side / "checkpoint-2")
    evaluation.main(eval_args(runs, tmp_path / "port", "--best_checkpoint")
                    + ["--device", "cpu"])
    run_jax(monkeypatch, "evaluation", eval_args(runs, tmp_path / "jax", "--best_checkpoint"))
    for name in ("refs_and_pred.txt", "refs_and_pred_test_results.json",
                 "refs_and_pred_bias_wer_results.json"):
        assert read(tmp_path / "port" / name) == read(tmp_path / "jax" / name), name


def test_export_hf_file_equals_jax(runs, narrow, monkeypatch, tmp_path):
    ckpt = str(runs["port"] / "checkpoint-2")
    export_hf.main(["--checkpoint", ckpt, "--out", str(tmp_path / "port")])
    run_jax(monkeypatch, "export_hf", ["--checkpoint", ckpt, "--out", str(tmp_path / "jax")])
    got = (tmp_path / "port" / "model.safetensors").read_bytes()
    assert got == (tmp_path / "jax" / "model.safetensors").read_bytes()
    # an HF file goes round with the dims it carries
    export_hf.main(["--checkpoint", str(tmp_path / "port"),
                    "--out", str(tmp_path / "again.safetensors")])
    assert (tmp_path / "again.safetensors").read_bytes() == got


def _fake_ckpt(root, step, wer):
    d = os.path.join(root, f"checkpoint-{step}")
    os.makedirs(d)
    with open(os.path.join(d, "trainer_state.json"), "w") as f:
        json.dump({"eval_wer": wer, "eval_step": step,
                   "log_history": [{"step": step, "eval_wer": wer}]}, f)
    np.savez(os.path.join(d, "params.npz"))
    return d


def test_best_checkpoint_hub_sync_populates_then_scans(tmp_path, monkeypatch):
    """tests/test_train.py TestEvalCliHubBestCheckpoint: with a Hub id the
    whole repo is synced into --output before the local scan."""
    hub_repo = tmp_path / "hub_repo"
    best = _fake_ckpt(str(hub_repo), 4, 10.0)
    _fake_ckpt(str(hub_repo), 2, 50.0)
    calls = {}

    def fake_sync(repo_id, local_dir, token=None):
        calls["repo_id"], calls["token"] = repo_id, token
        for name in os.listdir(hub_repo):
            shutil.copytree(hub_repo / name, os.path.join(local_dir, name))
        return True

    monkeypatch.setattr(hub, "sync_from_hub", fake_sync)
    out = str(tmp_path / "out")
    os.makedirs(out)
    found = evaluation.locate_best_checkpoint(out, "user/model", "tkn")
    assert calls == {"repo_id": "user/model", "token": "tkn"}
    assert os.path.basename(found) == os.path.basename(best) and found.startswith(out)


def test_best_checkpoint_offline_degrades_to_local_scan(tmp_path, monkeypatch):
    local = _fake_ckpt(str(tmp_path), 6, 20.0)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # not installed
    assert evaluation.locate_best_checkpoint(str(tmp_path), "user/model", None) == local


def test_best_checkpoint_without_hub_id_never_touches_hub(tmp_path, monkeypatch):
    def boom(*a, **k):  # pragma: no cover
        raise AssertionError("sync_from_hub must not be called")

    monkeypatch.setattr(hub, "sync_from_hub", boom)
    local = _fake_ckpt(str(tmp_path), 8, 30.0)
    assert evaluation.locate_best_checkpoint(str(tmp_path), None, None) == local


# ---------------------------------------------------------------------------
# flags not ported, and the device
# ---------------------------------------------------------------------------

UNPORTED = {
    # ported since: accepted, and the run goes on to read the missing data
    "train_lora_rank": (train, ["--lora_rank", "4"], None),
    "train_spec_augment": (train, ["--spec_augment"], None),
    # ported since: a tensor-parallel degree the world (one process here)
    # does not divide raises the JAX scripts' ValueError (parallel.auto_mesh)
    "train_model_parallelism": (train, ["--model_parallelism", "2"], ValueError),
    # ported since: the sharded checkpoint backend (torch.distributed.checkpoint)
    "train_orbax": (train, ["--checkpoint_backend", "orbax"], None),
    "train_remat_dots": (train, ["--remat", "dots"], None),
    "train_remat_wide": (train, ["--remat", "wide"], None),
    "eval_num_beams": (evaluation, ["--num_beams", "4", "--medusa", "medusa.npz"], None),
    "eval_medusa": (evaluation, ["--medusa", "medusa.npz"], None),
    "eval_model_parallelism": (evaluation, ["--model_parallelism", "4"], ValueError),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_raise_before_reading_data(case, tmp_path):
    mod, argv, item = UNPORTED[case]
    if item is None:
        with pytest.raises(FileNotFoundError, match="none"):
            mod.main(["--jsonl_data", str(tmp_path / "none"), "--output", str(tmp_path),
                      "--device", "cpu", *argv])
        return
    import jax

    from whisper_context_biasing_tpu.parallel import auto_mesh as jax_auto_mesh

    with pytest.raises(ValueError) as ref:
        jax_auto_mesh(int(argv[1]), devices=jax.devices("cpu")[:1])
    with pytest.raises(ValueError) as got:
        mod.main(["--jsonl_data", str(tmp_path / "none"), "--output", str(tmp_path),
                  "--device", "cpu", *argv])
    assert str(got.value) == str(ref.value) == \
        f"1 devices not divisible by model_parallelism={argv[1]}"


@pytest.mark.parametrize("mod", [train, evaluation], ids=["train", "evaluation"])
def test_clis_default_to_the_card(mod, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--jsonl_data", str(tmp_path), "--output", str(tmp_path)])


# ---------------------------------------------------------------------------
# Medusa heads: cli/medusa.py, and evaluation --medusa
# ---------------------------------------------------------------------------

def medusa_args(root, init, out, *extra):
    return [*data_args(root), "--output", str(out), "--init_checkpoint", init, "--prompt",
            "--medusa_heads", "2", "--batch", "2", "--epoch", "1", "--warmup_steps", "0",
            "--eval_steps", "1", "--logging_steps", "1", "--eval_batches", "1", *extra]


def test_medusa_parse_args_and_config_match_jax(corpus, narrow, monkeypatch, tmp_path):
    """The flag defaults, and the ``MedusaConfig`` and model a command line
    gives the runner, are the JAX script's (the port's init draws other
    numbers: the head shapes are compared)."""
    monkeypatch.setattr(sys, "argv", ["medusa.py"])
    want = vars(jax_script("medusa").parse_args())
    got = vars(medusa_cli.parse_args([]))
    assert got.pop("device") == "cuda" and got == want
    root, init = corpus
    argv = medusa_args(root, init, tmp_path, "--medusa_chains", "3", "--lr", "5e-3", "--seed",
                       "7")
    seen = {}

    def capture(side):
        def train_medusa_heads(cfg, base, heads, dtrain, deval, coll, mcfg):
            seen[side] = (dataclasses.asdict(mcfg), cfg.d_model, tuple(heads["w"].shape),
                          len(dtrain), len(deval))
            raise Captured
        return train_medusa_heads

    monkeypatch.setattr(medusa_cli, "train_medusa_heads", capture("port"))
    monkeypatch.setattr(jax_script("medusa"), "train_medusa_heads", capture("jax"))
    with pytest.raises(Captured):
        medusa_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(Captured):
        run_jax(monkeypatch, "medusa", argv)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0]["n_chains"] == 3 and seen["port"][2] == (2, 16, 16)


def test_medusa_cli_heads_reach_evaluation_like_jax(runs, narrow, monkeypatch, tmp_path):
    """cli.medusa trains heads on the corpus (medusa.npz, its results and
    log); ``cli.evaluation --medusa --medusa_chains 3`` hands evaluate_wer
    the heads the JAX script hands its own (evaluate_wer(medusa=) itself is
    held to JAX in test_torch_medusa.py)."""
    out = tmp_path / "heads"
    heads, hist = medusa_cli.main(medusa_args(runs["root"], runs["init"], out, "--medusa_chains",
                                              "2", "--device", "cpu"))
    summary = json.loads(read(out / "medusa_results.json"))
    assert summary["n_heads"] == 2 and hist[-1] == summary
    assert (out / "medusa_log.jsonl").is_file()
    seen = {}

    def capture(side):
        def evaluate_wer(*a, medusa=None, **kw):
            seen[side] = {k: np.asarray(v) for k, v in medusa.items()}
            raise Captured
        return evaluate_wer

    monkeypatch.setattr(evaluation, "evaluate_wer", capture("port"))
    monkeypatch.setattr(jax_script("evaluation"), "evaluate_wer", capture("jax"))
    mode = ("--final_model", "--model_path", runs["init"], "--medusa",
            str(out / "medusa.npz"), "--medusa_chains", "3")
    with pytest.raises(Captured):
        evaluation.main(eval_args(runs, tmp_path / "port", *mode) + ["--device", "cpu"])
    with pytest.raises(Captured):
        run_jax(monkeypatch, "evaluation", eval_args(runs, tmp_path / "jax", *mode))
    assert seen["port"].keys() == seen["jax"].keys() == {"w", "b", "n_chains"}
    for k in ("w", "b", "n_chains"):
        np.testing.assert_array_equal(seen["port"][k], seen["jax"][k])
    assert int(seen["port"]["n_chains"]) == 3
    np.testing.assert_array_equal(seen["port"]["w"], heads["w"].numpy())


# ---------------------------------------------------------------------------
# the inspection harnesses
# ---------------------------------------------------------------------------

def _printed(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


def test_check_weightce_rows_match_jax(capsys, monkeypatch):
    """The same per-position table (token, decoded, weight, match) as
    scripts/check_WeightCE.py, the same weights, and the loss within 1e-5."""
    from whisper_context_biasing_tpu_torch.cli import check_weightce

    monkeypatch.setattr(sys, "argv", ["check_WeightCE.py"])
    want = _printed(capsys, jax_script("check_WeightCE").main)
    got = _printed(capsys, lambda: check_weightce.main([]))
    assert got[1:] == want[1:]
    assert len(got) > 70 and got[-1].startswith("OK:")
    loss = [float(lines[0].split(":")[1]) for lines in (got, want)]
    assert loss[0] == pytest.approx(loss[1], rel=1e-5)


@pytest.mark.parametrize("flags", [[], ["--prompt", "--bias_list", "--bias_nums", "2"]],
                         ids=["plain", "prompted"])
def test_check_data_collator_rows_match_jax(corpus, capsys, monkeypatch, flags):
    from whisper_context_biasing_tpu_torch.cli import check_data_collator

    root, _ = corpus
    argv = [*data_args(root), "--phase", "train", "--batch", "3", *flags]
    monkeypatch.setattr(sys, "argv", ["check_data_collator.py", *argv])
    want = _printed(capsys, jax_script("check_data_collator").main)
    got = _printed(capsys, lambda: check_data_collator.main(argv))
    assert got == want
    assert got[-1].startswith("OK:") and sum(line.startswith("=== Sample") for line in got) == 3


@pytest.mark.parametrize("flags", [
    ["--prompt", "--bias_list", "--bias_nums", "2"],
    ["--bias_list", "--bias_nums", "3", "--no-random"],
    ["--prompt", "--bias_desc", "--bias_list", "--bias_nums", "1"],
], ids=["prompt_bias", "bias_only", "desc"])
def test_check_data_loader_rows_match_jax(corpus, capsys, monkeypatch, flags):
    from whisper_context_biasing_tpu_torch.cli import check_data_loader

    root, _ = corpus
    argv = [*data_args(root), "--phase", "train", "--samples", "4", *flags]
    monkeypatch.setattr(sys, "argv", ["check_data_loader.py", *argv])
    want = _printed(capsys, jax_script("check_data_loader").main)
    got = _printed(capsys, lambda: check_data_loader.main(argv))
    assert got == want
    assert got[-1].startswith("OK:") and sum(line.startswith("=== Sample") for line in got) == 4
