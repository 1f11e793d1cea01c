"""Ground rules of the port: it imports neither JAX nor the JAX package
(chip_smoke.py neither), it exports the JAX package's public names from the
same places, its entry points default to the card and refuse to run without
one, options not ported yet raise (and misused ones raise as in JAX), and
its kernel wrappers take the plain version only for CPU tensors."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed

import whisper_context_biasing_tpu_torch as port
from whisper_context_biasing_tpu_torch import Pipeline, ops
from whisper_context_biasing_tpu_torch.data import prefetch_to_device
from whisper_context_biasing_tpu_torch.decode import greedy_decode
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    get_config,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.ops import _build, fused_block

PKG = pathlib.Path(port.__file__).parent


def test_port_imports_no_jax():
    mods = sorted("whisper_context_biasing_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'whisper_context_biasing_tpu']\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15
    new = {f"whisper_context_biasing_tpu_torch.{m}" for m in (
        "train.augment", "train.lora", "train.distill", "cli.distill", "cli.acceptance",
        "cli.check_weightce", "cli.check_data_collator", "cli.check_data_loader")}
    assert new <= set(mods)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports neither JAX nor the JAX package, at its top or
    inside a function."""
    import ast

    tree = ast.parse((PKG.parent / "chip_smoke.py").read_text())
    roots = {(a.name if isinstance(n, ast.Import) else n.module or "").split(".")[0]
             for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert not roots & {"jax", "jaxlib", "whisper_context_biasing_tpu"}, roots
    assert "whisper_context_biasing_tpu_torch" in roots


def _jax_all(rel: str) -> list[str]:
    """The names of ``__all__`` in a JAX package file, read as text (no
    import, so no jax)."""
    import ast

    src = (PKG.parent / "whisper_context_biasing_tpu" / rel).read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return list(ast.literal_eval(node.value))
    # the package's __init__ has no __all__: its re-exports are the names
    # its from-imports bind
    return [a.asname or a.name for node in ast.parse(src).body
            if isinstance(node, ast.ImportFrom) and node.level == 1
            for a in node.names]


# init_params: the port's seeded init is init_state_dict (a state dict, not
# a params tree), a documented deviation; setup_jax and effective_platform
# (utils) configure and name JAX's backend: _device.resolve_device is their
# counterpart
_DEVIATIONS = {"init_params", "setup_jax", "effective_platform"}


@pytest.mark.parametrize("sub", ["", "audio", "data", "models", "train", "parallel", "utils"])
def test_public_surface_matches_jax(sub):
    """Every name the JAX package exports from the package, ``audio``,
    ``data``, ``models``, ``train``, ``parallel`` and ``utils`` imports from
    the same place in the port."""
    import importlib

    rel = f"{sub}/__init__.py" if sub else "__init__.py"
    names = set(_jax_all(rel)) - _DEVIATIONS - {"__version__"}
    mod = importlib.import_module("whisper_context_biasing_tpu_torch" + (f".{sub}" if sub
                                                                         else ""))
    missing = sorted(n for n in names if not hasattr(mod, n))
    assert not missing, missing
    assert len(names) >= 5
    if sub == "":  # C.3's example
        from whisper_context_biasing_tpu_torch import (  # noqa: F401
            compute_bias_wer,
            evaluate_wer,
            greedy_decode,
        )


def test_port_imports_no_hf_packages():
    """safetensors, transformers, huggingface_hub and openai are absent on
    the card: no module of the port imports one at import time."""
    mods = sorted("whisper_context_biasing_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('safetensors', 'transformers', 'huggingface_hub', 'openai')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert any(m.endswith(".cli.train") for m in mods)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline("tiny.en")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_test_config())
    model = build_model(tiny_test_config(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_decode(model, np.zeros((1, 80, 128), np.float32), [[50257]], [[True]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([{}])))
    from whisper_context_biasing_tpu_torch.train import TrainingConfig, train_and_evaluate

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_and_evaluate(tiny_test_config(), None, None, [], [], None,
                           TrainingConfig(output_dir="unused"))


@pytest.fixture(scope="module")
def pipe():
    return Pipeline("tiny.en", config=tiny_test_config(), device="cpu")


# beams, timestamps, language/task forcing, long-form (sequential and
# chunked), word timestamps and window_buckets are ported: what still raises
# is a bad option (a non-positive bucket, an unknown VAD option, on either
# long-form route) and language/task forcing on an English-only model
# (ValueError, as in JAX), with or without word timestamps
@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(num_beams=2, word_timestamps=True, language="en"), ValueError, "multilingual"),
    (dict(timestamps=True, long_form="chunked", vad={"bogus": 1.0}), ValueError,
     "unknown vad option"),
    (dict(word_timestamps=True, task="translate"), ValueError, "multilingual"),
    (dict(window_buckets=(0,)), ValueError, "positive seconds"),
    (dict(language="en"), ValueError, "multilingual"),
    (dict(task="translate"), ValueError, "multilingual"),
    (dict(long_form=True, vad={"bogus": 1.0}), ValueError, "unknown vad option"),
    (dict(long_form="chunked", language="fr"), ValueError, "multilingual"),
], ids=[f"kwargs{i}" for i in range(8)])
def test_unported_transcribe_options_raise(pipe, kwargs, exc, match):
    with pytest.raises(exc, match=match):
        pipe.transcribe(np.zeros(1600, np.float32), **kwargs)


def test_unported_paths_raise(pipe, tmp_path):
    from whisper_context_biasing_tpu_torch.decode import transcribe_long_batch

    # long-form word timestamps are ported: they run
    res = pipe.transcribe(np.zeros(pipe.window_samples + 1, np.float32), word_timestamps=True,
                          max_tokens=2, temperatures=(0.0,))
    assert res.words is not None
    # speculative decoding is ported: a draft family builds (random weights
    # warn), here replaced by a narrow draft config
    draft = Pipeline("tiny.en", config=tiny_test_config(), device="cpu", draft_model="tiny.en",
                     draft_config=tiny_test_config(n_text_layers=1))
    assert draft.draft is not None and draft.draft_cfg.n_text_layers == 1
    # checkpoints are ported: a missing file raises as a missing file
    with pytest.raises(FileNotFoundError):
        Pipeline("tiny.en", config=tiny_test_config(), device="cpu",
                 checkpoint="model.safetensors")
    # sampling, no_speech_prob, timestamp rules, long-form word timestamps,
    # draft and Medusa models and a mesh are ported (a draft, heads and a
    # world of one give the plain tokens)
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    clip = [np.zeros(1600, np.float32)]
    kw = dict(max_new=3, temperatures=(0.0,), mel_fn=pipe.mel,
              window_samples=pipe.window_samples, device="cpu")
    plain = transcribe_long_batch(pipe.model, pipe.tokenizer, clip, **kw)
    try:
        assert transcribe_long_batch(pipe.model, pipe.tokenizer, clip,
                                     mesh=_world_of_one(tmp_path), **kw) == plain
    finally:
        torch.distributed.destroy_process_group()
    for accel in (dict(draft=(pipe.model, pipe.cfg, 2)),
                  dict(medusa=init_medusa_params(pipe.cfg, 2))):
        assert transcribe_long_batch(pipe.model, pipe.tokenizer, clip, **accel, **kw) == plain
    # the full-sequence decoder mode is ported: it runs, without a cache
    enc = encode_audio(pipe.model, torch.zeros((1, 80, 128)))
    logits, cache = decode_tokens(pipe.model, torch.zeros((1, 2), dtype=torch.long),
                                  enc_out=enc)
    assert cache is None and logits.shape == (1, 2, pipe.cfg.n_vocab)
    assert torch.isfinite(logits).all()
    # .mp3 is ported: it goes to libmpg123, which cannot open a missing file
    # (or, without the library, the decoder says it is missing)
    with pytest.raises(RuntimeError, match="mpg123"):
        pipe.transcribe("clip.mp3")


def test_wrappers_count_only_kernel_launches():
    ops.reset_launch_counts()
    x = torch.zeros((1, 3200))
    ops.log_mel_spectrogram_fused(x)
    q = torch.zeros((1, 10, 1, 64))
    o, lse = ops.flash_attention_fwd(q, q, q)
    ops.flash_attention_bwd(q, q, q, o, lse, q)
    ops.flash_attention_bwd_plain(q, q, q, o, lse, q, causal=True)
    kq = torch.zeros((2, 1, 128, 64), dtype=torch.int8)
    ks = torch.ones((2, 1, 1, 128))
    ops.quant_cross_attention_step_indexed(torch.zeros((1, 1, 64)), kq, ks, kq, ks, 1, 1)
    x = torch.ones((2, 5, 16), requires_grad=True)
    ops.fused_ln_matmul(x, torch.ones(16), torch.zeros(16), torch.ones((16, 24)),
                        act="gelu").sum().backward()
    ops.fused_ln_matmul_plain(x, torch.ones(16), torch.zeros(16), torch.ones((16, 24)))
    assert sum(ops.launches.values()) == 0


@pytest.mark.parametrize("field", ["fused_ln_qkv", "fused_ln_mlp"])
def test_fused_layernorm_switches_raise(field, monkeypatch):
    """The switches raise nothing: they are accepted, and on CPU tensors the
    model reaches the fused kernel's plain version (once per encoder block
    under each switch), launching nothing."""
    assert getattr(get_config("base.en", **{field: True}), field)
    calls = []
    plain = fused_block.fused_ln_matmul_plain
    monkeypatch.setattr(fused_block, "fused_ln_matmul_plain",
                        lambda *a, **kw: calls.append(kw.get("act", a[5] if len(a) > 5 else None))
                        or plain(*a, **kw))
    cfg = tiny_test_config(**{field: True})
    ops.reset_launch_counts()
    with torch.no_grad():
        encode_audio(build_model(cfg, device="cpu"), torch.zeros((1, 80, 128)))
    assert not ops.launches
    want = None if field == "fused_ln_qkv" else "gelu"
    assert calls == [want] * cfg.n_audio_layers


def _tiny_loop_args(tmp_path, **over):
    from whisper_context_biasing_tpu_torch.data import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
    from whisper_context_biasing_tpu_torch.train import TrainingConfig

    tok = load_tokenizer()
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot)
    return (tiny_test_config(), None, tok, [], [], coll,
            TrainingConfig(output_dir=str(tmp_path), **over))


def _evaluate(tmp_path, **kw):
    from whisper_context_biasing_tpu_torch.train import evaluate_wer

    _, _, tok, _, _, coll, _ = _tiny_loop_args(tmp_path)
    evaluate_wer(build_model(tiny_test_config(), device="cpu"), tok, [], coll, 1, 4, **kw)


def _heads():
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    return init_medusa_params(tiny_test_config(), 2)


def _train(tmp_path, **over):
    from whisper_context_biasing_tpu_torch.train import train_and_evaluate

    train_and_evaluate(*_tiny_loop_args(tmp_path, **over), device="cpu")


def _mp3_item(tmp_path):
    from whisper_context_biasing_tpu_torch.data import PromptWhisperDataset
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    (tmp_path / "train.jsonl").write_text('{"file": "a.mp3", "text": "x"}\n')
    PromptWhisperDataset(str(tmp_path), str(tmp_path), "train", tokenizer=load_tokenizer())[0]


def _save_orbax(tmp_path):
    from whisper_context_biasing_tpu_torch.train import save_checkpoint

    save_checkpoint(str(tmp_path), 1, build_model(tiny_test_config(), device="cpu"),
                    backend="orbax")


def _world_of_one(tmp_path):
    """A (1, 1) mesh over a gloo group of this process alone (destroyed by
    the test)."""
    import torch.distributed as dist

    from whisper_context_biasing_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    return make_mesh(1)


@pytest.mark.parametrize("call,item", [
    # ported since: evaluations take a mesh
    (lambda p: _evaluate(p, num_beams=2, mesh=_world_of_one(p)), None),
    (lambda p: _evaluate(p, medusa=_heads()), None),
    (lambda p: _evaluate(p, mesh=_world_of_one(p)), None),
    (lambda p: _train(p, lora_rank=4), None),
    (lambda p: _train(p, spec_augment=True), None),
    (lambda p: _train(p, checkpoint_backend="orbax"), "A.9"),
    (_save_orbax, "A.9"),
], ids=["num_beams", "medusa", "mesh", "lora_rank", "spec_augment",
        "orbax_loop", "orbax_save"])
def test_unported_loop_options_raise(tmp_path, call, item):
    import torch.distributed as dist

    if item is None:  # ported since: the call runs
        try:
            call(tmp_path)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue {item}"):
        call(tmp_path)


def test_hub_model_id_degrades_offline(tmp_path, monkeypatch, capsys):
    """The Hub options are ported: offline a resume's snapshot sync prints
    a warning and the run goes on from the seeded init."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # not installed
    from whisper_context_biasing_tpu_torch.train import train_and_evaluate

    train_and_evaluate(*_tiny_loop_args(tmp_path, hub_model_id="org/model"), resume=True,
                       device="cpu")
    assert "[hub] sync_from_hub skipped" in capsys.readouterr().out


def test_mp3_dataset_item_goes_to_libmpg123(tmp_path):
    with pytest.raises(RuntimeError, match="mpg123"):
        _mp3_item(tmp_path)


def test_kernel_sources_and_build_flags():
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.KERNELS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir() == _build.build_dir()  # keyed by source hash
    assert _build.BUILD_ROOT.name == ".torch_ext_build"
