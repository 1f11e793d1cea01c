"""Port parity: checkpoints and the fine-tuning loop vs the JAX package.

The npz checkpoint round trip, retention and best-checkpoint selection (the
cases of ``tests/test_train.py``); checkpoints written by either package
loading in the other with equal params and Adam moments; resume continuing
exactly where a run stopped; and ``train_and_evaluate`` run by both packages
from the same converted weights with the fused LayerNorm+matmul switches on
(JAX runs its Pallas kernel in interpret mode, the port its plain version on
CPU tensors): the same logged losses, ``eval_wer`` values, eval stamps and
``refs_and_pred.txt``."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import TrainingConfig as JaxTrainingConfig
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import train_and_evaluate as jax_train_and_evaluate
from whisper_context_biasing_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from whisper_context_biasing_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.metrics import parse_refs_and_pred_file
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    init_state_dict,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import (
    TrainingConfig,
    find_best_checkpoint,
    init_train_state,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
    train_and_evaluate,
)
from whisper_context_biasing_tpu_torch.train.checkpoint import checkpoint_step, is_native_checkpoint

SMALL = dict(n_audio_layers=1, n_text_layers=1, d_model=8, n_heads=1)


def _model(cfg, seed=0):
    return build_model(cfg, seed=seed, device="cpu", train=True)


def _stepped(model, seed=1):
    """An optimizer state after one update on seeded gradients."""
    opt = make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=100)
    state = init_train_state(model, opt)
    g = torch.Generator().manual_seed(seed)
    params = list(model.parameters())
    grads = [torch.randn(p.shape, generator=g) * 0.01 for p in params]
    opt.update_(params, grads, state.opt_state)
    return state.opt_state


def _same_state_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


# ---------------------------------------------------------------------------
# the port's own checkpoints (tests/test_train.py's cases)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    cfg = tiny_test_config()
    model = _model(cfg)
    opt_state = _stepped(model)
    p = save_checkpoint(str(tmp_path), 10, model, opt_state, metadata={"eval_wer": 12.5})
    sd, restored, meta = load_checkpoint(p, cfg, load_opt_state=True)
    assert meta["step"] == 10 and meta["eval_wer"] == 12.5
    _same_state_dicts(sd, {n: t.detach() for n, t in model.named_parameters()})
    assert restored.count == opt_state.count == 1
    for a, b in zip(restored.mu + restored.nu, opt_state.mu + opt_state.nu):
        assert torch.equal(a, b)
    _, none, _ = load_checkpoint(p, cfg)
    assert none is None


def test_retention_keeps_best_and_latest(tmp_path):
    cfg = tiny_test_config(**SMALL)
    model = _model(cfg)
    for step, wer in ((1, 5.0), (2, 9.0), (3, 8.0)):
        save_checkpoint(str(tmp_path), step, model, metadata={"eval_wer": wer}, keep=1)
    names = sorted(os.path.basename(c) for c in list_checkpoints(str(tmp_path)))
    # best (step 1, wer 5.0) + latest (step 3) survive
    assert names == ["checkpoint-1", "checkpoint-3"]
    assert os.path.basename(find_best_checkpoint(str(tmp_path))) == "checkpoint-1"
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == "checkpoint-3"


def test_log_history_format(tmp_path):
    model = _model(tiny_test_config(**SMALL))
    save_checkpoint(str(tmp_path), 5, model,
                    metadata={"log_history": [{"eval_wer": 3.3}, {"loss": 1.0}]})
    assert os.path.basename(find_best_checkpoint(str(tmp_path))) == "checkpoint-5"


# trainer_state.json files -> the checkpoint find_best_checkpoint must pick
# (tests/test_train.py TestBestCheckpointSelection)
_HIST = [{"step": 135, "eval_wer": 10.0}, {"step": 270, "eval_wer": 12.0}]
BEST_CASES = {
    # later checkpoints carry the full log_history; its best must not be
    # attributed to them
    "own_metric_beats_poisoned_history": (
        {135: {"step": 135, "eval_wer": 10.0, "log_history": _HIST[:1]},
         270: {"step": 270, "eval_wer": 12.0, "log_history": _HIST}}, 135),
    # a stamp measured at an earlier step loses to a same-step eval
    "stale_stamp_loses_to_same_step_eval": (
        {100: {"step": 100, "log_history": []},
         200: {"step": 200, "eval_wer": 10.0, "eval_step": 135,
               "log_history": [{"step": 135, "eval_wer": 10.0}]},
         270: {"step": 270, "eval_wer": 12.0, "eval_step": 270, "log_history": _HIST}}, 270),
    # a legacy stamp (no eval_step) that the history proves is its own
    "legacy_stamp_with_matching_history": (
        {135: {"step": 135, "eval_wer": 8.0, "log_history": [{"step": 135, "eval_wer": 8.0}]},
         270: {"step": 270, "eval_wer": 12.0, "eval_step": 270,
               "log_history": [{"step": 135, "eval_wer": 8.0},
                               {"step": 270, "eval_wer": 12.0}]}}, 135),
    # no same-step eval anywhere: the lowest known value
    "stale_stamps_only": (
        {200: {"step": 200, "eval_wer": 10.0, "eval_step": 135},
         300: {"step": 300, "eval_wer": 12.0, "eval_step": 270}}, 200),
    # HF-style: no top-level stamp, the log history decides
    "history_fallback": ({10: {"log_history": [{"eval_wer": 42.0}]}}, 10),
}


@pytest.mark.parametrize("case", list(BEST_CASES))
def test_best_checkpoint_selection(tmp_path, case):
    metas, want = BEST_CASES[case]
    for step, meta in metas.items():
        d = tmp_path / f"checkpoint-{step}"
        d.mkdir()
        (d / "trainer_state.json").write_text(json.dumps(meta))
    assert os.path.basename(find_best_checkpoint(str(tmp_path))) == f"checkpoint-{want}"


def test_orbax_backend_raises(tmp_path):
    """The sharded backend in one process (no process group): the DCP dirs
    round-trip the weights and moments bit-equal, as the npz path does;
    retention and the metadata are the npz path's. A JAX Orbax dir is
    recognised and refused with a ValueError naming the npz backend."""
    cfg = tiny_test_config(**SMALL)
    model = _model(cfg)
    opt_state = _stepped(model)
    for step in (1, 2):
        p = save_checkpoint(str(tmp_path), step, model, opt_state,
                            metadata={"eval_wer": 10.0 - step, "eval_step": step},
                            backend="orbax")
    assert [os.path.basename(c) for c in list_checkpoints(str(tmp_path))] == ["checkpoint-2"]
    assert sorted(os.listdir(p)) == ["opt_dcp", "params_dcp", "trainer_state.json"]
    assert os.path.isfile(os.path.join(p, "params_dcp", ".metadata"))
    assert os.path.isfile(os.path.join(p, "params_dcp", "__0_0.distcp"))
    sd, restored, meta = load_checkpoint(p, cfg, load_opt_state=True)
    assert meta["step"] == 2 and meta["eval_wer"] == 8.0
    npz = save_checkpoint(str(tmp_path / "npz"), 2, model, opt_state)
    want, want_opt, _ = load_checkpoint(npz, cfg, load_opt_state=True)
    _same_state_dicts(sd, want)
    assert restored.count == want_opt.count == opt_state.count
    for a, b in zip(restored.mu + restored.nu, want_opt.mu + want_opt.nu):
        assert torch.equal(a, b)
    (tmp_path / "checkpoint-3" / "params_ocp").mkdir(parents=True)
    (tmp_path / "checkpoint-3" / "trainer_state.json").write_text('{"step": 3}')
    assert is_native_checkpoint(str(tmp_path / "checkpoint-3"))
    with pytest.raises(ValueError, match="npz backend"):
        load_checkpoint(str(tmp_path / "checkpoint-3"), model.cfg)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg = tiny_test_config(**SMALL)
    params = jax.tree.map(jnp.asarray, state_dict_to_jax(init_state_dict(cfg, 0), cfg))
    opt = jax_make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=100)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) * 0.01,
                         params)
    _, opt_state = opt.update(grads, opt.init(params), params)
    path = jax_save_checkpoint(str(tmp_path), 7, params, opt_state=opt_state,
                               metadata={"eval_wer": 1.0})
    sd, restored, meta = load_checkpoint(path, cfg, load_opt_state=True)
    assert meta == {"step": 7, "eval_wer": 1.0}
    _same_state_dicts(sd, params_from_jax(jax.tree.map(np.asarray, params), cfg))
    model = build_model(cfg, sd, device="cpu", train=True)
    names = [n for n, _ in model.named_parameters()]
    assert restored.count == 1
    adam = opt_state[1][0]  # chain(clip, adamw): adamw's ScaleByAdamState
    for got, want in ((restored.mu, adam.mu), (restored.nu, adam.nu)):
        want = params_from_jax(jax.tree.map(np.asarray, want), cfg)
        _same_state_dicts(dict(zip(names, got)), want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = tiny_test_config(**SMALL)
    model = _model(cfg)
    opt_state = _stepped(model)
    path = save_checkpoint(str(tmp_path), 3, model, opt_state)
    template = jax_make_optimizer().init(state_dict_to_jax(init_state_dict(cfg, 1), cfg))
    params, jopt, meta = jax_load_checkpoint(path, opt_state_template=template)
    assert meta["step"] == 3
    want = state_dict_to_jax(dict(model.named_parameters()), cfg)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    names = [n for n, _ in model.named_parameters()]
    adam = jopt[1][0]
    assert int(adam.count) == int(jopt[1][2].count) == 1
    for got, moments in ((adam.mu, opt_state.mu), (adam.nu, opt_state.nu)):
        want = state_dict_to_jax(dict(zip(names, moments)), cfg)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# train_and_evaluate
# ---------------------------------------------------------------------------

LOOP = dict(n_audio_layers=1, n_text_layers=1, d_model=16, n_heads=2,
            fused_ln_qkv=True, fused_ln_mlp=True)


def _items(tok):
    """tests/test_train.py's loop items: seeded mel, a short label, no spans."""
    rng = np.random.default_rng(0)
    return [{"input_features": (rng.standard_normal((80, 128)) * 0.3).astype(np.float32),
             "labels": np.asarray([tok.sot, 5, 6, tok.eot], np.int32),
             "bias_spans": []} for _ in range(4)]


def _tcfg(cls, out, **over):
    """tests/test_train.py's loop config: 3 epochs of 2 steps, eval every 3
    steps, save every 2 (so the eval stamps are stale at step 4)."""
    kw = dict(output_dir=str(out), per_device_train_batch_size=2,
              per_device_eval_batch_size=2, gradient_accumulation_steps=1,
              num_train_epochs=3, eval_steps=3, save_steps=2, logging_steps=1,
              warmup_steps=0, generation_max_length=4, early_stopping_patience=50,
              load_best_model_at_end=False, save_total_limit=10, dataloader_num_workers=2)
    kw.update(over)
    return cls(**kw)


def _metas(out):
    metas = {}
    for c in list_checkpoints(str(out)):
        with open(os.path.join(c, "trainer_state.json")) as f:
            metas[checkpoint_step(c)] = json.load(f)
    return metas


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """The same fine-tune run by both packages from the JAX init."""
    tok = load_tokenizer()
    # numpy leaves: the JAX step donates its device buffers
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(**LOOP), 0))
    items = _items(tok)
    jout, pout = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jcoll = JaxCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                        decoder_prev_token_id=tok.sop)
    _, jhist = jax_train_and_evaluate(jax_tiny(flash_interpret=True, **LOOP), params, tok,
                                      items, items, jcoll, _tcfg(JaxTrainingConfig, jout))
    cfg = tiny_test_config(**LOOP)
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop)
    ops.reset_launch_counts()
    model, hist = train_and_evaluate(cfg, params_from_jax(params, cfg),
                                     tok, items, items, coll, _tcfg(TrainingConfig, pout),
                                     device="cpu")
    assert not ops.launches  # CPU tensors: the plain versions throughout
    return dict(tok=tok, items=items, cfg=cfg, coll=coll, jout=jout, pout=pout,
                jhist=jhist, hist=hist, model=model)


def test_loop_log_history_matches_jax(loop_runs):
    jhist, hist = loop_runs["jhist"], loop_runs["hist"]
    assert [sorted(e) for e in hist] == [sorted(e) for e in jhist]
    assert [e["step"] for e in hist] == [e["step"] for e in jhist] == [1, 2, 3, 3, 4, 5, 6, 6]
    for got, want in zip(hist, jhist):
        if "loss" in want:
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert got["epoch"] == want["epoch"]
        else:
            assert got["eval_wer"] == want["eval_wer"]


def test_loop_refs_and_pred_match_jax(loop_runs):
    files = [(loop_runs[k] / "refs_and_pred.txt").read_text() for k in ("jout", "pout")]
    assert files[0] == files[1]
    refs, _ = parse_refs_and_pred_file(str(loop_runs["pout"] / "refs_and_pred.txt"))
    assert len(refs) == len(loop_runs["items"])


def test_loop_stamps_eval_step_as_jax(loop_runs):
    jmetas, metas = _metas(loop_runs["jout"]), _metas(loop_runs["pout"])
    assert sorted(metas) == sorted(jmetas) == [2, 4, 6]
    # save at 2 (no eval yet), 4 (stale: eval_step 3), 6 (same-step)
    assert "eval_wer" not in metas[2]
    assert metas[4]["eval_step"] == jmetas[4]["eval_step"] == 3
    assert metas[6]["eval_step"] == jmetas[6]["eval_step"] == 6
    assert metas[6]["eval_wer"] == jmetas[6]["eval_wer"]
    # the final checkpoint holds the returned model, in both packages' layout
    sd, _, _ = load_checkpoint(str(loop_runs["pout"] / "checkpoint-6"), loop_runs["cfg"])
    _same_state_dicts(sd, {n: p.detach() for n, p in loop_runs["model"].named_parameters()})
    jparams, _, _ = jax_load_checkpoint(str(loop_runs["jout"] / "checkpoint-6"))
    got = state_dict_to_jax(sd, loop_runs["cfg"])
    diffs = [float(np.max(np.abs(a - b))) for a, b in zip(jax.tree.leaves(got),
                                                          jax.tree.leaves(jparams))]
    assert max(diffs) < 1e-5  # Adam moves each weight by ~lr = 1e-5 a step


def test_loop_resume_continues_the_run(loop_runs, tmp_path):
    """Stop after step 2 (keep only checkpoint-2) and resume: the same
    steps, losses and final weights as the run that never stopped."""
    shutil.copytree(loop_runs["pout"] / "checkpoint-2", tmp_path / "checkpoint-2")
    model, hist = train_and_evaluate(loop_runs["cfg"], None, loop_runs["tok"],
                                     loop_runs["items"], loop_runs["items"], loop_runs["coll"],
                                     _tcfg(TrainingConfig, tmp_path), resume=True,
                                     device="cpu")
    full = loop_runs["hist"]
    assert [e["step"] for e in hist] == [e["step"] for e in full]
    for got, want in zip(hist, full):
        for k in ("loss", "eval_wer"):
            if k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-6), (got, want)
    for (n, p), q in zip(model.named_parameters(), loop_runs["model"].parameters()):
        torch.testing.assert_close(p, q, atol=1e-7, rtol=0, msg=n)
