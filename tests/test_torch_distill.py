"""Port parity: draft distillation (``train/distill.py``, ``cli/distill.py``)
against the JAX package, in the cases of its ``tests/test_distill.py`` (by
name), each with the port's case beside it.

Both packages run ``tiny_test_config`` with a 120-token vocab from the same
weights (the JAX init, carried over with ``params_from_jax``), f32. The
compare: loss, soft, hard and agreement at rel 1e-5 (agreement exactly);
the student's gradients at 1e-4 of the largest; the teacher gets none;
``grad_accum`` equal to the flat step; one step's loss and weights against
JAX's step; the raw-audio step with two mel frontends (the port's plain mel
against JAX's interpret-mode kernel at 1e-4, as tests/test_torch_mel.py
holds it, and the mel run once per distinct n_mels); the runner's
checkpoints and probe padding; and ``cli.distill`` on a WAV corpus with
the JAX script's flag defaults."""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.ops.mel_kernel import log_mel_spectrogram_fused as jax_mel
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_distill_loss_fn as jax_loss_fn
from whisper_context_biasing_tpu.train import make_distill_step as jax_step
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.train import (
    DistillConfig,
    distill_and_evaluate,
    find_best_checkpoint,
    init_train_state,
    list_checkpoints,
    make_agreement_step,
    make_distill_loss_fn,
    make_distill_step,
    make_optimizer,
)
from whisper_context_biasing_tpu_torch.train import distill

V = 120  # tiny vocab keeps the softmax cheap


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: the test workers run side
    by side, and more threads a worker only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(**kw):
    return tiny_test_config(**{"n_vocab": V, **kw})


def jax_cfg(**kw):
    return jax_tiny(**{"n_vocab": V, **kw})


def make_batch(seed=0, b=2, s=12, n_mels=80, n_audio_ctx=64):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, n_mels, 2 * n_audio_ctx)).astype(np.float32)
    dec = rng.integers(0, V, size=(b, s)).astype(np.int32)
    labels = np.concatenate([dec[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
    labels[:, -3:] = -100  # some ignored tail positions
    return {"input_features": feats, "decoder_input_ids": dec, "labels": labels}


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    """JAX's init for a student (seed 0) and a teacher (seed 7), as numpy
    trees, and the same weights as port models (student: f32 masters)."""
    params = {s: jax.tree.map(np.asarray, jax_init(jax_cfg(), s)) for s in (0, 7)}
    cfg = small_cfg()
    student = build_model(cfg, params_from_jax(params[0], cfg), device="cpu", train=True)
    teacher = build_model(cfg, params_from_jax(params[7], cfg), device="cpu")
    return params, cfg, student, teacher


# ---------------------------------------------------------------------------
# loss semantics
# ---------------------------------------------------------------------------

def test_identical_models_agree(pair):
    _, cfg, student, _ = pair
    with torch.no_grad():
        loss, aux = make_distill_loss_fn(cfg, cfg)(student, student, tensors(make_batch()))
    assert float(aux["agreement"]) == pytest.approx(1.0)
    assert float(aux["soft"]) == pytest.approx(0.0, abs=1e-4)
    assert float(loss) == pytest.approx(0.5 * float(aux["hard"]), abs=1e-4)


def test_vocab_mismatch_rejected():
    with pytest.raises(ValueError, match="vocab mismatch"):
        make_distill_loss_fn(small_cfg(), small_cfg(n_vocab=V + 1))


@pytest.mark.parametrize("temperature,hard_weight", [(2.0, 0.5), (1.0, 0.0), (3.0, 1.0)])
def test_loss_and_aux_match_jax(pair, temperature, hard_weight):
    params, cfg, student, teacher = pair
    batch = make_batch(seed=1)
    jloss, jaux = jax_loss_fn(jax_cfg(), jax_cfg(), temperature, hard_weight)(
        params[0], params[7], {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, aux = make_distill_loss_fn(cfg, cfg, temperature, hard_weight)(
            student, teacher, tensors(batch))
    # soft is a KL of two near distributions, a difference of near sums:
    # its rounding is absolute (1e-6 on values of ~0.03), hence the floor
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)
    assert float(aux["soft"]) == pytest.approx(float(jaux["soft"]), rel=1e-5, abs=1e-6)
    assert float(aux["hard"]) == pytest.approx(float(jaux["hard"]), rel=1e-5)
    assert float(aux["agreement"]) == float(jaux["agreement"])


def test_teacher_gets_no_grad_and_student_grads_match_jax(pair):
    params, cfg, student, teacher = pair
    batch = make_batch(seed=2)
    jfn = jax_loss_fn(jax_cfg(), jax_cfg())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.grad(lambda p: jfn(p, params[7], jb)[0])(params[0])
    tg = jax.grad(lambda t: jfn(params[0], t, jb)[0])(params[7])
    assert all(float(jnp.abs(x).max()) == 0.0 for x in jax.tree.leaves(tg))

    teacher_t = build_model(cfg, params_from_jax(params[7], cfg), device="cpu", train=True)
    student.zero_grad(set_to_none=True)
    loss, _ = make_distill_loss_fn(cfg, cfg)(student, teacher_t, tensors(batch))
    loss.backward()
    assert all(p.grad is None for p in teacher_t.parameters())
    got = state_dict_to_jax({n: p.grad for n, p in student.named_parameters()}, cfg)
    want = jax.tree.map(np.asarray, jg)
    scale = max(np.abs(w).max() for w in jax.tree.leaves(want))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    student.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _student(params, cfg):
    return build_model(cfg, params_from_jax(params[0], cfg), device="cpu", train=True)


def test_agreement_rises(pair):
    params, cfg, _, teacher = pair
    opt = make_optimizer(peak_lr=1e-2, warmup_steps=0, total_steps=300)
    step = make_distill_step(cfg, cfg, opt, hard_weight=0.0, temperature=1.0)
    state = init_train_state(_student(params, cfg), opt)
    batch = tensors(make_batch())
    first = None
    for _ in range(150):
        state, m = step(state, teacher, batch)
        if first is None:
            first = {k: float(v) for k, v in m.items()}
    last = {k: float(v) for k, v in m.items()}
    assert last["loss"] < first["loss"]
    assert last["agreement"] > max(0.5, first["agreement"])


def test_one_step_matches_jax(pair):
    params, cfg, _, teacher = pair
    batch = make_batch(seed=3)
    kw = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    jopt = jax_make_optimizer(**kw)
    jstate, jm = jax_step(jax_cfg(), jax_cfg(), jopt, donate=False)(
        jax_init_state(params[0], jopt), params[7], {k: jnp.asarray(v) for k, v in batch.items()})
    opt = make_optimizer(**kw)
    state, m = make_distill_step(cfg, cfg, opt)(init_train_state(_student(params, cfg), opt),
                                                teacher, batch)
    for k in ("loss", "soft", "hard", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), k
    assert float(m["agreement"]) == float(jm["agreement"]) and state.step == 1
    # Adam's first step moves a weight by ~lr whatever its gradient's size,
    # so a gradient near eps moves by its rounding: test_torch_train.py's
    # 0.1 x lr rule for post-step weights
    got = state_dict_to_jax(dict(state.model.named_parameters()), cfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray,
                                                                       jstate.params))):
        np.testing.assert_allclose(a, b, atol=0.1 * kw["peak_lr"], rtol=0)


def test_grad_accum_matches_flat(pair):
    params, cfg, _, teacher = pair
    opt = make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    big = make_batch(b=4)
    micro = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in big.items()}
    s1, m1 = make_distill_step(cfg, cfg, opt)(init_train_state(_student(params, cfg), opt),
                                              teacher, big)
    s2, m2 = make_distill_step(cfg, cfg, opt, grad_accum=2)(
        init_train_state(_student(params, cfg), opt), teacher, micro)
    for k in ("loss", "soft", "hard", "agreement"):
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-5), k
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_agreement_eval_step(pair):
    params, cfg, student, teacher = pair
    batch = make_batch(seed=4)
    m = make_agreement_step(cfg, cfg)(student, teacher, batch)
    assert set(m) == {"loss", "soft", "hard", "agreement"}
    assert 0.0 <= float(m["agreement"]) <= 1.0 and not m["loss"].requires_grad
    jloss, _ = jax_loss_fn(jax_cfg(), jax_cfg())(
        params[0], params[7], {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jloss), rel=1e-5)


# ---------------------------------------------------------------------------
# mismatched mel frontends
# ---------------------------------------------------------------------------

def test_raw_audio_two_frontends(monkeypatch):
    """An 80-mel draft against a 128-mel target from one raw-audio batch: the
    mel runs once per n_mels (the port's plain version, within 1e-4 of JAX's
    interpret-mode kernel at both), and the loss is the loss of those
    features passed in precomputed."""
    # tests/test_torch_mel.py's signal (the JAX package's mel test signal)
    rng = np.random.default_rng(0)
    t = np.arange(480000) / 16000.0
    tones = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
    audio = (tones + 0.05 * rng.standard_normal((1, t.size))).astype(np.float32)
    mels = {}
    for n_mels in (80, 128):
        want = np.asarray(jax_mel(jnp.asarray(audio), n_mels=n_mels, interpret=True))
        mels[n_mels] = ops.log_mel_spectrogram_fused(torch.from_numpy(audio), n_mels=n_mels)
        np.testing.assert_allclose(mels[n_mels].numpy(), want, atol=1e-4, rtol=0)

    cfg_d = small_cfg(n_mels=80, n_audio_ctx=1500)
    cfg_t = small_cfg(n_mels=128, n_audio_ctx=1500)
    student = build_model(cfg_d, seed=0, device="cpu", train=True)
    teacher = build_model(cfg_t, seed=1, device="cpu")
    tok = {"decoder_input_ids": torch.tensor([[5, 9, 11, 2]]),
           "labels": torch.tensor([[9, 11, 2, -100]])}
    calls = []
    real = distill.log_mel_spectrogram_fused
    monkeypatch.setattr(distill, "log_mel_spectrogram_fused",
                        lambda a, n_mels: calls.append(n_mels) or real(a, n_mels=n_mels))
    loss_fn = make_distill_loss_fn(cfg_d, cfg_t, mel_interpret=True)
    loss, aux = loss_fn(student, teacher, dict(tok, audio=torch.from_numpy(audio)))
    assert sorted(calls) == [80, 128]
    ref, ref_aux = loss_fn(student, teacher, dict(tok, input_features=mels[128],
                                                  input_features_draft=mels[80]))
    loss, ref = float(loss.detach()), float(ref.detach())
    assert np.isfinite(loss) and 0.0 <= float(aux["agreement"]) <= 1.0
    assert loss == ref and float(aux["agreement"]) == float(ref_aux["agreement"])


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class SynthDataset:
    def __init__(self, n, seed=3):
        rng = np.random.default_rng(seed)
        self.rows = []
        for _ in range(n):
            dec = rng.integers(0, V, size=8).astype(np.int64)
            self.rows.append({"input_features": rng.standard_normal((80, 128)).astype(np.float32),
                              "decoder_input_ids": dec,
                              "labels": np.concatenate([dec[1:], [-100]]).astype(np.int64)})

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def collate(rows):
    return {k: np.stack([r[k] for r in rows]).astype(
        np.int32 if k != "input_features" else np.float32) for k in rows[0]}


def test_distill_and_evaluate_checkpoints(pair, tmp_path):
    params, cfg, _, _ = pair
    dcfg = DistillConfig(output_dir=str(tmp_path), per_device_train_batch_size=2,
                         num_train_epochs=1, warmup_steps=0, learning_rate=1e-3,
                         eval_steps=2, save_steps=2, logging_steps=1, eval_batches=2,
                         save_total_limit=1)
    student0 = params_from_jax(params[0], cfg)
    model, hist = distill_and_evaluate(cfg, student0, cfg, params_from_jax(params[7], cfg),
                                       SynthDataset(8), SynthDataset(4), collate, dcfg,
                                       device="cpu")
    assert list_checkpoints(str(tmp_path)), "no checkpoint written"
    best = find_best_checkpoint(str(tmp_path), metric_key="eval_disagreement")
    assert best is not None
    with open(os.path.join(best, "trainer_state.json")) as f:
        meta = json.load(f)
    assert "eval_agreement" in meta and "eval_step" in meta
    assert meta["eval_disagreement"] == pytest.approx(1.0 - meta["eval_agreement"])
    assert any("eval_agreement" in h for h in hist)
    assert hist[-1]["total_steps"] == 4 and "best_agreement" in hist[-1]
    # training ran: the weights moved
    assert any(not torch.equal(p, student0[n]) for n, p in model.named_parameters())
    # a mesh of one (a gloo world of this process alone) and the sharded
    # backend: the same log and weights as the run above
    import torch.distributed as dist

    from whisper_context_biasing_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        dcfg.output_dir, dcfg.checkpoint_backend = str(tmp_path / "mesh"), "orbax"
        meshed, mhist = distill_and_evaluate(cfg, student0, cfg, params_from_jax(params[7], cfg),
                                             SynthDataset(8), SynthDataset(4), collate, dcfg,
                                             mesh=make_mesh(1), device="cpu")
    finally:
        dist.destroy_process_group()
    assert [{k: v for k, v in h.items() if k != "wall_s"} for h in mhist] == \
        [{k: v for k, v in h.items() if k != "wall_s"} for h in hist]
    for n, p in model.named_parameters():
        assert torch.equal(p, meshed.get_parameter(n)), n
    best = find_best_checkpoint(dcfg.output_dir, metric_key="eval_disagreement")
    assert os.path.isdir(os.path.join(best, "params_dcp"))


def test_probe_pads_partial_eval_batch(pair, tmp_path, monkeypatch):
    """A dev set not divisible by the batch size reaches the eval step
    cycle-padded to the batch size."""
    params, cfg, _, _ = pair
    seen = []
    real = distill.make_agreement_step

    def spy_make(*a, **kw):
        fn = real(*a, **kw)

        def eval_step(s, t, b):
            seen.append(next(iter(b.values())).shape[0])
            return fn(s, t, b)
        return eval_step

    monkeypatch.setattr(distill, "make_agreement_step", spy_make)
    dcfg = DistillConfig(output_dir=str(tmp_path), per_device_train_batch_size=2,
                         num_train_epochs=1, warmup_steps=0, eval_steps=1, save_steps=10,
                         logging_steps=10, eval_batches=3)
    distill_and_evaluate(cfg, params_from_jax(params[0], cfg), cfg,
                         params_from_jax(params[7], cfg), SynthDataset(4), SynthDataset(3),
                         collate, dcfg, device="cpu")
    assert seen and all(s == 2 for s in seen)  # 3-row dev: 2 + pad(1 -> 2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _wav_corpus(root):
    jsonl = root / "jsonl"
    jsonl.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = [{"id": "0", "file": "a0.wav", "text": "take aspirin daily",
             "description": "aspirin", "bias_words": ["aspirin"]},
            {"id": "1", "file": "a1.wav", "text": "plain words here",
             "description": "plain", "bias_words": []}]
    for phase in ("train", "dev"):
        with open(jsonl / f"{phase}.jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        d = root / "audio" / phase
        d.mkdir(parents=True)
        for r in rows:
            with wave.open(str(d / r["file"]), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((rng.standard_normal(16000) * 3000).astype(np.int16).tobytes())
    return jsonl


def test_distill_parse_args_defaults_match_jax(monkeypatch, tmp_path):
    import importlib.util
    import sys

    from whisper_context_biasing_tpu_torch.cli import distill as cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("wcb_distill_cli",
                                                  os.path.join(repo, "scripts", "distill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["distill.py"])
    want = vars(mod.parse_args())
    got = vars(cli.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    # ported since: both flags are taken, and the run goes on to read the
    # missing data (the mesh is built after it, as the JAX script builds it)
    for flags in (["--model_parallelism", "2"], ["--checkpoint_backend", "orbax"]):
        with pytest.raises(FileNotFoundError, match="none"):
            cli.main([*flags, "--model", "tiny.en", "--jsonl_data", str(tmp_path / "none"),
                      "--device", "cpu"])


@pytest.mark.parametrize("draft", ["same_mels", "mixed_mels"])
def test_distill_cli_smoke(tmp_path, monkeypatch, draft):
    """``cli.distill`` end to end on a synthetic WAV corpus (narrow configs
    with the real audio window): checkpoints, summary and the draft's
    model.safetensors; a 128-mel target over an 80-mel draft reads raw
    audio."""
    from whisper_context_biasing_tpu_torch.cli import distill as cli
    from whisper_context_biasing_tpu_torch.models import load_safetensors

    narrow = dict(n_audio_ctx=1500, d_model=16, n_heads=2, n_audio_layers=1, n_text_layers=1)

    def get_config(name, **kw):
        return tiny_test_config(**narrow, n_mels=128 if name == "large-v3" else 80, **kw)

    monkeypatch.setattr(cli, "get_config", get_config)
    root = tmp_path / "corpus"
    jsonl = _wav_corpus(root)
    out = tmp_path / "draft"
    target = ["--model", "large-v3"] if draft == "mixed_mels" else []
    cli.main(["--draft_model", "tiny.en", *target, "--data_root", str(root),
              "--data_dir", "audio", "--jsonl_data", str(jsonl), "--output", str(out),
              "--batch", "2", "--epoch", "1", "--warmup_steps", "0", "--logging_steps", "1",
              "--eval_batches", "1", "--model_parallelism", "0", "--prompt",
              "--device", "cpu"])
    with open(out / "distill_results.json") as f:
        summary = json.load(f)
    assert summary["total_steps"] >= 1 and 0.0 <= summary["best_agreement"] <= 1.0
    assert list_checkpoints(str(out))
    sd, cfg = load_safetensors(str(out / "model.safetensors"), get_config("tiny.en"))
    assert sd["decoder.token_emb"].shape == (cfg.n_vocab, 16)
