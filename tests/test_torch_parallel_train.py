"""Port parity: distillation and LoRA under a (data, model) mesh, and the
sharded checkpoint backend (``torch.distributed.checkpoint``).

One spawn of a gloo world of 4 processes on the CPU (a (data 2, model 2)
mesh; a ``file://`` rendezvous under the test's tmp dir, one intra-op thread
a rank, a timeout of its own) runs every sharded check and writes its
results; the test process computes the references meanwhile and holds each
rank's to them, in f32:

  (a) the distillation step (``grad_accum`` 2, and an 80-mel student beside
      a 128-mel teacher on raw audio, the mel run once a frontend on each
      rank's own row) gives JAX's one-device ``make_distill_step``: loss,
      soft, hard and grad norm at rel 1e-5, agreement equal, the gathered
      weights after the step within 0.1 x lr;
  (b) ``distill_and_evaluate`` over 4 steps with the probe (a 3-row dev set,
      cycle-padded before the shard), through either checkpoint backend,
      logs the port's unsharded run's losses (rel 1e-5) and agreements
      (equal), and both backends' checkpoints hold the same weights;
  (c) the LoRA step on JAX's adapters (``lora_from_jax``, cut to each
      rank's shard), with the default targets and with ``wo``, gives JAX's
      ``make_lora_train_step``: loss rel 1e-5, grad norm rel 1e-4, the
      gathered adapters within 1e-5;
  (d) the LoRA loop (the port's own init, SpecAugment, the DCP backend, the
      best checkpoint's adapters re-cut at the end) logs the port's
      unsharded loop's losses and WERs, and its adapters and merged model
      are the unsharded run's (within 0.1 x lr);
  (e) a sharded checkpoint written at (2, 2) with ``gather_tensor`` made to
      raise in the ranks: loaded here, with no process group, its weights
      and moments are bit-equal to the gathered npz copy's and to what
      JAX's Orbax backend saves and loads for them; the ``.distcp`` files
      hold one copy of the tensors plus at most 5%; a run saved at (2, 2)
      resumes unsharded and logs the uninterrupted run's losses (rel
      1e-5); a JAX ``params_ocp/`` dir is refused with a ``ValueError``.
"""

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_distill_step as jax_distill_step
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from whisper_context_biasing_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from whisper_context_biasing_tpu.train.lora import init_lora_params as jax_init_lora
from whisper_context_biasing_tpu.train.lora import make_lora_train_step as jax_lora_step
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.models import params_from_jax, state_dict_to_jax
from whisper_context_biasing_tpu_torch.models import tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import (
    DistillConfig,
    TrainingConfig,
    distill_and_evaluate,
    load_checkpoint,
    train_and_evaluate,
)
from whisper_context_biasing_tpu_torch.train import lora
from whisper_context_biasing_tpu_torch.train.checkpoint import _flatten, _param_names

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT_S = 300
REF_THREADS = 3
V = 120  # test_torch_distill.py's vocabulary: the softmax stays cheap
LR = 1e-3
OPT = dict(peak_lr=LR, warmup_steps=0, total_steps=10)
RTOL = 1e-5
PARAM_ATOL = 0.1 * LR  # test_torch_train.py's rule for weights after a step
AUDIO = 64 * 2 * 160   # the tiny config's window: 128 mel frames
DCFG = dict(per_device_train_batch_size=2, num_train_epochs=1, warmup_steps=0,
            learning_rate=LR, eval_steps=2, save_steps=2, logging_steps=1, eval_batches=2,
            save_total_limit=1)
# the loops: 4 items of batch 2 (one row a rank of "data"), 2 steps an epoch
LOOP = dict(n_audio_layers=1, n_text_layers=1, d_model=16, n_heads=2)
LOOP_TCFG = dict(per_device_train_batch_size=2, per_device_eval_batch_size=2,
                 gradient_accumulation_steps=1, eval_steps=2, save_steps=2, logging_steps=1,
                 warmup_steps=0, learning_rate=LR, generation_max_length=4,
                 early_stopping_patience=50, save_total_limit=10, dataloader_num_workers=1)
LORA_TCFG = dict(LOOP_TCFG, num_train_epochs=2, lora_rank=2, spec_augment=True,
                 load_best_model_at_end=True)

# each rank: python worker.py RANK WORKDIR; no JAX in the ranks
WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                        world_size=4, rank=rank)
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.models import (build_model, params_from_jax,
                                                      state_dict_to_jax, tiny_test_config)
from whisper_context_biasing_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from whisper_context_biasing_tpu_torch.parallel import sharding
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import (DistillConfig, TrainingConfig,
                                                     distill_and_evaluate, init_lora_state,
                                                     init_train_state, make_distill_step,
                                                     make_lora_train_step, make_optimizer,
                                                     make_train_step, save_checkpoint,
                                                     train_and_evaluate)
from whisper_context_biasing_tpu_torch.train import checkpoint, distill, lora
from whisper_context_biasing_tpu_torch.train.checkpoint import _flatten, _unflatten

spec = json.load(open(f"{workdir}/spec.json"))
z = np.load(f"{workdir}/inputs.npz")
arrays = {k: z[k] for k in z.files}
part = lambda p: {k[len(p) + 1:]: v for k, v in arrays.items() if k.startswith(p + "/")}
tree = lambda p: _unflatten(part(p))
mesh = make_mesh(2)
out = {}


def whole(model):
    """The gathered weights in the JAX layout (collective over "model")."""
    return _flatten(state_dict_to_jax({n: sharding.gather_tensor(model, n, p.detach())
                                       for n, p in model.named_parameters()}, model.cfg))


# (a) the distillation step; the mel calls: (n_mels, rows) on this rank
calls = []
real_mel = distill.log_mel_spectrogram_fused
distill.log_mel_spectrogram_fused = lambda a, n_mels: (calls.append([n_mels, a.shape[0]])
                                                      or real_mel(a, n_mels=n_mels))
for name, mels, accum in spec["distill_cases"]:
    cfg_d = tiny_test_config(n_vocab=spec["vocab"], n_mels=mels[0])
    cfg_t = tiny_test_config(n_vocab=spec["vocab"], n_mels=mels[1])
    student = shard_params(build_model(cfg_d, params_from_jax(tree(f"{name}_student"), cfg_d),
                                       device="cpu", train=True), mesh)
    teacher = shard_params(build_model(cfg_t, params_from_jax(tree(f"{name}_teacher"), cfg_t),
                                       device="cpu"), mesh)
    opt = make_optimizer(**spec["opt"])
    calls.clear()
    state, m = make_distill_step(cfg_d, cfg_t, opt, grad_accum=accum, mesh=mesh)(
        init_train_state(student, opt), teacher,
        shard_batch(part(f"{name}_batch"), mesh, extra_leading_axes=int(accum > 1)))
    out[name] = dict({k: float(v) for k, v in m.items()}, mel_calls=list(calls))
    full = whole(state.model)
    if rank == 0:
        np.savez(f"{workdir}/distill_{name}.npz", **full)
distill.log_mel_spectrogram_fused = real_mel

# (b) distill_and_evaluate through both backends
rows = lambda p: [dict(zip(part(p), r)) for r in zip(*part(p).values())]
collate = lambda rs: {k: np.stack([r[k] for r in rs]) for k in rs[0]}
cfg = tiny_test_config(n_vocab=spec["vocab"])
for backend in ("npz", "orbax"):
    dcfg = DistillConfig(output_dir=f"{workdir}/distill_{backend}", checkpoint_backend=backend,
                         **spec["dcfg"])
    _, hist = distill_and_evaluate(cfg, params_from_jax(tree("accum2_student"), cfg), cfg,
                                   params_from_jax(tree("accum2_teacher"), cfg), rows("train"),
                                   rows("dev"), collate, dcfg, mesh=mesh, device="cpu")
    out[f"distill_loop_{backend}"] = hist

# (c) the LoRA step on JAX's adapters, cut to this rank's shard
cfg = tiny_test_config()
base = shard_params(build_model(cfg, params_from_jax(tree("params"), cfg), device="cpu",
                                train=True), mesh).requires_grad_(False)
for name in spec["lora_cases"]:
    adapters, _ = lora.shard_lora(lora.lora_from_jax(tree(f"lora_{name}")), base.tp)
    opt = make_optimizer(**spec["opt"])
    state, m = make_lora_train_step(cfg, opt, grad_accum=2, mesh=mesh)(
        init_lora_state(adapters, opt), base, shard_batch(part("lora_batch"), mesh,
                                                          extra_leading_axes=1))
    out[f"lora_{name}"] = {k: float(v) for k, v in m.items()}
    got, _ = lora.lora_host_arrays(state.model, tp=base.tp)
    if rank == 0:
        np.savez(f"{workdir}/lora_{name}.npz", **_flatten(got))

# (d) the LoRA loop (the port's init, SpecAugment, DCP), (e) a full-weight
# run saved through DCP for the unsharded resume
tok = load_tokenizer()
lcfg = tiny_test_config(**spec["loop"])
items = [{"input_features": f, "labels": arrays["loop_labels"], "bias_spans": []}
         for f in arrays["loop_feats"]]
coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                             decoder_prev_token_id=tok.sop)
for name, over in (("lora_loop", spec["lora_tcfg"]),
                   ("resume", dict(spec["loop_tcfg"], num_train_epochs=2))):
    tcfg = TrainingConfig(output_dir=f"{workdir}/{name}", checkpoint_backend="orbax", **over)
    model, hist = train_and_evaluate(lcfg, params_from_jax(tree("loop"), lcfg), tok, items,
                                     items, coll, tcfg, mesh=mesh, device="cpu")
    out[name] = hist
    full = whole(model)
    if rank == 0:
        np.savez(f"{workdir}/{name}_model.npz", **full)

# (e) a sharded save that must not gather, then the gathered npz of the same
vcfg = tiny_test_config(n_vocab=spec["ckpt_vocab"])
model = shard_params(build_model(vcfg, params_from_jax(tree("vocab"), vcfg), device="cpu",
                                 train=True), mesh)
opt = make_optimizer(**spec["opt"])
state, _ = make_train_step(vcfg, opt, mesh=mesh)(init_train_state(model, opt),
                                                  shard_batch(part("ckpt_batch"), mesh))
kept = (sharding.gather_tensor, checkpoint.gather_tensor, sharding._gather_dim)


def refuse(*args, **kwargs):
    raise AssertionError("the sharded save gathered a tensor")


sharding.gather_tensor = checkpoint.gather_tensor = sharding._gather_dim = refuse
try:
    save_checkpoint(f"{workdir}/sharded", 1, model, state.opt_state, {"eval_wer": 1.0},
                    backend="orbax", mesh=mesh)
finally:
    sharding.gather_tensor, checkpoint.gather_tensor, sharding._gather_dim = kept
out["sharded_save"] = "no gather"
save_checkpoint(f"{workdir}/gathered", 1, model, state.opt_state, {"eval_wer": 1.0},
                mesh=mesh)
json.dump(out, open(f"{workdir}/result_{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _distill_batch(seed, b, n_mels=80, audio=False):
    """test_torch_distill.py's batch: features (or raw audio), tokens,
    labels with an ignored tail."""
    rng = np.random.default_rng(seed)
    dec = rng.integers(0, V, size=(b, 12)).astype(np.int32)
    labels = np.concatenate([dec[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
    labels[:, -3:] = -100
    labels[1, 4:] = -100  # the rows hold different numbers of valid labels
    out = {"decoder_input_ids": dec, "labels": labels}
    if audio:
        out["audio"] = (0.1 * rng.standard_normal((b, AUDIO))).astype(np.float32)
    else:
        out["input_features"] = rng.standard_normal((b, n_mels, 128)).astype(np.float32)
    return out


def _synth_rows(n, seed):
    rng = np.random.default_rng(seed)
    dec = rng.integers(0, V, size=(n, 8)).astype(np.int64)
    return {"input_features": rng.standard_normal((n, 80, 128)).astype(np.float32),
            "decoder_input_ids": dec,
            "labels": np.concatenate([dec[:, 1:], np.full((n, 1), -100)], axis=1)}


def _collated(seed, rows, accum=1, label_len=24):
    """Prompted rows with planted bias spans through the port's collator
    (test_torch_lora.py's batch)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(rows):
        ctx = list(rng.integers(100, 5000, 3 + i))
        text = list(rng.integers(100, 5000, label_len - len(ctx) - 3 - i))
        items.append({"input_features": (rng.standard_normal((80, 128)) * 0.5).astype(np.float32),
                      "labels": [50360, *ctx, 50257, *text, 50256],
                      "bias_spans": [text[2:4], list(rng.integers(100, 5000, 2))]})
    coll = SpeechSeq2SeqCollator(pad_token_id=50256, decoder_start_token_id=50257,
                                 decoder_prev_token_id=50360, max_target_length=label_len)
    batch = coll(items)
    if accum > 1:
        batch = {k: v.reshape(accum, rows // accum, *v.shape[1:]) for k, v in batch.items()}
    return batch


def _jax_lora(params, targets, seed):
    """JAX-drawn adapters with B made non-zero (so A gets a gradient)."""
    ad = jax.tree.map(np.asarray, jax_init_lora(params, 4, jax.random.PRNGKey(seed),
                                                targets=targets))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x if x.any() else
                        (0.02 * rng.standard_normal(x.shape)).astype(np.float32), ad)


def _jax_distill(student, teacher, batch, mels, accum):
    jopt = jax_make_optimizer(**OPT)
    step = jax_distill_step(jax_tiny(n_vocab=V, n_mels=mels[0]),
                            jax_tiny(n_vocab=V, n_mels=mels[1]), jopt, grad_accum=accum,
                            donate=False, mel_interpret=True)
    state, m = step(jax_init_state(student, jopt), teacher,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return dict({k: float(v) for k, v in m.items()},
                params=_flatten(jax.tree.map(np.asarray, state.params)))


def _jax_lora_step(params, adapters, batch):
    jopt = jax_make_optimizer(**OPT)
    state, m = jax_lora_step(jax_tiny(), jopt, grad_accum=2, donate=False)(
        jax_init_state(adapters, jopt), params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict({k: float(v) for k, v in m.items()},
                adapters=_flatten(jax.tree.map(np.asarray, state.params)))


def _rows(batch):
    return [dict(zip(batch, r)) for r in zip(*batch.values())]


def _collate(rs):
    return {k: np.stack([r[k] for r in rs]) for k in rs[0]}


def _loop_items(feats, labels):
    return [{"input_features": f, "labels": labels, "bias_spans": []} for f in feats]


def _unsharded(arrays, workdir):
    """The port's unsharded runs of (b), (d) and (e): the distillation loop,
    the LoRA loop, and a full-weight run of 4 steps uninterrupted."""
    tok = load_tokenizer()
    cfg = tiny_test_config(n_vocab=V)
    tree = {p: _unflatten_prefix(arrays, p) for p in ("accum2_student", "accum2_teacher", "loop")}
    _, dist_hist = distill_and_evaluate(
        cfg, params_from_jax(tree["accum2_student"], cfg), cfg,
        params_from_jax(tree["accum2_teacher"], cfg), _rows(_prefixed(arrays, "train")),
        _rows(_prefixed(arrays, "dev")), _collate,
        DistillConfig(output_dir=str(workdir / "ref_distill"), **DCFG), device="cpu")
    lcfg = tiny_test_config(**LOOP)
    items = _loop_items(arrays["loop_feats"], arrays["loop_labels"])
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop)
    out = {"distill": dist_hist}
    for name, over in (("lora_loop", LORA_TCFG), ("full", dict(LOOP_TCFG, num_train_epochs=2))):
        model, out[name] = train_and_evaluate(
            lcfg, params_from_jax(tree["loop"], lcfg), tok, items, items, coll,
            TrainingConfig(output_dir=str(workdir / f"ref_{name}"), **over), device="cpu")
        out[f"{name}_model"] = _flatten(state_dict_to_jax(dict(model.named_parameters()), lcfg))
    return out


def _prefixed(arrays, p):
    return {k[len(p) + 1:]: v for k, v in arrays.items() if k.startswith(p + "/")}


def _unflatten_prefix(arrays, p):
    from whisper_context_biasing_tpu_torch.train.checkpoint import _unflatten

    return _unflatten(_prefixed(arrays, p))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawn: inputs written, 4 ranks started, the references computed
    while they run, then every rank's results."""
    workdir = tmp_path_factory.mktemp("train_world")
    tok = load_tokenizer()
    pair = {"accum2": (80, 80), "mixed": (80, 128)}
    arrays = {}
    for name, (m_d, m_t) in pair.items():
        for role, m, seed in (("student", m_d, 0), ("teacher", m_t, 7)):
            p = jax.tree.map(np.asarray, jax_init(jax_tiny(n_vocab=V, n_mels=m), seed))
            arrays.update({f"{name}_{role}/{k}": v for k, v in _flatten(p).items()})
    accum = _distill_batch(3, 4)
    batches = {"accum2": {k: v.reshape(2, 2, *v.shape[1:]) for k, v in accum.items()},
               "mixed": _distill_batch(5, 2, audio=True)}
    for name, b in batches.items():
        arrays.update({f"{name}_batch/{k}": v for k, v in b.items()})
    arrays.update({f"train/{k}": v for k, v in _synth_rows(8, 3).items()})
    arrays.update({f"dev/{k}": v for k, v in _synth_rows(3, 4).items()})
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    adapters = {"qv": _jax_lora(params, ("wq", "wv"), 1), "qo": _jax_lora(params, ("wq", "wo"), 2)}
    arrays.update({f"params/{k}": v for k, v in _flatten(params).items()})
    for name, ad in adapters.items():
        arrays.update({f"lora_{name}/{k}": v for k, v in _flatten(ad).items()})
    lora_batch = _collated(1, 4, accum=2)
    arrays.update({f"lora_batch/{k}": v for k, v in lora_batch.items()})
    lparams = jax.tree.map(np.asarray, jax_init(jax_tiny(**LOOP), 0))
    arrays.update({f"loop/{k}": v for k, v in _flatten(lparams).items()})
    arrays["loop_feats"] = (np.random.default_rng(0).standard_normal((4, 80, 128)) * 0.3).astype(
        np.float32)
    arrays["loop_labels"] = np.asarray([tok.sot, 5, 6, tok.eot], np.int32)
    vparams = jax.tree.map(np.asarray, jax_init(jax_tiny(n_vocab=51865), 1))
    arrays.update({f"vocab/{k}": v for k, v in _flatten(vparams).items()})
    arrays.update({f"ckpt_batch/{k}": v for k, v in _collated(2, 2).items()})
    np.savez(workdir / "inputs.npz", **arrays)
    spec = dict(vocab=V, opt=OPT, dcfg=DCFG, loop=LOOP, loop_tcfg=LOOP_TCFG, lora_tcfg=LORA_TCFG,
                ckpt_vocab=51865, lora_cases=list(adapters),
                distill_cases=[[n, m, 2 if n == "accum2" else 1] for n, m in pair.items()])
    (workdir / "spec.json").write_text(json.dumps(spec))
    (workdir / "worker.py").write_text(WORKER)

    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        env.pop(k, None)
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(workdir / "worker.py"), str(r), str(workdir)],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        jobs = {f"distill_{n}": (lambda n=n: _jax_distill(
                    _unflatten_prefix(arrays, f"{n}_student"),
                    _unflatten_prefix(arrays, f"{n}_teacher"), batches[n], pair[n],
                    2 if n == "accum2" else 1)) for n in pair}
        jobs.update({f"lora_{n}": (lambda n=n: _jax_lora_step(params, adapters[n], lora_batch))
                     for n in adapters})
        jobs["unsharded"] = lambda: _unsharded(arrays, workdir)
        with ThreadPoolExecutor(REF_THREADS) as pool:
            futures = {k: pool.submit(fn) for k, fn in jobs.items()}
            ref = {k: f.result(timeout=SPAWN_TIMEOUT_S) for k, f in futures.items()}
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join((workdir / f"rank{r}.log").read_text()[-3000:] for r in failed)
    ranks = [json.loads((workdir / f"result_{r}.json").read_text()) for r in range(WORLD)]
    return dict(workdir=workdir, ref=ref, ranks=ranks, arrays=arrays)


def _losses_match(got, want):
    """Two log histories: the same entries, losses at rel 1e-5, every other
    value (agreement, WER, steps) equal."""
    drop = ("wall_s", "elapsed_s")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in drop:
                continue
            if k in ("loss", "soft", "hard", "grad_norm"):
                assert g[k] == pytest.approx(v, rel=RTOL, abs=1e-6), (k, g, w)
            else:
                assert g[k] == v, (k, g, w)


@pytest.mark.parametrize("name", ["accum2", "mixed"])
def test_distill_step_matches_jax(world, name):
    ref = world["ref"][f"distill_{name}"]
    for r in world["ranks"]:
        got = r[name]
        for k in ("loss", "soft", "hard", "grad_norm"):
            # soft: a KL of near distributions, its rounding absolute
            assert got[k] == pytest.approx(ref[k], rel=RTOL, abs=1e-6), k
        assert got["agreement"] == ref["agreement"]
        # raw audio: the mel once a frontend, on the rank's own row
        want = [[128, 1], [80, 1]] if name == "mixed" else []
        assert got["mel_calls"] == want
    with np.load(world["workdir"] / f"distill_{name}.npz") as z:
        assert set(z.files) == set(ref["params"])
        for k in z.files:
            np.testing.assert_allclose(z[k], ref["params"][k], atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_distill_loop_matches_unsharded(world):
    """Both backends log the unsharded run's losses and agreements; rank
    0's npz checkpoint and the ranks' DCP checkpoint hold the same weights,
    within 0.1 x lr of the unsharded run's."""
    want = world["ref"]["unsharded"]["distill"]
    assert want[-1]["total_steps"] == 4 and sum("eval_agreement" in h for h in want) == 2
    for r in world["ranks"]:
        for backend in ("npz", "orbax"):
            _losses_match(r[f"distill_loop_{backend}"], want)
    cfg = tiny_test_config(n_vocab=V)
    wd = world["workdir"]
    ref, _, _ = load_checkpoint(str(wd / "ref_distill" / "checkpoint-4"), cfg)
    npz, _, _ = load_checkpoint(str(wd / "distill_npz" / "checkpoint-4"), cfg)
    sharded, opt, meta = load_checkpoint(str(wd / "distill_orbax" / "checkpoint-4"), cfg,
                                         load_opt_state=True)
    assert os.path.isdir(wd / "distill_orbax" / "checkpoint-4" / "params_dcp")
    assert meta["eval_step"] == 4 and opt.count == 4
    for k in ref:
        assert torch.equal(sharded[k], npz[k]), k
        torch.testing.assert_close(sharded[k], ref[k], atol=PARAM_ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("name", ["qv", "qo"])
def test_lora_step_matches_jax(world, name):
    ref = world["ref"][f"lora_{name}"]
    for r in world["ranks"]:
        got = r[f"lora_{name}"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=RTOL)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    with np.load(world["workdir"] / f"lora_{name}.npz") as z:
        assert set(z.files) == set(ref["adapters"])
        if name == "qo":
            assert any("/wo/" in k for k in z.files)
        for k in z.files:
            np.testing.assert_allclose(z[k], ref["adapters"][k], atol=1e-5, rtol=0, err_msg=k)


def test_lora_loop_matches_unsharded(world):
    """The port's own init under the mesh starts where the unsharded run
    does: the same losses and WERs, the best checkpoint's adapters and the
    returned merged model the unsharded run's."""
    want = world["ref"]["unsharded"]
    assert [e["step"] for e in want["lora_loop"] if "loss" in e] == [1, 2, 3, 4]
    for r in world["ranks"]:
        _losses_match(r["lora_loop"], want["lora_loop"])
    wd = world["workdir"]
    got, _, meta = lora.load_lora_checkpoint(str(wd / "lora_loop" / "checkpoint-4"))
    ref, _, _ = lora.load_lora_checkpoint(str(wd / "ref_lora_loop" / "checkpoint-4"))
    assert os.path.isdir(wd / "lora_loop" / "checkpoint-4" / "params_dcp")
    assert meta["lora_rank"] == 2
    for (path, a), (_, b) in zip(lora._leaves(got), lora._leaves(ref)):
        torch.testing.assert_close(a, b, atol=PARAM_ATOL, rtol=0, msg=str(path))
    with np.load(wd / "lora_loop_model.npz") as z:
        for k, v in want["lora_loop_model"].items():
            np.testing.assert_allclose(z[k], v, atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_sharded_checkpoint_loads_whole_and_bit_equal(world, tmp_path):
    """Written at (2, 2) without a gather, read here without a process
    group: the gathered npz copy's weights and moments bit for bit, and
    what JAX's Orbax backend saves and loads for them; the files hold one
    copy plus at most 5%; a JAX Orbax dir is refused."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert all(r["sharded_save"] == "no gather" for r in world["ranks"])
    cfg = tiny_test_config(n_vocab=51865)
    wd = world["workdir"]
    path = str(wd / "sharded" / "checkpoint-1")
    sd, opt, meta = load_checkpoint(path, cfg, load_opt_state=True)
    gsd, gopt, _ = load_checkpoint(str(wd / "gathered" / "checkpoint-1"), cfg, load_opt_state=True)
    assert meta == {"step": 1, "eval_wer": 1.0} and opt.count == gopt.count == 1
    assert sd.keys() == gsd.keys()
    for k in gsd:
        assert torch.equal(sd[k], gsd[k]), k
    for a, b in zip(opt.mu + opt.nu, gopt.mu + gopt.nu):
        assert torch.equal(a, b)

    # JAX's Orbax backend on the same params and moments (optax's leaves:
    # Adam's count, mu, nu, the schedule's count)
    names = _param_names(cfg)
    jparams = jax.tree.map(jnp.asarray, state_dict_to_jax(gsd, cfg))
    template = jax_make_optimizer(**OPT).init(jparams)
    mu, nu = (list(_flatten(state_dict_to_jax(dict(zip(names, m)), cfg)).values())
              for m in (opt.mu, opt.nu))
    count = np.asarray(opt.count, np.int32)
    leaves = [count, *mu, *nu, count]
    jstate = jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(x) for x in leaves])
    jpath = jax_save_checkpoint(str(tmp_path), 1, jparams, opt_state=jstate, backend="orbax")
    jp, jo, _ = jax_load_checkpoint(jpath, opt_state_template=template)
    got, want = _flatten(state_dict_to_jax(sd, cfg)), _flatten(jax.tree.map(np.asarray, jp))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(leaves, jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="npz backend"):
        load_checkpoint(jpath, cfg)

    # one copy of the tensors, each shard written by one rank
    tensors = {"params_dcp": sum(t.numel() * 4 for t in gsd.values()),
               "opt_dcp": 2 * sum(m.numel() * 4 for m in gopt.mu) + 8}
    for d, size in tensors.items():
        files = [f for f in os.listdir(os.path.join(path, d)) if f.endswith(".distcp")]
        written = sum(os.path.getsize(os.path.join(path, d, f)) for f in files)
        assert set(files) <= {f"__{r}_0.distcp" for r in range(WORLD)}
        assert size <= written <= 1.05 * size, (d, written, size)


def test_sharded_run_resumes_unsharded(world, tmp_path):
    """A fine-tune run at (2, 2) logs the unsharded run's losses; its DCP
    checkpoint of step 2 resumes on one process, and the resumed run logs
    what the uninterrupted unsharded run logs."""
    want = world["ref"]["unsharded"]["full"]
    for r in world["ranks"]:
        _losses_match(r["resume"], want)
    out = tmp_path / "resume"
    shutil.copytree(world["workdir"] / "resume", out)
    shutil.rmtree(out / "checkpoint-4")  # the run as it stood after step 2
    assert os.path.isdir(out / "checkpoint-2" / "opt_dcp")
    tok = load_tokenizer()
    lcfg = tiny_test_config(**LOOP)
    arrays = world["arrays"]
    items = _loop_items(arrays["loop_feats"], arrays["loop_labels"])
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop)
    _, hist = train_and_evaluate(lcfg, params_from_jax(_unflatten_prefix(arrays, "loop"), lcfg),
                                 tok, items, items, coll,
                                 TrainingConfig(output_dir=str(out), num_train_epochs=2,
                                                **LOOP_TCFG),
                                 resume=True, device="cpu")
    assert [e["step"] for e in hist if "loss" in e] == [1, 2, 3, 4]
    _losses_match(hist, want)
