"""Port parity: data and tensor parallelism against the JAX package on one
device.

One spawn of a gloo world of 4 processes on the CPU (a (data 2, model 2)
mesh; a ``file://`` rendezvous under the test's tmp dir, one intra-op thread
a rank, a timeout of its own) runs every sharded check and writes its
results; the test process computes the JAX package's single-device results
meanwhile and holds each rank's to them:

  * the training step (fused LayerNorm + flash config, the kernels' plain
    versions) gives JAX's loss and grad norm (rel 1e-5) and, gathered, JAX's
    updated weights; so does a ``grad_accum=2`` step of the plain config;
  * greedy (prompted, biased, rows that stop at different steps, a batch
    that pads over "data") and 5-beam decoding give JAX's tokens;
  * ``evaluate_wer`` gives JAX's WER and ``refs_and_pred.txt``;
  * ``train_and_evaluate`` and a resume of it log the unsharded run's
    losses and WERs, and its checkpoints hold the unsharded weights;
  * a 51,865-token vocabulary over 2 ranks (an uneven shard) gives JAX's
    logits.

In-process tests hold ``param_specs`` to JAX's, name by name (``nn.Linear``'s
(out, in) against JAX's (in, out)), ``shard_decode_inputs``' padding and
``auto_mesh``'s cases to JAX's, and a world of one to the unsharded run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
from whisper_context_biasing_tpu.decode import beam_decode as jax_beam
from whisper_context_biasing_tpu.decode import greedy_decode as jax_greedy
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.whisper import encode_audio as jax_encode_audio
from whisper_context_biasing_tpu.models.whisper import forward as jax_forward
from whisper_context_biasing_tpu.models.whisper import precompute_cross_kv as jax_precompute_cross_kv
from whisper_context_biasing_tpu.models.whisper import quantize_cross_kv as jax_quantize_cross_kv
from whisper_context_biasing_tpu.parallel import auto_mesh as jax_auto_mesh
from whisper_context_biasing_tpu.parallel import param_specs as jax_param_specs
from whisper_context_biasing_tpu.parallel import shard_decode_inputs as jax_shard_decode
from whisper_context_biasing_tpu.train import evaluate_wer as jax_evaluate_wer
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import make_train_step as jax_make_step
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    init_state_dict,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.parallel import (
    auto_mesh,
    make_mesh,
    param_specs,
    shard_decode_inputs,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import init_train_state, make_optimizer
from whisper_context_biasing_tpu_torch.train.checkpoint import _flatten
from whisper_context_biasing_tpu_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT_S = 300
LR = 1e-3
PAD = 50256
# as tests/test_torch_train.py: f32 both sides, sums in other orders
STEP_LOSS_RTOL = 1e-5
PARAM_ATOL = 0.1 * LR
LOGITS_ATOL = 1e-4
TRAIN_KERNELS = dict(flash_attention=True, flash_decoder_min_seq=0, fused_ln_qkv=True,
                     fused_ln_mlp=True)
DECODE_KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
# the fine-tune: tests/test_torch_loop.py's (batch 2: one row a rank of
# "data"; 6 steps, evals at 3 and 6, saves every 2, the best loaded at the
# end), then a resume to 8 steps
LOOP = dict(n_audio_layers=1, n_text_layers=1, d_model=16, n_heads=2, fused_ln_qkv=True,
            fused_ln_mlp=True)
LOOP_TCFG = dict(per_device_train_batch_size=2, per_device_eval_batch_size=2,
                 gradient_accumulation_steps=1, eval_steps=3, save_steps=2, logging_steps=1,
                 warmup_steps=0, generation_max_length=4, early_stopping_patience=50,
                 save_total_limit=10, dataloader_num_workers=1)

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
from whisper_context_biasing_tpu_torch.decode import beam_decode, greedy_decode
from whisper_context_biasing_tpu_torch.models import (build_model, params_from_jax,
                                                      state_dict_to_jax, tiny_test_config)
from whisper_context_biasing_tpu_torch.models.whisper import forward
from whisper_context_biasing_tpu_torch.parallel import (gather_params, make_mesh,
                                                        shard_batch, shard_params)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import (evaluate_wer, init_train_state,
                                                     make_optimizer)
from whisper_context_biasing_tpu_torch.train.checkpoint import _flatten, _unflatten
from whisper_context_biasing_tpu_torch.train.step import make_train_step

spec = json.load(open(f"{workdir}/spec.json"))
z = np.load(f"{workdir}/inputs.npz")
arrays = {k: z[k] for k in z.files}
tree = _unflatten({k[7:]: v for k, v in arrays.items() if k.startswith("params/")})
mesh = make_mesh(2)
out = {}

for name, over, accum in (("fused", spec["train_kernels"], 1), ("accum2", {}, 2)):
    cfg = tiny_test_config(**over)
    model = shard_params(build_model(cfg, params_from_jax(tree, cfg), device="cpu",
                                     train=True), mesh)
    opt = make_optimizer(peak_lr=spec["lr"], warmup_steps=0, total_steps=100)
    batch = {k.split("/")[1]: v for k, v in arrays.items() if k.startswith(f"{name}/")}
    state, m = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=accum, mesh=mesh)(
        init_train_state(model, opt),
        shard_batch(batch, mesh, extra_leading_axes=1 if accum > 1 else 0))
    full = _flatten(state_dict_to_jax(gather_params(model), cfg))
    out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "param_sum": float(sum(np.abs(v).sum() for v in full.values()))}
    if rank == 0:
        np.savez(f"{workdir}/params_{name}.npz", **full)

cfg = tiny_test_config(**spec["decode_kernels"])
model = shard_params(build_model(cfg, params_from_jax(tree, cfg), device="cpu"), mesh)
kw = dict(max_new=spec["max_new"], eot_id=spec["eot"], device="cpu", mesh=mesh)
g = greedy_decode(model, arrays["mel"], arrays["ids"], arrays["mask"],
                  bias_spans=arrays["spans"], bias_boost=1.5, span_pad_id=50256, **kw)
out["greedy"] = g.tokens.tolist()
out["greedy_lengths"] = g.lengths.tolist()
b = beam_decode(model, arrays["mel"], arrays["ids"], arrays["mask"], num_beams=5, **kw)
out["beam"] = b.best.tolist()
# the int8 cross-K/V: the scales are the amax over all of D (over "model")
from whisper_context_biasing_tpu_torch.models.whisper import (encode_audio, precompute_cross_kv,
                                                              quantize_cross_kv)
with torch.no_grad():
    q = quantize_cross_kv(precompute_cross_kv(model, encode_audio(
        model, torch.from_numpy(arrays["mel"]))), tp=model.tp)
np.savez(f"{workdir}/cross_kv_{rank}.npz", **{k: v.numpy() for k, v in q.items()})

tok = load_tokenizer()
coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                             bias_span_pad_id=tok.eot)
items = [{"input_features": f, "labels": arrays["eval_labels"][i], "bias_spans": []}
         for i, f in enumerate(arrays["eval_feats"])]
res = evaluate_wer(model, tok, items, coll, 2, 5, refs_pred_file=f"{workdir}/refs_port.txt",
                   num_workers=1, mesh=mesh)
out["wer"] = res["wer"]

from whisper_context_biasing_tpu_torch.train import TrainingConfig, train_and_evaluate
cfg = tiny_test_config(**spec["loop"])
ltree = _unflatten({k[5:]: v for k, v in arrays.items() if k.startswith("loop/")})
loop_items = [{"input_features": f, "labels": arrays["eval_labels"][0], "bias_spans": []}
              for f in arrays["loop_feats"]]
coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                             decoder_prev_token_id=tok.sop)
for epochs, resume in ((3, False), (4, True)):
    tcfg = TrainingConfig(output_dir=f"{workdir}/loop", num_train_epochs=epochs,
                          **spec["loop_tcfg"])
    _, hist = train_and_evaluate(cfg, params_from_jax(ltree, cfg), tok, loop_items,
                                 loop_items, coll, tcfg, resume=resume, mesh=mesh,
                                 device="cpu")
out["loop_history"] = hist

cfg = tiny_test_config(n_vocab=51865)
vtree = _unflatten({k[6:]: v for k, v in arrays.items() if k.startswith("vocab/")})
model = shard_params(build_model(cfg, params_from_jax(vtree, cfg), device="cpu"), mesh)
with torch.no_grad():
    logits = forward(model, torch.from_numpy(arrays["mel"][:2]),
                     torch.from_numpy(arrays["vocab_ids"]))
out["vocab_shard_rows"] = int(model.decoder.token_emb.shape[0])
if rank == 0:
    np.save(f"{workdir}/logits.npy", logits.numpy())
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


def _train_batch(seed, rows=4, label_len=24, accum=1):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(rows):
        ctx = list(rng.integers(100, 5000, 3 + i))
        text = list(rng.integers(100, 5000, label_len - len(ctx) - 3 - i))
        items.append({
            "input_features": (rng.standard_normal((80, 128)) * 0.5).astype(np.float32),
            "labels": [50360, *ctx, 50257, *text, 50256],
            "bias_spans": [text[2:4], list(rng.integers(100, 5000, 2))],
        })
    coll = SpeechSeq2SeqCollator(pad_token_id=PAD, decoder_start_token_id=50257,
                                 decoder_prev_token_id=50360, max_target_length=label_len)
    batch = coll(items)
    if accum > 1:
        batch = {k: v.reshape(accum, rows // accum, *v.shape[1:]) for k, v in batch.items()}
    return batch


def _jax_step(params, batch, accum):
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=100)
    jopt = jax_make_optimizer(**kw)
    jstep = jax_make_step(jax_tiny(), jopt, bias_weight=1.5, grad_accum=accum, donate=False)
    state, m = jstep(jax_init_state(params, jopt), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _flatten(jax.tree.map(np.asarray, state.params))}


def _unsharded_loop(params, feats, labels, tok, out):
    """The worker's two train_and_evaluate calls (3 epochs, then a resume to
    4) on one device."""
    from whisper_context_biasing_tpu_torch.train import TrainingConfig, train_and_evaluate

    cfg = tiny_test_config(**LOOP)
    items = [{"input_features": f, "labels": labels, "bias_spans": []} for f in feats]
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop)
    for epochs, resume in ((3, False), (4, True)):
        tcfg = TrainingConfig(output_dir=str(out), num_train_epochs=epochs, **LOOP_TCFG)
        _, hist = train_and_evaluate(cfg, params_from_jax(params, cfg), tok, items, items,
                                     coll, tcfg, resume=resume, device="cpu")
    return hist


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawn: inputs written, 4 ranks started, the JAX references
    computed while they run, then every rank's results."""
    workdir = tmp_path_factory.mktemp("world")
    tok = load_tokenizer()
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    vparams = jax.tree.map(np.asarray, jax_init(jax_tiny(n_vocab=51865), 1))

    rng = np.random.default_rng(7)
    mel = (rng.standard_normal((5, 80, 128)) * 0.5).astype(np.float32)
    prefixes = [[tok.sop, 71, 72, 73, tok.sot], [tok.sot], [tok.sop, 90, tok.sot], [tok.sot],
                [tok.sot]]
    ids, mask = pack_prefixes(prefixes, PAD)
    spans = np.full((5, 2, 3), PAD, np.int32)
    spans[::2, 0, :2] = [300, 301]  # rows 0, 2 and 4 biased
    # the end token: a token the unsharded biased decode first emits at
    # different steps in different rows, so the rows (and the ranks of
    # "data") stop at different steps
    cfg = tiny_test_config(**DECODE_KERNELS)
    plain = greedy_decode(build_model(cfg, params_from_jax(params, cfg), device="cpu"), mel,
                          ids, mask, max_new=12, eot_id=PAD, bias_spans=spans, bias_boost=1.5,
                          device="cpu").tokens.numpy()
    firsts = {}
    for row in plain:
        for t in set(row.tolist()):
            firsts.setdefault(t, []).append(row.tolist().index(t))
    eot = max(firsts, key=lambda t: (len(set(firsts[t])), len(firsts[t])))
    eval_rng = np.random.default_rng(4)
    eval_feats = (eval_rng.standard_normal((5, 80, 128)) * 0.4).astype(np.float32)
    eval_labels = np.asarray([[tok.sot, 5 + i, 6, tok.eot] for i in range(5)], np.int32)
    vocab_ids = np.asarray([[50257, 3, 25932, 25933, 51864, 40000],
                            [50257, 51863, 9, 25934, 1, 2]], np.int64)
    batches = {"fused": _train_batch(0), "accum2": _train_batch(1, accum=2)}
    lparams = jax.tree.map(np.asarray, jax_init(jax_tiny(**LOOP), 0))
    loop_feats = (np.random.default_rng(0).standard_normal((4, 80, 128)) * 0.3).astype(
        np.float32)
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    arrays.update({f"vocab/{k}": v for k, v in _flatten(vparams).items()})
    arrays.update({f"loop/{k}": v for k, v in _flatten(lparams).items()})
    arrays.update({f"{n}/{k}": v for n, b in batches.items() for k, v in b.items()})
    arrays.update(mel=mel, ids=ids, mask=mask, spans=spans, eval_feats=eval_feats,
                  eval_labels=eval_labels, vocab_ids=vocab_ids, loop_feats=loop_feats)
    np.savez(workdir / "inputs.npz", **arrays)
    spec = dict(lr=LR, max_new=12, eot=int(eot), train_kernels=TRAIN_KERNELS,
                decode_kernels=DECODE_KERNELS, loop=LOOP, loop_tcfg=LOOP_TCFG)
    (workdir / "spec.json").write_text(json.dumps(spec))
    (workdir / "worker.py").write_text(WORKER)

    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(workdir / "worker.py"), str(r), str(workdir)],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        ref = {"fused": _jax_step(params, batches["fused"], 1),
               "accum2": _jax_step(params, batches["accum2"], 2)}
        jcfg = jax_tiny(quantize_cross_kv=True)
        jargs = (params, jcfg, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask))
        g = jax_greedy(*jargs, max_new=12, eot_id=int(eot), bias_spans=jnp.asarray(spans),
                       bias_boost=1.5, span_pad_id=PAD)
        ref["greedy"] = np.asarray(g.tokens).tolist()
        ref["greedy_lengths"] = np.asarray(g.lengths).tolist()
        ref["beam"] = np.asarray(jax_beam(*jargs, num_beams=5, max_new=12,
                                          eot_id=int(eot)).best).tolist()
        ref["cross_kv"] = {k: np.asarray(v) for k, v in jax_quantize_cross_kv(
            jax_precompute_cross_kv(params, jcfg, jax_encode_audio(params, jcfg,
                                                                   jnp.asarray(mel)))).items()}
        coll = JaxCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                           bias_span_pad_id=tok.eot)
        items = [{"input_features": f, "labels": eval_labels[i], "bias_spans": []}
                 for i, f in enumerate(eval_feats)]
        ref["wer"] = jax_evaluate_wer(params, jcfg, tok, items, coll, 2, 5,
                                      refs_pred_file=str(workdir / "refs_jax.txt"),
                                      num_workers=1)["wer"]
        ref["logits"] = np.asarray(jax_forward(vparams, jax_tiny(n_vocab=51865),
                                               jnp.asarray(mel[:2]), jnp.asarray(vocab_ids)))
        ref["loop"] = _unsharded_loop(lparams, loop_feats, eval_labels[0], tok,
                                      workdir / "loop_ref")
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
    return dict(workdir=workdir, ref=ref, ranks=ranks, eot=eot, plain=plain)


@pytest.mark.parametrize("name", ["fused", "accum2"])
def test_train_step_matches_jax(world, name):
    ref = world["ref"][name]
    for r in world["ranks"]:
        assert r[name]["loss"] == pytest.approx(ref["loss"], rel=STEP_LOSS_RTOL)
        assert r[name]["grad_norm"] == pytest.approx(ref["grad_norm"], rel=STEP_LOSS_RTOL)
        # every rank holds the same whole model after the gather
        assert r[name]["param_sum"] == world["ranks"][0][name]["param_sum"]
    with np.load(world["workdir"] / f"params_{name}.npz") as z:
        assert set(z.files) == set(ref["params"])
        for k in z.files:
            np.testing.assert_allclose(z[k], ref["params"][k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("what", ["greedy", "greedy_lengths", "beam"])
def test_decode_matches_jax(world, what):
    for r in world["ranks"]:
        assert r[what] == world["ref"][what]
    if what == "greedy_lengths":  # the rows stopped at different steps
        assert len(set(r[what])) > 1 and min(r[what]) < 12


def test_int8_cross_kv_matches_jax(world):
    """Each rank's int8 K/V are JAX's columns of its heads, with JAX's
    scales: the amax is over all of D, taken over "model"."""
    ref = world["ref"]["cross_kv"]
    d = ref["k_q"].shape[-1] // 2
    for r in range(WORLD):
        with np.load(world["workdir"] / f"cross_kv_{r}.npz") as z:
            for k in ("k_s", "v_s"):
                np.testing.assert_allclose(z[k], ref[k], rtol=1e-5, atol=0, err_msg=k)
            cols = slice((r % 2) * d, (r % 2 + 1) * d)  # rank r: model index r % 2
            for k in ("k_q", "v_q"):
                # f32 K/V summed in another order: a value on a rounding
                # boundary may land one step off
                diff = np.abs(z[k].astype(np.int32) - ref[k][..., cols].astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k


def test_evaluate_wer_matches_jax(world):
    assert [r["wer"] for r in world["ranks"]] == [world["ref"]["wer"]] * WORLD
    port = (world["workdir"] / "refs_port.txt").read_text()
    assert port == (world["workdir"] / "refs_jax.txt").read_text()
    assert port.count("Ref :") == 5


def test_train_and_evaluate_matches_unsharded(world):
    """The sharded fine-tune and its resume log the unsharded run's losses
    and WERs, and rank 0's checkpoints (gathered whole) hold its weights and
    Adam moments."""
    from whisper_context_biasing_tpu_torch.train import load_checkpoint

    want = world["ref"]["loop"]
    for r in world["ranks"]:
        got = r["loop_history"]
        assert [e["step"] for e in got] == [e["step"] for e in want]
        assert [e["step"] for e in got][-3:] == [6, 7, 8]
        for g, w in zip(got, want):
            assert g.get("eval_wer") == w.get("eval_wer")
            if "loss" in w:
                assert g["loss"] == pytest.approx(w["loss"], rel=STEP_LOSS_RTOL)
    cfg = tiny_test_config(**LOOP)
    sd, opt, meta = load_checkpoint(str(world["workdir"] / "loop" / "checkpoint-8"), cfg,
                                    load_opt_state=True)
    rsd, ropt, rmeta = load_checkpoint(str(world["workdir"] / "loop_ref" / "checkpoint-8"), cfg,
                                       load_opt_state=True)
    assert meta["step"] == rmeta["step"] == 8 and opt.count == ropt.count == 8
    for k in rsd:
        torch.testing.assert_close(sd[k], rsd[k], atol=PARAM_ATOL, rtol=0, msg=k)
    for a, b in zip(opt.mu + opt.nu, ropt.mu + ropt.nu):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


def test_uneven_vocab_matches_jax(world):
    # 51,865 rows over 2 ranks: shards of 25,933, the last padded by one row
    assert {r["vocab_shard_rows"] for r in world["ranks"]} == {25933}
    got = np.load(world["workdir"] / "logits.npy")
    assert got.shape == world["ref"]["logits"].shape == (2, 6, 51865)
    np.testing.assert_allclose(got, world["ref"]["logits"], atol=LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------

_LINEAR = {"query", "key", "value", "out", "fc1", "fc2"}


def test_param_specs_match_jax():
    """Each port tensor is split over "model" along the dim JAX's spec names
    for it, with a linear weight's (out, in) against JAX's (in, out)."""
    cfg = tiny_test_config()
    sd = {n: torch.full(t.shape, float(i)) for i, (n, t) in
          enumerate(init_state_dict(cfg, 0).items())}
    names = list(sd)
    specs = param_specs(sd)
    tree = state_dict_to_jax(sd, cfg)
    jspecs = jax_param_specs(tree)
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        jspec = jspecs
        for k in path:
            jspec = jspec[k.key]
        dims = tuple(jspec) + (None,) * (leaf.ndim - len(tuple(jspec)))
        stacked = path[0].key in ("encoder", "decoder") and path[1].key not in (
            "token_emb", "pos_emb", "ln", "ln_post", "conv1", "conv2")
        layers = leaf if stacked else leaf[None]
        jdims = dims[1:] if stacked else dims
        jdim = jdims.index("model") if "model" in jdims else None
        for layer in layers:
            name = names[int(np.asarray(layer).flat[0])]
            seen.add(name)
            placement = specs[name][1]
            got = placement.dim if placement.is_shard() else None
            want = jdim
            parts = name.split(".")
            if want is not None and parts[-1] == "weight" and parts[-2] in _LINEAR:
                want = 1 - want
            assert got == want, (name, got, want)
            assert specs[name][0].is_replicate()
    assert seen == set(names)


class _FakeMesh:
    """The part of a DeviceMesh that the data-axis helpers read: a rank at
    ``index`` of a data axis of ``size``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, size, index):
        self._size, self._index = size, index

    def size(self, dim):
        return self._size if dim == 0 else 1

    def get_local_rank(self, name):
        return self._index if name == "data" else 0


@pytest.mark.parametrize("b,dp", [(5, 2), (3, 4), (8, 4), (2, 1)])
def test_shard_decode_inputs_padding_matches_jax(b, dp):
    rng = np.random.default_rng(b)
    feats = rng.standard_normal((b, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, (b, 2))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:dp]).reshape(dp, 1),
                              ("data", "model"))
    (jf, ji, jn), jb = jax_shard_decode(jmesh, feats, ids, None)
    parts = [shard_decode_inputs(_FakeMesh(dp, r), feats, torch.from_numpy(ids), None)
             for r in range(dp)]
    assert {p[1] for p in parts} == {jb} == {b}
    assert all(p[0][2] is None for p in parts) and jn is None
    np.testing.assert_array_equal(np.concatenate([p[0][0] for p in parts]), np.asarray(jf))
    np.testing.assert_array_equal(torch.cat([p[0][1] for p in parts]).numpy(), np.asarray(ji))
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        shard_decode_inputs(_FakeMesh(dp, 0), feats, ids[:1])


@pytest.mark.parametrize("case", ["off", "one_device", "tp_on_one", "uneven_tp",
                                  "batch_divisor"])
def test_auto_mesh_cases(case):
    """0 and 1 on one device give no mesh, as JAX's do; a model axis that
    does not divide the devices raises JAX's ValueError; a data axis that
    does not divide the batch raises here (JAX shrinks it; both name the
    largest that divides)."""
    cpus = jax.devices("cpu")
    if case == "off":
        assert auto_mesh(0) is None and jax_auto_mesh(0) is None
    elif case == "one_device":
        assert auto_mesh(1) is None and jax_auto_mesh(1, devices=cpus[:1]) is None
    elif case == "tp_on_one":
        with pytest.raises(ValueError) as port:
            auto_mesh(2)
        with pytest.raises(ValueError) as ref:
            jax_auto_mesh(2, devices=cpus[:1])
        assert str(port.value) == str(ref.value) == \
            "1 devices not divisible by model_parallelism=2"
    elif case == "uneven_tp":
        with pytest.raises(ValueError) as port:
            auto_mesh(2, devices=[0, 1, 2])
        with pytest.raises(ValueError) as ref:
            jax_auto_mesh(2, devices=cpus[:3])
        assert str(port.value) == str(ref.value)
    else:
        with pytest.raises(ValueError, match=r"data=3\)"):
            auto_mesh(1, devices=[0, 1, 2, 3], batch_divisor=6)
        assert jax_auto_mesh(1, devices=cpus[:4], batch_divisor=6).shape["data"] == 3


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_world_of_one_matches_unsharded(world_of_one):
    """A (1, 1) mesh: the same training step and tokens as no mesh."""
    mesh = world_of_one
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    cfg = tiny_test_config()
    out = []
    for m in (None, mesh):
        model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
        opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=10)
        _, metrics = make_train_step(cfg, opt, mesh=m)(init_train_state(model, opt),
                                                      _train_batch(2))
        mel = np.random.default_rng(3).standard_normal((3, 80, 128)).astype(np.float32)
        ids, mask = np.full((3, 1), 50257), np.ones((3, 1), bool)
        toks = greedy_decode(model, mel, ids, mask, max_new=5, device="cpu", mesh=m).tokens
        out.append((float(metrics["loss"]), toks))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
