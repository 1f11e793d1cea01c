"""Port parity for Medusa: ``medusa_greedy_decode`` and ``medusa_decode_batch``
against the JAX package's and the port's own ``greedy_decode``, in the cases
of the JAX package's ``tests/test_medusa.py`` (by name): untrained heads,
bias-boosted decoding, ragged prefixes with the logprob, trained heads,
int8 cross-K/V at 1 and 2 chains, chains with bias, the second chain's
rescue of a corrupted head, long-form and chunked; the heads
(``medusa_logits``, the npz layout read across packages, ``split_medusa``);
the training step and the runner; and ``evaluate_wer(medusa=)``.

Both packages run ``tiny_test_config`` with int8 cross-K/V (the port with
the serving kernel switches on: their plain versions on CPU tensors) and
the same head tensors. Tolerances (f32): tokens, lengths and
``spec_rounds`` identical; ``sum_logprob`` within 1e-5 or 1e-6 relative (as
in test_torch_speculative.py); logits within 1e-5; one training step's
loss, head accuracies and new head tensors within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.decode.medusa import medusa_decode_batch as jax_medusa_batch
from whisper_context_biasing_tpu.decode.medusa import medusa_greedy_decode as jax_medusa
from whisper_context_biasing_tpu.models import init_medusa_params as jax_init_medusa
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import medusa_logits as jax_medusa_logits
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.decode import (
    greedy_decode,
    medusa_decode_batch,
    medusa_greedy_decode,
    pack_prefixes,
)
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    init_medusa_params,
    load_medusa,
    medusa_logits,
    params_from_jax,
    save_medusa,
    split_medusa,
    tiny_test_config,
)

EOT = 50256
Q = dict(quantize_cross_kv=True)
KERNELS = dict(flash_attention=True, fused_quant_cross=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: the test workers run side
    by side, and more threads a worker only contend for the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(**Q)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**Q, **KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = (np.random.default_rng(0).standard_normal((3, 80, 128)) * 0.5).astype(np.float32)
    return jcfg, params, model, mel


def heads(jcfg, k, seed):
    """The JAX package's init (numpy) and the same heads as port tensors."""
    md = jax.tree.map(np.asarray, jax_init_medusa(jcfg, k, seed))
    return md, {n: torch.from_numpy(np.array(v)) for n, v in md.items()}


def _spans():
    spans = np.full((3, 2, 3), EOT, np.int32)
    spans[:, 0, :2] = [500, 501]
    return spans


def oracle_heads(model, mel, ids, mask, ref_tokens, base):
    """Heads fitted on the model's own continuation of this input (Adam on
    the hidden states of the prefix + greedy tokens): head j at t predicts
    seq[t + 1 + j]."""
    from whisper_context_biasing_tpu_torch.models import decode_tokens, encode_audio

    with torch.no_grad():
        seq = torch.cat([torch.as_tensor(ids, dtype=torch.int64),
                         torch.as_tensor(ref_tokens, dtype=torch.int64)], dim=1)
        _, _, hid = decode_tokens(model, seq, enc_out=encode_audio(model, torch.as_tensor(mel)),
                                  return_hidden=True)
    s = seq.shape[1]
    md = {n: t.clone().requires_grad_(True) for n, t in base.items()}
    opt = torch.optim.Adam(list(md.values()), lr=3e-2)
    for _ in range(30):
        lg = medusa_logits(model, md, hid)
        loss = sum(torch.nn.functional.cross_entropy(
            lg[j - 1][:, : s - 1 - j].reshape(-1, lg.shape[-1]), seq[:, 1 + j:].reshape(-1))
            for j in (1, 2))
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {n: t.detach() for n, t in md.items()}


# name -> (prefixes, heads (k, seed), decode kwargs); names are the JAX tests'
CASES = {
    "untrained_heads_match_greedy": ([[50257]] * 3, (3, 0), dict(max_new=12)),
    "bias_boost_exactness": ([[50257]] * 3, (2, 1), dict(max_new=10, bias=2.0)),
    "ragged_prefixes_and_logprob_parity": (
        [[50257], [50361, 99, 100, 50257], [50361, 7, 50257]], (2, 2), dict(max_new=8)),
    "trained_heads_accelerate_and_stay_exact": ([[50257]] * 3, (2, 3),
                                                dict(max_new=12, oracle=True)),
    "quantized_cross_kv_matches_quantized_greedy-s1": ([[50257]] * 3, (2, 5),
                                                       dict(max_new=9, n_chains=1)),
    "quantized_cross_kv_matches_quantized_greedy-s2": ([[50257]] * 3, (2, 5),
                                                       dict(max_new=9, n_chains=2)),
    "chains_match_greedy_untrained-s2": (
        [[50257], [50361, 99, 100, 50257], [50361, 7, 50257]], (2, 4),
        dict(max_new=10, bias=2.0, n_chains=2)),
    "chains_match_greedy_untrained-s3": (
        [[50257], [50361, 99, 100, 50257], [50361, 7, 50257]], (2, 4),
        dict(max_new=10, bias=2.0, n_chains=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_medusa_matches_jax_and_greedy(setup, name):
    jcfg, params, model, mel = setup
    prefixes, (k, seed), kw = CASES[name]
    kw = dict(kw)
    ids, mask = pack_prefixes(prefixes, EOT)
    common = dict(max_new=kw.pop("max_new"))
    boost = kw.pop("bias", 0.0)
    if boost:
        common.update(bias_spans=_spans(), bias_boost=boost)
    n_chains = kw.pop("n_chains", 1)
    jmd, md = heads(jcfg, k, seed)
    plain = greedy_decode(model, mel, ids, mask, device="cpu", **common)
    untrained = None
    if kw.pop("oracle", False):
        untrained = medusa_greedy_decode(model, md, mel, ids, mask, device="cpu", **common)
        md = oracle_heads(model, mel, ids, mask, plain.tokens, md)
        jmd = {n: t.numpy() for n, t in md.items()}
    jax_kw = dict(common, bias_spans=jnp.asarray(_spans()) if boost else None)
    ref = jax_medusa(params, jcfg, jax.tree.map(jnp.asarray, jmd), jnp.asarray(mel),
                     jnp.asarray(ids), jnp.asarray(mask), n_chains=n_chains, **jax_kw)
    got = medusa_greedy_decode(model, md, mel, ids, mask, n_chains=n_chains, device="cpu",
                               **common)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert got.spec_rounds == int(ref.spec_rounds) >= 1
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), plain.lengths.numpy())
    for want in (np.asarray(ref.sum_logprob), plain.sum_logprob.numpy()):
        np.testing.assert_allclose(got.sum_logprob.numpy(), want, atol=1e-5, rtol=1e-6)
    if untrained is not None:
        # trained heads never hurt, and accelerate: fewer rounds than tokens
        assert got.spec_rounds <= untrained.spec_rounds
        assert got.spec_rounds < int(got.lengths.max())


def test_second_chain_rescues_corrupted_head(setup, monkeypatch):
    """Head 1's top-1 and top-2 logits swapped: chain 0 proposes the wrong
    token where the head was right, chain 1 carries the right one, so 2
    chains finish in fewer rounds than 1 and still give greedy's tokens
    (the relocated slots of a best chain other than 0 are the ones later
    rounds attend to)."""
    import whisper_context_biasing_tpu_torch.decode.medusa as dm
    from whisper_context_biasing_tpu_torch.decode.beam import top_k

    jcfg, _, model, mel = setup
    mel2 = mel[:2]
    ids, mask = pack_prefixes([[50257]] * 2, EOT)
    ref = greedy_decode(model, mel2, ids, mask, max_new=13, device="cpu")
    real = dm.medusa_logits

    def swapped(params_, md_, hidden_):
        lg = real(params_, md_, hidden_).clone()
        v2, i2 = top_k(lg[0].reshape(-1, lg.shape[-1]), 2)
        flat = lg[0].reshape(-1, lg.shape[-1])
        rows = torch.arange(flat.shape[0])
        flat[rows, i2[:, 0]], flat[rows, i2[:, 1]] = v2[:, 1], v2[:, 0]
        lg[0] = flat.reshape(lg[0].shape)
        return lg

    monkeypatch.setattr(dm, "medusa_logits", swapped)
    _, md = heads(jcfg, 2, 7)
    r1 = medusa_greedy_decode(model, md, mel2, ids, mask, max_new=13, n_chains=1, device="cpu")
    r2 = medusa_greedy_decode(model, md, mel2, ids, mask, max_new=13, n_chains=2, device="cpu")
    np.testing.assert_array_equal(r1.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(r2.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(r2.lengths.numpy(), ref.lengths.numpy())
    assert r2.spec_rounds < r1.spec_rounds


def test_medusa_decode_batch_matches_jax(setup):
    """The batch wrapper with a context, bias words and the npz-stamped
    chain width: the JAX wrapper's lists."""
    from whisper_context_biasing_tpu.tokenizer import load_tokenizer as jax_tokenizer
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    jcfg, params, model, mel = setup
    jmd, md = heads(jcfg, 2, 6)
    tok = load_tokenizer()
    kw = dict(contexts=[[71, 72], [], [73]], max_new=8, bias_spans=_spans(), bias_boost=2.0)
    want = jax_medusa_batch(params, jcfg, dict(jmd, n_chains=2), jax_tokenizer(), mel, **kw)
    got = medusa_decode_batch(model, dict(md, n_chains=2), tok, mel, device="cpu", **kw)
    assert got == want


def test_long_form_and_chunked_match_plain(setup):
    """``medusa=`` in both long-form loops gives the plain loops' tokens,
    which are the JAX package's plain tokens."""
    from test_torch_speculative import long_form_runs

    jcfg, params, model, _ = setup
    _, md = heads(jcfg, 2, 5)
    for route, (got, plain, want) in long_form_runs(model, jcfg, params, 6,
                                                    medusa=md).items():
        assert got == plain == want, route


def test_medusa_logits_match_jax_and_start_near_identity(setup):
    """(K, B, S, V) logits within 1e-5 of JAX's; near-zero heads give
    about the base projection."""
    from whisper_context_biasing_tpu_torch.models import project_vocab

    jcfg, params, model, _ = setup
    jmd, md = heads(jcfg, 3, 0)
    hid = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jax_medusa_logits(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, jmd), jnp.asarray(hid)))
    got = medusa_logits(model, md, torch.from_numpy(hid))
    assert got.shape == (3, 2, 5, 51864)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    base = project_vocab(model, torch.from_numpy(hid))
    np.testing.assert_allclose(got[0].numpy(), base.numpy(), atol=0.05)


def test_init_io_and_split(tmp_path):
    """The seeded init's shapes and scale; the npz round trip with
    ``n_chains`` across packages; ``split_medusa``; ``--medusa_chains``
    overriding the stamped width."""
    from whisper_context_biasing_tpu.models import load_medusa as jax_load
    from whisper_context_biasing_tpu.models import save_medusa as jax_save

    cfg = tiny_test_config()
    md = init_medusa_params(cfg, 4, 0)
    assert md["w"].shape == (4, 64, 64) and md["b"].shape == (4, 64)
    assert 5e-4 < float(md["w"].std()) < 2e-3 and not md["b"].any()
    torch.testing.assert_close(init_medusa_params(cfg, 4, 0)["w"], md["w"])
    heads_, n = split_medusa(md)
    assert n == 1 and set(heads_) == {"w", "b"}
    path = str(tmp_path / "m.npz")
    save_medusa(path, dict(md, n_chains=3))
    back = jax_load(path)
    assert back["n_chains"] == 3
    np.testing.assert_array_equal(np.asarray(back["w"]), md["w"].numpy())
    jax_save(str(tmp_path / "j.npz"), dict(back, n_chains=2))
    mine = load_medusa(str(tmp_path / "j.npz"))
    assert mine["n_chains"] == 2 and torch.equal(mine["w"], md["w"])
    assert load_medusa(path, n_chains=5)["n_chains"] == 5
    heads_, n = split_medusa(load_medusa(path))
    assert n == 3 and set(heads_) == {"w", "b"}


def _train_batch():
    rng = np.random.default_rng(0)
    b, s = 2, 12
    dec = rng.integers(0, 120, size=(b, s)).astype(np.int32)
    labels = np.concatenate([dec[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
    return {"input_features": rng.standard_normal((b, 80, 128)).astype(np.float32),
            "decoder_input_ids": dec, "labels": labels}


def test_expected_tokens_per_round():
    from whisper_context_biasing_tpu_torch.train import expected_tokens_per_round

    assert expected_tokens_per_round([0.0, 0.0]) == pytest.approx(1.0)
    assert expected_tokens_per_round([1.0, 1.0]) == pytest.approx(3.0)
    assert expected_tokens_per_round([0.5, 0.5]) == pytest.approx(1.75)


def test_train_step_matches_jax_and_accuracy_rises(setup):
    """One step: loss, head accuracies and the new head tensors within 1e-6
    of the JAX step's; then 20 steps lower the loss and raise the mean head
    accuracy (the JAX package's ``test_head_accuracy_rises``, which takes 60;
    here both move from the 15th)."""
    from whisper_context_biasing_tpu.train import init_train_state as jax_state
    from whisper_context_biasing_tpu.train import make_medusa_train_step as jax_step
    from whisper_context_biasing_tpu.train import make_optimizer as jax_optimizer
    from whisper_context_biasing_tpu_torch.train import (
        init_medusa_state,
        make_medusa_train_step,
        make_optimizer,
    )

    jcfg, params, model, _ = setup
    jmd, md = heads(jcfg, 2, 1)
    batch = _train_batch()
    jopt = jax_optimizer(peak_lr=5e-3, warmup_steps=0, total_steps=80)
    jst, jm = jax_step(jcfg, jopt, 2, donate=False)(
        jax_state(jax.tree.map(jnp.asarray, jmd), jopt), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch))
    opt = make_optimizer(peak_lr=5e-3, warmup_steps=0, total_steps=80)
    step = make_medusa_train_step(model.cfg, opt, 2, donate=False)
    st = init_medusa_state(md, opt)
    st, m = step(st, model, batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-6
    np.testing.assert_allclose(m["head_acc"].numpy(), np.asarray(jm["head_acc"]), atol=1e-6)
    for n in ("w", "b"):
        np.testing.assert_allclose(st.model[n].numpy(), np.asarray(jst.params[n]), atol=1e-6,
                                   rtol=0)
    first = m
    for _ in range(19):
        st, m = step(st, model, batch)
    assert float(m["loss"]) < float(first["loss"])
    assert float(m["head_acc"].mean()) > float(first["head_acc"].mean())


def test_runner_writes_artifacts(setup, tmp_path):
    """``train_medusa_heads`` writes medusa.npz and medusa_results.json."""
    import json

    from whisper_context_biasing_tpu_torch.train import MedusaConfig, train_medusa_heads

    jcfg, _, model, _ = setup
    _, md = heads(jcfg, 2, 1)
    rng = np.random.default_rng(3)

    class DS:
        def __init__(self, n):
            self.rows = []
            for _ in range(n):
                dec = rng.integers(0, 120, size=8).astype(np.int64)
                self.rows.append({"input_features":
                                  rng.standard_normal((80, 128)).astype(np.float32),
                                  "decoder_input_ids": dec,
                                  "labels": np.concatenate([dec[1:], [-100]])})

        def __len__(self):
            return len(self.rows)

        def __getitem__(self, i):
            return self.rows[i]

    def collate(rows):
        return {k: np.stack([r[k] for r in rows]).astype(
            np.int32 if k != "input_features" else np.float32) for k in rows[0]}

    mcfg = MedusaConfig(output_dir=str(tmp_path), n_heads=2, per_device_train_batch_size=2,
                        num_train_epochs=1, warmup_steps=0, eval_steps=2, logging_steps=1,
                        eval_batches=1, n_chains=2)
    out, hist = train_medusa_heads(model.cfg, model, md, DS(4), DS(2), collate, mcfg)
    summary = json.loads((tmp_path / "medusa_results.json").read_text())
    assert summary["n_heads"] == 2 and len(summary["eval_head_acc"]) == 2
    assert summary["eval_tokens_per_round"] >= 1.0 and hist[-1] == summary
    back = load_medusa(str(tmp_path / "medusa.npz"))
    assert torch.equal(back["w"], out["w"]) and back["n_chains"] == 2
    assert not torch.equal(back["w"], md["w"])  # the heads trained


def test_evaluate_wer_medusa_matches_jax(setup, tmp_path):
    """evaluate_wer(medusa=) at 2 chains: the JAX package's refs_and_pred.txt
    and WER, which are the plain evaluation's (5 items in batches of 2: the
    trailing partial batch is padded)."""
    from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
    from whisper_context_biasing_tpu.train import evaluate_wer as jax_evaluate_wer
    from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
    from whisper_context_biasing_tpu_torch.train import evaluate_wer

    jcfg, params, model, _ = setup
    tok = load_tokenizer()
    jmd, md = heads(jcfg, 2, 8)
    rng = np.random.default_rng(4)
    items = [{"input_features": (rng.standard_normal((80, 128)) * 0.4).astype(np.float32),
              "labels": np.asarray([tok.sot, 5 + i, 6, tok.eot], np.int32),
              "bias_spans": []} for i in range(5)]
    files, wers = [], []
    for pkg, coll_cls in (("jax", JaxCollator), ("port", SpeechSeq2SeqCollator),
                          ("plain", SpeechSeq2SeqCollator)):
        coll = coll_cls(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                        bias_span_pad_id=tok.eot)
        out = tmp_path / f"{pkg}.txt"
        kw = dict(refs_pred_file=str(out), num_workers=1)
        if pkg == "jax":
            res = jax_evaluate_wer(params, jcfg, tok, items, coll, 2, 6, medusa=dict(
                jax.tree.map(jnp.asarray, jmd), n_chains=2), **kw)
        else:
            res = evaluate_wer(model, tok, items, coll, 2, 6, **kw,
                               medusa=dict(md, n_chains=2) if pkg == "port" else None)
        files.append(out.read_text())
        wers.append(res["wer"])
    assert files[0] == files[1] == files[2] and files[0].count("Ref :") == 5
    assert wers[0] == wers[1] == wers[2]

