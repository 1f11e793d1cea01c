"""The plain reference against the port at a tiny configuration on the
CPU, in float32: the model, the log-mel frontend, the bias trie, the
WeightCE loss and AdamW."""

import numpy as np
import pytest
import torch

from core import reference, traffic
from core.weights import make_weights, to_port
from tiny import PORT, tiny_spec

from whisper_context_biasing_tpu_torch.audio.mel import log_mel_spectrogram
from whisper_context_biasing_tpu_torch.decode.bias_processor import (
    advance_bias_state, bias_bonus, init_bias_state)
from whisper_context_biasing_tpu_torch.decode.greedy import greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models.config import get_config
from whisper_context_biasing_tpu_torch.models.convert import build_model
from whisper_context_biasing_tpu_torch.models.whisper import decode_tokens, encode_audio
from whisper_context_biasing_tpu_torch.train.loss import weighted_ce_loss
from whisper_context_biasing_tpu_torch.train.optim import AdamW

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    spec = tiny_spec("serve.base.en.biased32")
    g = spec["g"]
    w, _ = make_weights(g, 77, "cpu", torch.float32)
    cfg = get_config("base.en", dtype="float32", **PORT)
    model = build_model(cfg, to_port(w), device="cpu")
    return spec, g, w, model


def test_model_matches_the_port_in_float32(tiny):
    spec, g, w, model = tiny
    ref = reference.Reference(w, g)
    mel = torch.randn(2, g["n_mels"], 2 * g["t_audio"], generator=torch.Generator().manual_seed(1))
    enc_port = encode_audio(model, mel)
    enc_ref = ref.encode(mel)
    assert torch.allclose(enc_port, enc_ref, atol=2e-4, rtol=1e-4)
    ids = torch.randint(0, 50256, (2, 11), generator=torch.Generator().manual_seed(2))
    lg_port, _ = decode_tokens(model, ids, enc_out=enc_port)
    lg_ref = ref.logits(ids, enc_ref)
    assert torch.allclose(lg_port, lg_ref, atol=2e-4, rtol=1e-4)


def test_log_mel_matches_the_port():
    audio = torch.from_numpy(traffic.audio_clip(5, 0, 0, 20480, 0.1))[None]
    audio[:, 15000:] = 0.0
    got = reference.log_mel(audio, 80)
    want = log_mel_spectrogram(audio, 80)
    assert got.shape == want.shape == (1, 80, 128)
    assert float((got - want).abs().max()) < 1e-4


def test_trie_boosts_what_the_port_boosts():
    rng = np.random.default_rng(3)
    words = [[5, 6, 7], [5, 9], [11], [6, 6, 8]]
    spans = torch.from_numpy(traffic.dense_spans([words], 50256)).int()
    state = init_bias_state(spans, 50256)
    trie = reference.Trie(words)
    for tok in rng.choice([5, 6, 7, 8, 9, 11, 12], 200):
        bonus = bias_bonus(state, spans, 64, 2.0)[0]
        assert set(torch.nonzero(bonus).flatten().tolist()) == trie.boosted()
        state = advance_bias_state(state, spans, torch.tensor([int(tok)]))
        trie.advance(int(tok))


def test_served_tokens_of_the_port_have_no_gap_in_float32(tiny):
    spec, g, w, model = tiny
    tok = spec["config"]["tokens"]
    rng = np.random.default_rng(4)
    prefixes = [[tok["sop"]] + [int(x) for x in rng.integers(0, 50256, n)] + tok["prompt_start"]
                for n in (3, 6)]
    words = [[[int(x) for x in rng.integers(0, 50256, 2)]] * 2, [[7], [8, 9]]]
    ids, mask = pack_prefixes(prefixes, tok["eot"])
    mel = torch.randn(2, g["n_mels"], 2 * g["t_audio"], generator=torch.Generator().manual_seed(5))
    res = greedy_decode(model, mel, ids, mask, max_new=12, eot_id=tok["eot"],
                        bias_spans=traffic.dense_spans(words, tok["eot"]), bias_boost=2.0,
                        span_pad_id=tok["eot"], forced_eot_at=np.array([12, 12]), device="cpu")
    ref = reference.Reference(w, g)
    for i in range(2):
        served = res.tokens[i, :int(res.lengths[i])].tolist()
        seq = prefixes[i] + served[:-1]
        lg = ref.logits(torch.tensor([seq]), ref.encode(mel[i:i + 1]))[0, len(prefixes[i]) - 1:]
        gaps = reference.served_gaps(lg, served, prefixes[i], words[i], 2.0)
        assert len(gaps) == len(served) and float(gaps.max()) < 1e-4


def test_weightce_and_adamw_match_the_port():
    rng = np.random.default_rng(6)
    labels = [[50360, 3, 4, 50257, 10, 11, 12, 11, 12, 50256], [50360, 5, 50257, 20, 21, 50256]]
    spans = [[[11, 12], [10]], [[21]]]
    inp, tgt = reference.collate_labels(labels, 50257, 50256)
    lg = torch.from_numpy(rng.standard_normal((2, inp.shape[1], 50300)).astype(np.float32))
    want = weighted_ce_loss(lg, torch.from_numpy(tgt), torch.from_numpy(
        traffic.dense_spans(spans, 50256)), 1.5)
    count = float((tgt != reference.IGNORE).sum())
    wts = torch.from_numpy(np.stack([reference.span_weights(tgt[i], spans[i], 1.5, 50256)
                                     for i in range(2)]))
    nll = torch.nn.functional.cross_entropy(lg.flatten(0, 1), torch.from_numpy(tgt).flatten(),
                                            ignore_index=-100, reduction="none").view(2, -1)
    got = (nll * wts).sum() / (count + 1e-8)
    assert float(abs(got - want)) < 1e-5 * float(want)
    assert tgt[0].tolist()[:3] == [-100, -100, 50257]

    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in (("a", (4, 3)), ("b", (5,)))}
    grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for n, p in params.items()}
    port = [p.clone() for p in params.values()]
    opt = AdamW(lambda c: 1e-3, weight_decay=0.01, max_grad_norm=1.0)
    st = opt.init(port)
    ref = reference.AdamW({n: p.clone() for n, p in params.items()}, 1e-3, (0.9, 0.999), 1e-8,
                          0.01, 1.0)
    for _ in range(3):
        opt.update_(port, list(grads.values()), st)
        ref.step(grads)
    for p, r in zip(port, ref.p.values()):
        assert torch.allclose(p, r, atol=1e-7, rtol=1e-6)
