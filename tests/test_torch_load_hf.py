"""Port parity: HF checkpoints in and out (``models/load_hf.py``) and the
port's own safetensors reader and writer (``models/safetensors_io.py``).

The HF key set and values against a ``transformers`` model built locally
from a config; HF -> port -> HF is the identity; the port's HF state dict is
the JAX package's, key by key and bit for bit; files written by the JAX
package (``safetensors.numpy``) load in the port with the JAX model's logits
and greedy tokens; the two writers read each other's files; an untied
``proj_out`` survives the round trips; float64 parity with HF's torch
model; ``Pipeline(checkpoint=...)`` gives the JAX Pipeline's tokens. Nothing
is downloaded: every model is seeded."""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.decode import greedy_decode as jax_greedy
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import load_safetensors as jax_load_safetensors
from whisper_context_biasing_tpu.models import save_safetensors as jax_save_safetensors
from whisper_context_biasing_tpu.models import state_dict_from_params as jax_state_dict_from_params
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.whisper import decode_tokens as jax_decode_tokens
from whisper_context_biasing_tpu.models.whisper import encode_audio as jax_encode
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    config_from_state_dict,
    decode_tokens,
    encode_audio,
    get_config,
    init_state_dict,
    load_checkpoint_or_safetensors,
    load_pretrained,
    load_safetensors,
    load_torch_model,
    params_from_jax,
    params_from_state_dict,
    save_safetensors,
    state_dict_from_params,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.models.safetensors_io import (
    deserialize,
    read_safetensors,
    serialize,
    write_safetensors,
)

EOT = 50256


def _hf_config():
    """tests/test_export_hf.py's HF config: the tiny test config's dims."""
    transformers = pytest.importorskip("transformers")
    return transformers.WhisperConfig(
        vocab_size=51864, num_mel_bins=80, d_model=64,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=64, max_target_positions=448,
    )


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))


def _untied(params, seed=1):
    rng = np.random.default_rng(seed)
    p = dict(params)
    p["proj_out"] = (rng.standard_normal((51864, 64)) * 0.02).astype(np.float32)
    return p


def _mel(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 80, 128)).astype(np.float32)


def _logits_both(params, sd, toks):
    """f32 logits of the JAX model on ``params`` and of the port on ``sd``."""
    jcfg, cfg = jax_tiny(), tiny_test_config()
    mel = _mel()
    enc = jax_encode(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(mel))
    want, _ = jax_decode_tokens(jax.tree.map(jnp.asarray, params), jcfg,
                                jnp.asarray(toks, jnp.int32), enc_out=enc)
    model = build_model(cfg, sd, device="cpu")
    with torch.no_grad():
        got, _ = decode_tokens(model, torch.from_numpy(toks),
                               enc_out=encode_audio(model, torch.from_numpy(mel)))
    return got.numpy(), np.asarray(want), model


# ---------------------------------------------------------------------------
# the key map
# ---------------------------------------------------------------------------

def test_hf_key_set_matches_transformers_model():
    """Exported keys are exactly a WhisperForConditionalGeneration's, which
    loads them strictly and holds the same values (tests/test_export_hf.py)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(_hf_config()).eval()
    sd, cfg = load_torch_model(hf)
    out = state_dict_from_params(sd, cfg)
    assert set(out) == set(hf.state_dict())
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in out.items()}, strict=True)
    for k, v in hf.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), out[k])
    assert "proj_out" not in sd  # the HF model's head is tied


def test_hf_to_port_to_hf_is_identity():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    hf = {k: v.numpy() for k, v in
          transformers.WhisperForConditionalGeneration(_hf_config()).state_dict().items()}
    sd, cfg = params_from_state_dict(hf)
    back = state_dict_from_params(sd, cfg)
    assert back.keys() == hf.keys()
    for k in hf:
        assert back[k].dtype == np.float32 and back[k].flags.c_contiguous
        np.testing.assert_array_equal(back[k], hf[k], err_msg=k)


def test_state_dict_from_params_is_jax_bit_for_bit(jax_params):
    cfg = tiny_test_config()
    for params in (jax_params, _untied(jax_params)):
        want = jax_state_dict_from_params(params, jax_tiny())
        got = state_dict_from_params(params_from_jax(params, cfg), cfg)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_config_from_state_dict_reads_dims_and_contexts():
    cfg = get_config("base.en")
    long_ctx = tiny_test_config(n_text_ctx=512)
    sd = state_dict_from_params(init_state_dict(long_ctx), long_ctx)
    got = config_from_state_dict(sd)
    assert (got.d_model, got.n_heads, got.n_audio_layers, got.n_text_layers) == (64, 1, 2, 2)
    assert (got.n_audio_ctx, got.n_text_ctx, got.n_vocab) == (64, 512, 51864)
    assert not got.multilingual
    assert (cfg.head_dim, cfg.vocab_size, cfg.max_target_positions) == (64, 51864, 448)
    assert (cfg.decoder_start_token_id, cfg.eos_token_id) == (50257, 50256)
    multi = get_config("base")
    assert (multi.decoder_start_token_id, multi.eos_token_id) == (50258, 50257)


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------

def test_jax_safetensors_loads_in_port_with_jax_logits_and_tokens(jax_params, tmp_path):
    jax_save_safetensors(jax.tree.map(jnp.asarray, jax_params), jax_tiny(), str(tmp_path))
    sd, cfg = load_safetensors(str(tmp_path), tiny_test_config())
    assert cfg == tiny_test_config() and "proj_out" not in sd
    toks = np.random.default_rng(2).integers(0, 50000, (2, 10))
    got, want, model = _logits_both(jax_params, sd, toks)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ids, mask = pack_prefixes([[50360, 71, 72, 50257], [50257]], EOT)
    ref = jax_greedy(jax.tree.map(jnp.asarray, jax_params), jax_tiny(), jnp.asarray(_mel()),
                     jnp.asarray(ids), jnp.asarray(mask), max_new=8, eot_id=EOT)
    res = greedy_decode(model, _mel(), ids, mask, max_new=8, eot_id=EOT, device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(ref.tokens))


def test_writers_read_each_others_files(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(3)
    tensors = {"b.w": rng.standard_normal((3, 5)).astype(np.float32),
               "a": rng.standard_normal(7),
               "h": rng.standard_normal((2, 2)).astype(np.float16),
               "empty": np.zeros((0, 4), np.float32)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    hf = str(tmp_path / "hf.safetensors")
    write_safetensors(tensors, ours)
    st.save_file(tensors, theirs)
    st.save_file(tensors, hf, metadata={"format": "pt"})  # as transformers writes
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()  # the same layout, byte for byte
    for got in (st.load_file(ours), read_safetensors(theirs), read_safetensors(hf)):
        assert got.keys() == tensors.keys()
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)


def test_untied_proj_out_survives_jax_port_hf(jax_params, tmp_path):
    params = _untied(jax_params)
    cfg = tiny_test_config()
    sd = params_from_jax(params, cfg)
    np.testing.assert_array_equal(state_dict_to_jax(sd, cfg)["proj_out"], params["proj_out"])
    # port -> HF file -> JAX, and JAX -> HF file -> port
    save_safetensors(sd, cfg, str(tmp_path / "port"))
    jparams, _ = jax_load_safetensors(str(tmp_path / "port" / "model.safetensors"), jax_tiny())
    np.testing.assert_array_equal(np.asarray(jparams["proj_out"]), params["proj_out"])
    jax_save_safetensors(jax.tree.map(jnp.asarray, params), jax_tiny(), str(tmp_path / "jax"))
    sd2, _ = load_safetensors(str(tmp_path / "jax"), cfg)
    assert torch.equal(sd2["proj_out"], sd["proj_out"])
    toks = np.random.default_rng(4).integers(0, 50000, (2, 10))
    got, want, model = _logits_both(params, sd2, toks)
    assert model.proj_out is not None
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    tied, _, _ = _logits_both(jax_params, params_from_jax(jax_params, cfg), toks)
    assert np.abs(got - tied).max() > 1e-3  # the head is really used


def test_vocab_cache_follows_the_head(jax_params):
    """The serving model's cached vocab projection is the untied head's,
    and is rebuilt when the head changes."""
    cfg = tiny_test_config()
    model = build_model(cfg, params_from_jax(_untied(jax_params), cfg), device="cpu")
    x = torch.randn(1, 3, 64)
    from whisper_context_biasing_tpu_torch.models import project_vocab

    with torch.no_grad():
        got = project_vocab(model, x)
        torch.testing.assert_close(got, x @ model.proj_out.T, rtol=0, atol=1e-5)
        model.proj_out.mul_(2.0)
        torch.testing.assert_close(project_vocab(model, x), 2 * got, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the reader refuses what it cannot read
# ---------------------------------------------------------------------------

def _with_header(header: dict, data: bytes) -> bytes:
    text = json.dumps(header).encode()
    return struct.pack("<Q", len(text)) + text + data


BAD_FILES = {
    "truncated_data": (lambda b: b[:-4], "outside"),
    "truncated_header": (lambda b: b[:20], "does not fit"),
    "no_header_length": (lambda b: b[:5], "no header length"),
    "overlapping_offsets": (lambda b: _with_header(
        {"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
         "y": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, bytes(12)), "overlap"),
    "size_not_shape": (lambda b: _with_header(
        {"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, bytes(8)), "bytes for shape"),
    "bf16": (lambda b: _with_header(
        {"x": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}}, bytes(4)), "BF16"),
    "int8": (lambda b: _with_header(
        {"x": {"dtype": "I8", "shape": [2], "data_offsets": [0, 2]}}, bytes(2)), "I8"),
}


@pytest.mark.parametrize("case", list(BAD_FILES))
def test_reader_refuses_bad_files(case):
    make, match = BAD_FILES[case]
    good = serialize({"w": np.arange(6, dtype=np.float32).reshape(2, 3)})
    with pytest.raises(ValueError, match=match):
        deserialize(make(good))


def test_writer_refuses_other_dtypes():
    with pytest.raises(ValueError, match="int8"):
        serialize({"q": np.zeros(3, np.int8)})


# ---------------------------------------------------------------------------
# float64 against HF torch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_f64():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.WhisperModel(_hf_config()).double().eval()
    sd, cfg = load_torch_model(hf)
    cfg = tiny_test_config(dtype="float64", n_heads=2)
    return hf, build_model(cfg, sd, device="cpu")


def test_encoder_matches_hf_in_float64(hf_f64):
    hf, model = hf_f64
    mel = _mel(3).astype(np.float64)
    with torch.no_grad():
        want = hf.encoder(torch.from_numpy(mel)).last_hidden_state
        got = encode_audio(model, torch.from_numpy(mel))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10, rtol=0)


def test_logits_match_hf_in_float64(hf_f64):
    hf, model = hf_f64
    mel = _mel(4).astype(np.float64)
    toks = np.array([[50257, 50362, 10, 20], [50257, 50362, 30, 40]])
    with torch.no_grad():
        hidden = hf(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(toks)).last_hidden_state
        got, _ = decode_tokens(model, torch.from_numpy(toks),
                               enc_out=encode_audio(model, torch.from_numpy(mel)))
    # project HF's hidden states with the tied embedding: a logit-space compare
    want = hidden @ hf.decoder.embed_tokens.weight.detach().T
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_pipeline_checkpoint_matches_jax_pipeline(jax_params, tmp_path):
    jax_save_safetensors(jax.tree.map(jnp.asarray, jax_params), jax_tiny(), str(tmp_path))
    path = str(tmp_path / "model.safetensors")
    ref = JaxPipeline("tiny.en", config=jax_tiny(quantize_cross_kv=True, gelu_approx=True),
                      checkpoint=path, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), checkpoint=path,
                    device="cpu")
    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (6400, 20480)]
    kw = dict(context="patient on aspirin", bias_words=["aspirin"], bias_boost=2.0,
              max_tokens=12)
    want, got = ref.transcribe(clips, **kw), port.transcribe(clips, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.tokens for r in got)


def test_load_checkpoint_or_safetensors_and_pretrained(tmp_path):
    from whisper_context_biasing_tpu_torch.train import save_checkpoint

    cfg = tiny_test_config()
    model = build_model(cfg, seed=3, device="cpu", train=True)
    ckpt = save_checkpoint(str(tmp_path), 1, model)
    with pytest.raises(ValueError, match="cfg required"):
        load_checkpoint_or_safetensors(ckpt)
    native, _ = load_checkpoint_or_safetensors(ckpt, cfg)
    save_safetensors(native, cfg, str(tmp_path / "hf" / "w.safetensors"))
    hf, hf_cfg = load_checkpoint_or_safetensors(str(tmp_path / "hf" / "w.safetensors"), cfg)
    assert hf_cfg == cfg and native.keys() == hf.keys()
    assert all(torch.equal(native[k], hf[k]) for k in native)
    sd, got_cfg = load_pretrained(str(tmp_path / "hf" / "w.safetensors"), dtype="float32",
                                  quantize_cross_kv=True)
    assert got_cfg.dtype == "float32" and got_cfg.quantize_cross_kv and got_cfg.n_heads == 1
    # a name is the seeded init of its config: nothing is fetched
    sd, got_cfg = load_pretrained("openai/whisper-tiny.en", dtype="float32")
    assert got_cfg == get_config("tiny.en", dtype="float32")
    assert all(torch.equal(sd[k], v) for k, v in init_state_dict(got_cfg, 0).items())
    assert not os.path.exists("openai")


def test_quantized_params_rejected(jax_params):
    """int8 decoder weights are not exportable, in either package: the
    JAX quantized tree carried over, and the port's own quantized model."""
    from whisper_context_biasing_tpu.models.whisper import quantize_decoder_weights as jax_q
    from whisper_context_biasing_tpu_torch.models import quantize_decoder_weights

    cfg = tiny_test_config()
    q = jax.tree.map(np.asarray, jax_q(jax_params))
    with pytest.raises(ValueError, match="not exportable"):
        jax_state_dict_from_params(q, jax_tiny())
    with pytest.raises(ValueError, match="not exportable"):
        state_dict_from_params(params_from_jax(q, cfg), cfg)
    model = quantize_decoder_weights(build_model(cfg, params_from_jax(jax_params, cfg),
                                                 device="cpu"))
    with pytest.raises(ValueError, match="not exportable"):
        state_dict_from_params(model.state_dict(), cfg)
