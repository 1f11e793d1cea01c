"""Port parity for the HTTP server (``cli/serve.py``) against the JAX
package's ``scripts/serve.py``: both servers live on ``127.0.0.1:0``
(``ThreadingHTTPServer``, as tests/test_serve.py runs the JAX one), each
around an engine on the same weights (the port's ``Engine`` built from its
flags with ``--device cpu``, the JAX one wired by hand around the tiny
config as tests/test_serve.py does), and get the same requests: the JSON of
``/transcribe`` (short with a context and bias words, word timestamps,
sequential long-form with window info and words, the chunked route with an
int16 upload, a bad option) and of a stream session's every call are equal,
apart from ``latency_ms``. Then two concurrent posts land in one
micro-batch, ``/health``, the audio-body decoders against the JAX ones, the
A.9 flag raising before any weights load (the draft and Medusa flags going
on to load them), and ``--medusa`` and ``--draft_model`` servers against the
JAX server with the same heads or draft.

The model is ``tiny_test_config`` with the real 30 s window; the JAX
engine's log-mel is its jnp frontend, the port's the mel kernel's plain
version."""

import http.client
import importlib.util
import io
import json
import os
import queue
import sys
import threading
import wave
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from whisper_context_biasing_tpu.audio import pad_or_trim as jax_pad_or_trim
from whisper_context_biasing_tpu.audio.mel import select_mel_frontend as jax_mel_frontend
from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
from whisper_context_biasing_tpu.decode import (
    decode_batch,
    detect_language,
    find_word_timestamps,
    transcribe_chunked,
    transcribe_long_batch,
)
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.utils import RtfMeter as JaxRtfMeter
from whisper_context_biasing_tpu_torch.cli import serve
from whisper_context_biasing_tpu_torch.models import tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

SR = 16000
CFG = dict(n_audio_ctx=1500, quantize_cross_kv=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--batch", "2", "--max_tokens", "4", "--temperatures", "0.0", "--logprob_threshold",
         "nan", "--chunked_batch", "4", "--max_wait_ms", "300", "--host", "127.0.0.1",
         "--port", "0", "--timestamps", "--device", "cpu"]


def _load_jax_serve():
    spec = importlib.util.spec_from_file_location("wcb_serve",
                                                  os.path.join(REPO, "scripts", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_engine(jax_serve, args, params):
    """The JAX Engine around the tiny config, wired by hand as
    tests/test_serve.py does (its constructor builds the TPU config)."""
    eng = jax_serve.Engine.__new__(jax_serve.Engine)
    eng.args = Namespace(**vars(args))
    eng.jnp = jnp
    eng.cfg = jax_tiny(**CFG)
    eng.params = params
    eng.tokenizer = load_tokenizer()
    eng.collator = JaxCollator(pad_token_id=eng.tokenizer.pad_token_id,
                               decoder_start_token_id=eng.tokenizer.sot,
                               bias_span_pad_id=eng.tokenizer.eot)
    eng.mesh = eng.medusa = None
    eng.draft_params = eng.draft_cfg = None
    eng.pad_or_trim = jax_pad_or_trim
    eng.streams, eng.streams_lock = {}, threading.Lock()
    eng.mel_fn = jax_mel_frontend()
    eng.decode_batch, eng.detect_language = decode_batch, detect_language
    eng.find_word_timestamps = find_word_timestamps
    eng.transcribe_long_batch, eng.transcribe_chunked = transcribe_long_batch, transcribe_chunked
    eng.q, eng.rtf = queue.Queue(), JaxRtfMeter()
    threading.Thread(target=eng._worker, daemon=True).start()
    return eng


@pytest.fixture(scope="module")
def servers():
    """(port engine, port address, JAX engine, JAX address)."""
    from http.server import ThreadingHTTPServer

    jax_serve = _load_jax_serve()
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(**CFG), 0))
    args = serve.parse_args(FLAGS)
    port_eng, port_srv = serve.make_server(
        args, config=tiny_test_config(**CFG, flash_attention=True, fused_quant_cross=True),
        params=params, warmup=False)
    jeng = jax_engine(jax_serve, args, params)
    jax_srv = ThreadingHTTPServer(("127.0.0.1", 0), jax_serve.make_handler(jeng))
    for srv in (port_srv, jax_srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield port_eng, port_srv.server_address, jeng, jax_srv.server_address
    for srv, eng in ((port_srv, port_eng), (jax_srv, jeng)):
        srv.shutdown()
        eng.q.put(None)  # the worker's shutdown sentinel


def post(addr, path, body=b"", headers=None):
    c = http.client.HTTPConnection(*addr, timeout=300)
    c.request("POST", path, body=body, headers=headers or {})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def wav_bytes(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def speech_like(rng, seconds):
    t = np.arange(int(seconds * SR)) / SR
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


REQUESTS = {
    "short_context_bias": (1.5, {"X-Context": "patient on aspirin",
                                 "X-Bias-Words": "aspirin,metformin"}, False),
    "short_words": (2.0, {"X-Word-Timestamps": "1"}, False),
    "long_window_info_words": (33.0, {"X-Window-Info": "1", "X-Word-Timestamps": "1"}, False),
    "chunked_int16_words": (40.0, {"X-Word-Timestamps": "1"}, True),
    "bad_task": (1.0, {"X-Task": "summarize"}, False),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_transcribe_json_matches_jax(servers, case):
    port_eng, port_addr, jeng, jax_addr = servers
    seconds, headers, chunked = REQUESTS[case]
    body = wav_bytes(speech_like(np.random.default_rng(len(case)), seconds))
    for eng in (port_eng, jeng):
        eng.args.long_chunked = chunked
    try:
        got, want = post(port_addr, "/transcribe", body, headers), post(jax_addr, "/transcribe",
                                                                         body, headers)
    finally:
        for eng in (port_eng, jeng):
            eng.args.long_chunked = False
    assert got[0] == want[0] == (400 if case == "bad_task" else 200)
    for out in (got[1], want[1]):
        out.pop("latency_ms", None)
    if "windows" in want[1]:
        for gw, ww in zip(got[1].pop("windows"), want[1].pop("windows"), strict=True):
            for key in ("avg_logprob", "no_speech_prob"):
                assert gw.pop(key) == pytest.approx(ww.pop(key), abs=1e-5)
            assert gw == ww
    assert got[1] == want[1]
    if "X-Word-Timestamps" in headers:
        assert got[1]["words"] and set(got[1]["words"][0]) == {"word", "start", "end",
                                                               "probability"}


def test_stream_session_matches_jax(servers):
    """One session a server: open with a context and word timestamps, feed
    a 33 s clip as raw PCM16 in 1 s chunks, end: every response equal."""
    port_eng, port_addr, _, jax_addr = servers
    pcm = (np.clip(speech_like(np.random.default_rng(9), 33.0), -1, 1) * 32767).astype("<i2")
    runs = []
    for addr in (port_addr, jax_addr):
        status, out = post(addr, "/stream", headers={"X-Context": "clinical note",
                                                     "X-Word-Timestamps": "1"})
        assert status == 200 and len(out["session"]) == 16
        sid = out["session"]
        replies = [post(addr, f"/stream/{sid}", pcm[i: i + SR].tobytes())
                   for i in range(0, len(pcm), SR)]
        replies.append(post(addr, f"/stream/{sid}/end"))
        replies.append(post(addr, f"/stream/{sid}", pcm[:SR].tobytes()))  # gone: 404
        runs.append(replies)
    assert runs[0][:-1] == runs[1][:-1]
    assert runs[0][-1][0] == runs[1][-1][0] == 404 and runs[0][-2][1]["text"]
    assert any(r[1].get("segments") for r in runs[0][:-2])
    assert not port_eng.streams


def test_concurrent_posts_share_one_micro_batch_and_health(servers):
    port_eng, port_addr, _, jax_addr = servers
    rng = np.random.default_rng(10)
    bodies = [wav_bytes(speech_like(rng, s)) for s in (1.0, 2.5)]
    n_before = len(port_eng.batches)
    out = [None, None]

    def send(i):
        out[i] = post(port_addr, "/transcribe", bodies[i])

    threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [o[0] for o in out] == [200, 200]
    assert port_eng.batches[n_before:] == [2]  # both requests in one micro-batch
    for i, body in enumerate(bodies):  # the same answer as alone
        alone = post(port_addr, "/transcribe", body)[1]
        assert alone["text"] == out[i][1]["text"]
    health = []
    for addr in (port_addr, jax_addr):
        c = http.client.HTTPConnection(*addr, timeout=60)
        c.request("GET", "/health")
        r = c.getresponse()
        health.append((r.status, json.loads(r.read())))
    assert health[0][0] == health[1][0] == 200
    assert set(health[0][1]) == set(health[1][1]) == {"status", "model", "rtf"}
    assert health[0][1]["status"] == "ok" and health[0][1]["rtf"] > 0


def test_audio_body_decoders_match_jax():
    jax_serve = _load_jax_serve()
    pcm = (np.arange(1600) % 700 - 350).astype(np.int16)
    mono = wav_bytes(pcm.astype(np.float32) / 32767)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(np.repeat(pcm, 2).tobytes())
    for data in (mono, buf.getvalue()):
        for keep in (False, True):
            got = serve.decode_audio_bytes(data, keep_int16=keep)
            want = jax_serve.decode_audio_bytes(data, keep_int16=keep)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert serve.decode_audio_bytes(mono, keep_int16=True).dtype == np.int16
    for mod in (serve, jax_serve):
        with pytest.raises(ValueError, match="unsupported audio container"):
            mod.decode_audio_bytes(b"\x00\x01\x02\x03" * 100)
    headers = {"X-Language": " fr ", "X-Task": "translate", "X-Word-Timestamps": "yes",
               "X-Window-Info": "1"}
    assert serve._parse_opt_headers(headers) == jax_serve._parse_opt_headers(headers)


@pytest.mark.parametrize("argv,item", [(["--draft_model", "tiny.en"], None),
                                       (["--medusa", "medusa.npz"], None),
                                       (["--model_parallelism", "2"], "A.9")],
                         ids=["draft_model", "medusa", "model_parallelism"])
def test_unported_serve_flags_raise_before_loading(argv, item, tmp_path):
    # the checkpoint does not exist: a flag not ported is refused before it
    # is read; the draft and Medusa flags, ported since, go on to read it
    argv = ["--init_checkpoint", str(tmp_path / "none.safetensors"), "--device", "cpu", *argv]
    if item is None:
        with pytest.raises(FileNotFoundError, match="none"):
            serve.main(argv)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue {item}"):
        serve.main(argv)


@pytest.mark.parametrize("accel", ["medusa", "draft"])
def test_medusa_and_draft_match_jax(servers, accel, tmp_path):
    """``--medusa heads.npz`` and ``--draft_model`` (a self-draft on the
    target's weights, through the engine's draft hooks): a short request
    with a context and bias words and a 33 s request with window info give
    the JAX server's JSON with the same heads or draft."""
    from http.server import ThreadingHTTPServer

    from whisper_context_biasing_tpu.models import load_medusa as jax_load_medusa
    from whisper_context_biasing_tpu_torch.models import init_medusa_params, save_medusa

    _, _, jeng, jax_addr = servers
    params = jeng.params
    extra, hooks = [], {}
    if accel == "medusa":
        path = str(tmp_path / "medusa.npz")
        save_medusa(path, dict(init_medusa_params(tiny_test_config(), 2, 3), n_chains=2))
        extra = ["--medusa", path]
        jeng.medusa = jax_load_medusa(path)
    else:
        extra = ["--draft_model", "tiny.en", "--spec_k", "3"]
        hooks = dict(draft_config=tiny_test_config(**CFG, flash_attention=True,
                                                   fused_quant_cross=True), draft_params=params)
        jeng.draft_params, jeng.draft_cfg = params, jeng.cfg
    jeng.args.spec_k = 3
    eng, srv = serve.make_server(
        serve.parse_args(FLAGS + extra),
        config=tiny_test_config(**CFG, flash_attention=True, fused_quant_cross=True),
        params=params, warmup=False, **hooks)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for seconds, headers in ((1.5, {"X-Context": "patient on aspirin",
                                        "X-Bias-Words": "aspirin,metformin"}),
                                 (33.0, {"X-Window-Info": "1"})):
            body = wav_bytes(speech_like(np.random.default_rng(3), seconds))
            got = post(srv.server_address, "/transcribe", body, headers)
            want = post(jax_addr, "/transcribe", body, headers)
            for out in (got[1], want[1]):
                out.pop("latency_ms", None)
            for gw, ww in zip(got[1].pop("windows", []), want[1].pop("windows", []),
                              strict=True):
                for key in ("avg_logprob", "no_speech_prob"):
                    assert gw.pop(key) == pytest.approx(ww.pop(key), abs=1e-5)
                assert gw == ww
            assert got == want and got[0] == 200
    finally:
        srv.shutdown()
        eng.q.put(None)
        jeng.medusa = jeng.draft_params = jeng.draft_cfg = None


def test_serve_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Engine(serve.parse_args(["--init_checkpoint", str(tmp_path / "none")]))
    assert sys.modules["whisper_context_biasing_tpu_torch.cli.serve"] is serve
