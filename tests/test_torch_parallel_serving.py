"""Port parity: every serving route under a (data, model) mesh against the
JAX package on one device.

One spawn of a gloo world of 4 processes on the CPU (a (data 2, model 2)
mesh; a ``file://`` rendezvous under the test's tmp dir, one intra-op thread
a rank, a timeout of its own) runs every sharded route and writes its
results; the test process meanwhile computes the JAX package's
single-device results on the same numpy weights (``params_from_jax``) and
holds every rank's to them, in f32, token for token:

  * speculative decoding with a narrow draft (sharded like the target): 5
    rows, padded over "data", with bias spans;
  * Medusa decoding, plain and in chain mode (the heads whole on every rank;
    both give JAX's plain Medusa tokens, as tests/test_parallel.py holds);
  * sequential long-form with history conditioning and word timestamps;
  * chunked long-form, the windows gathered on the device and cut on the
    host (each rank turns only its own windows into mel);
  * ``Pipeline(model_parallelism=2)`` with a draft and with heads (both give
    the JAX ``Pipeline``'s greedy tokens, which the draft and the heads do
    not change);
  * ``evaluate_wer``'s Medusa route (its WER and ``refs_and_pred.txt``).

Sampled rungs are held to the port's own unsharded run for one seed: the
draws follow a row's index in the whole batch (``greedy.RowDraws``), so a
temperature-1.0 greedy decode and a long-form ladder forced onto its t = 0.2
rung (best of 2) give the unsharded tokens, and two rows with the same
inputs on different ranks of "data" draw different uniforms. Under "model"
the logits differ from the unsharded ones by f32 summation order only, so a
row could differ only where its uniform lies within that rounding of a CDF
boundary; the test asserts equality and none does.

The server: in the same spawn rank 0 serves on ``127.0.0.1:0`` while ranks
1-3 follow (``cli/serve.py``'s protocol), and the JSON of each request and
of a stream session's every call equals the one-device port server's (which
tests/test_torch_serve.py holds to JAX's ``scripts/serve.py``); two
concurrent ends of one session and a feed racing them leave every rank in
step; the shutdown leaves no rank waiting (every rank exits 0).

In-process, the draw rule itself: a batch split into two shards gives the
unsharded draws row by row, and the shards do not share uniforms.
"""

import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.audio.mel import log_mel_spectrogram_np as jax_np_mel
from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
from whisper_context_biasing_tpu.decode import medusa_decode_batch as jax_medusa_batch
from whisper_context_biasing_tpu.decode import speculative_decode_batch as jax_spec_batch
from whisper_context_biasing_tpu.decode import transcribe_chunked as jax_chunked
from whisper_context_biasing_tpu.decode import transcribe_long_batch as jax_long
from whisper_context_biasing_tpu.models import init_medusa_params as jax_init_medusa
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import evaluate_wer as jax_evaluate_wer
from whisper_context_biasing_tpu_torch.cli import serve
from whisper_context_biasing_tpu_torch.decode import pack_prefixes
from whisper_context_biasing_tpu_torch.decode.greedy import _greedy_decode
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    params_from_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train.checkpoint import _flatten

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT_S = 300
REF_THREADS = 3
PAD = 50256
DECODE_KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
DRAFT = dict(n_audio_layers=1, n_text_layers=1, d_model=32, n_heads=2)
WIN = 64 * 320  # the tiny config's window: 64 encoder states
LONG = dict(max_new=5, temperatures=(0.0,), no_speech_threshold=None, logprob_threshold=None,
            compression_ratio_threshold=None, window_samples=WIN)
PIPE_KW = dict(context="patient on aspirin", bias_words=["aspirin"], bias_boost=2.0,
               max_tokens=8)
# the server: tests/test_torch_serve.py's flags and config (the real 30 s window)
SERVE_CFG = dict(n_audio_ctx=1500, quantize_cross_kv=True)
SERVE_FLAGS = ["--batch", "2", "--max_tokens", "4", "--temperatures", "0.0",
               "--logprob_threshold", "nan", "--chunked_batch", "4", "--max_wait_ms", "300",
               "--host", "127.0.0.1", "--port", "0", "--timestamps", "--device", "cpu"]

# each rank: python worker.py RANK WORKDIR; no JAX in the ranks
WORKER = r'''
import http.client, json, sys, threading
import numpy as np
import torch
import torch.distributed as dist

rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                        world_size=4, rank=rank)
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram_np
from whisper_context_biasing_tpu_torch.cli import serve
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.decode import (greedy_decode, medusa_decode_batch,
                                                      speculative_decode_batch,
                                                      transcribe_chunked,
                                                      transcribe_long_batch)
from whisper_context_biasing_tpu_torch.models import (FAST_OVERRIDES, build_model,
                                                      params_from_jax, tiny_test_config)
from whisper_context_biasing_tpu_torch.parallel import make_mesh, shard_params
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import evaluate_wer
from whisper_context_biasing_tpu_torch.train.checkpoint import _unflatten

spec = json.load(open(f"{workdir}/spec.json"))
z = np.load(f"{workdir}/inputs.npz")
arrays = {k: z[k] for k in z.files}
tree = lambda p: _unflatten({k[len(p) + 1:]: v for k, v in arrays.items()
                             if k.startswith(p + "/")})
heads = {k: torch.from_numpy(v) for k, v in tree("medusa").items()}
words = lambda ws: [[w.word, w.start, w.end, list(w.tokens), w.probability] for w in ws]
tok = load_tokenizer()
mesh = make_mesh(2)
cfg = tiny_test_config(**spec["decode_kernels"])
cfg_d = tiny_test_config(**spec["draft"], **spec["decode_kernels"])
model = shard_params(build_model(cfg, params_from_jax(tree("params"), cfg), device="cpu"), mesh)
draft = shard_params(build_model(cfg_d, params_from_jax(tree("draft"), cfg_d), device="cpu"),
                     mesh)
out = {}
kw = dict(bias_spans=arrays["spans"], bias_boost=0.5, device="cpu", mesh=mesh)
out["speculative"] = speculative_decode_batch(draft, model, tok, arrays["mel"], max_new=6,
                                              k=3, **kw)
out["medusa"] = medusa_decode_batch(model, heads, tok, arrays["mel"], max_new=5,
                                    device="cpu", mesh=mesh)
out["medusa_chains"] = medusa_decode_batch(model, dict(heads, n_chains=2), tok, arrays["mel"],
                                           max_new=5, device="cpu", mesh=mesh)
audios = [arrays["audio0"], arrays["audio1"]]
# each window's numpy log-mel, cut to the tiny config's 128 frames
np_mel = lambda chunk: np.stack([log_mel_spectrogram_np(x)[:, :128] for x in np.asarray(chunk)])
toks, segs, ws = transcribe_long_batch(model, tok, audios, mel_fn=np_mel, return_segments=True,
                                       word_timestamps=True, device="cpu", mesh=mesh,
                                       **spec["long"])
out["long"] = [toks, segs, [words(w) for w in ws]]
for windows in (True, False):
    out[f"chunked_{windows}"] = transcribe_chunked(
        model, tok, audios, mel_fn=np_mel, use_timestamps=False, device_windows=windows,
        device="cpu", mesh=mesh, **spec["long"])
pcfg = tiny_test_config(**FAST_OVERRIDES)
clips = [arrays["clip0"], arrays["clip1"], arrays["clip2"]]
for name, accel in (("pipe_draft", dict(draft_model="tiny.en", draft_params=tree("draft"),
                                        draft_config=tiny_test_config(**spec["draft"],
                                                                      **FAST_OVERRIDES))),
                    ("pipe_medusa", dict(medusa=heads))):
    pipe = Pipeline("tiny.en", config=pcfg, params=tree("params"), device="cpu",
                    model_parallelism=2, **accel)
    out[name] = [r.tokens for r in pipe.transcribe(clips, **spec["pipe_kw"])]
    del pipe
coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                             bias_span_pad_id=tok.eot)
items = [{"input_features": f, "labels": arrays["eval_labels"][i], "bias_spans": []}
         for i, f in enumerate(arrays["eval_feats"])]
out["wer"] = evaluate_wer(model, tok, items, coll, 2, 5, refs_pred_file=f"{workdir}/refs_port.txt",
                          num_workers=1, mesh=mesh, medusa=heads)["wer"]

# sampled rungs: the unsharded port's tokens for one seed
gen = lambda: torch.Generator().manual_seed(5)
ids, mask = np.full((6, 1), tok.sot), np.ones((6, 1), bool)
out["sampled_greedy"] = greedy_decode(model, arrays["mel6"], ids, mask, max_new=6,
                                      temperature=1.0, generator=gen(), device="cpu",
                                      mesh=mesh).tokens.tolist()
out["sampled_long"] = transcribe_long_batch(model, tok, audios, mel_fn=np_mel, device="cpu",
                                            mesh=mesh, generator=gen(), **spec["sampled"])

# the server: rank 0 serves, the others follow
args = serve.parse_args(spec["serve_flags"] + ["--model_parallelism", "2"])
scfg = tiny_test_config(**spec["serve_cfg"], flash_attention=True, fused_quant_cross=True)
if rank == 0:
    eng, srv = serve.make_server(args, config=scfg, params=tree("serve"), warmup=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def post(path, body=b"", headers=None):
        c = http.client.HTTPConnection(*srv.server_address, timeout=300)
        c.request("POST", path, body=body, headers=headers or {})
        r = c.getresponse()
        res = [r.status, json.loads(r.read())]
        c.close()
        res[1].pop("latency_ms", None)
        return res

    replies = []
    for name, headers, chunked in spec["requests"]:
        eng.args.long_chunked = chunked
        replies.append(post("/transcribe", arrays[f"wav_{name}"].tobytes(), headers))
    eng.args.long_chunked = False
    sid = post("/stream", headers={"X-Context": "clinical note", "X-Word-Timestamps": "1"})
    replies.append(sid[0])
    pcm = arrays["stream_pcm"]
    sid = sid[1]["session"]
    replies += [post(f"/stream/{sid}", pcm[i: i + 16000].tobytes())
                for i in range(0, len(pcm), 16000)]
    replies.append(post(f"/stream/{sid}/end"))
    out["server"] = replies
    # a session ended twice at once while a feed races the ends
    race = post("/stream")[1]["session"]
    post(f"/stream/{race}", pcm[:16000].tobytes())
    go, raced = threading.Barrier(3), [None] * 3

    def hit(i, path, body=b""):
        go.wait()
        raced[i] = post(path, body)[0]

    hits = [threading.Thread(target=hit, args=(i, f"/stream/{race}/end")) for i in range(2)]
    hits.append(threading.Thread(target=hit, args=(2, f"/stream/{race}", pcm[:16000].tobytes())))
    for t in hits:
        t.start()
    for t in hits:
        t.join()
    out["race"] = raced
    srv.shutdown()
    eng.close()
    srv.server_close()
else:
    eng = serve.Engine(args, config=scfg, params=tree("serve"), warmup=False)
    eng.follow()
    out["server_streams_left"] = len(eng.streams)
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


def _speech_like(rng, seconds, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


def _wav(audio):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return np.frombuffer(buf.getvalue(), np.uint8)


def _words(ws):
    return [[w.word, w.start, w.end, list(w.tokens), w.probability] for w in ws]


def _np_mel(chunk):
    """Each window's numpy log-mel, cut to the tiny config's 128 frames."""
    return np.stack([jax_np_mel(x)[:, :128] for x in np.asarray(chunk)])


# (name, headers, chunked route): tests/test_torch_serve.py's requests
REQUESTS = [("short_context_bias", {"X-Context": "patient on aspirin",
                                    "X-Bias-Words": "aspirin,metformin"}, False),
            ("short_words", {"X-Word-Timestamps": "1"}, False),
            ("long_window_info_words", {"X-Window-Info": "1", "X-Word-Timestamps": "1"},
             False),
            ("chunked_words", {"X-Word-Timestamps": "1"}, True),
            ("bad_task", {"X-Task": "summarize"}, False)]
SECONDS = {"short_context_bias": 1.5, "short_words": 2.0, "long_window_info_words": 33.0,
           "chunked_words": 40.0, "bad_task": 1.0}
SAMPLED = dict(max_new=5, temperatures=(0.0, 0.2), best_of=2, logprob_threshold=0.0,
               no_speech_threshold=None, compression_ratio_threshold=None, window_samples=WIN)


def _one_device_server(params, arrays):
    """The one-device port server's replies to the ranks' requests and
    stream session."""
    import http.client

    args = serve.parse_args(SERVE_FLAGS)
    eng, srv = serve.make_server(args, config=tiny_test_config(
        **SERVE_CFG, flash_attention=True, fused_quant_cross=True), params=params, warmup=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def post(path, body=b"", headers=None):
        c = http.client.HTTPConnection(*srv.server_address, timeout=300)
        c.request("POST", path, body=body, headers=headers or {})
        r = c.getresponse()
        res = [r.status, json.loads(r.read())]
        c.close()
        res[1].pop("latency_ms", None)
        return res

    try:
        replies = []
        for name, headers, chunked in REQUESTS:
            eng.args.long_chunked = chunked
            replies.append(post("/transcribe", arrays[f"wav_{name}"].tobytes(), headers))
        eng.args.long_chunked = False
        sid = post("/stream", headers={"X-Context": "clinical note", "X-Word-Timestamps": "1"})
        replies.append(sid[0])
        pcm = arrays["stream_pcm"]
        sid = sid[1]["session"]
        replies += [post(f"/stream/{sid}", pcm[i: i + 16000].tobytes())
                    for i in range(0, len(pcm), 16000)]
        replies.append(post(f"/stream/{sid}/end"))
        return json.loads(json.dumps(replies))
    finally:
        srv.shutdown()
        eng.close()
        srv.server_close()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawn: inputs written, 4 ranks started, the references computed
    while they run, then every rank's results."""
    workdir = tmp_path_factory.mktemp("serving_world")
    tok = load_tokenizer()
    jcfg = jax_tiny(quantize_cross_kv=True)
    jcfg_d = jax_tiny(**DRAFT, quantize_cross_kv=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    dparams = jax.tree.map(np.asarray, jax_init(jcfg_d, 7))
    md = jax.tree.map(np.asarray, jax_init_medusa(jcfg, 2, 0))
    sparams = jax.tree.map(np.asarray, jax_init(jax_tiny(**SERVE_CFG), 0))

    rng = np.random.default_rng(7)
    mel = (rng.standard_normal((5, 80, 128)) * 0.5).astype(np.float32)
    spans = np.full((5, 2, 3), PAD, np.int32)
    spans[0, 0, :2] = [7, 8]
    spans[3, 0, :2] = [300, 301]
    mel6 = np.concatenate([mel[:3], mel[:3]])  # rows 0 and 3 alike, on other ranks
    audio_rng = np.random.default_rng(11)
    audios = [_speech_like(audio_rng, 1.5 * WIN / 16000),
              _speech_like(audio_rng, 0.5 * WIN / 16000)]
    clip_rng = np.random.default_rng(0)
    clips = [(0.1 * clip_rng.standard_normal(n)).astype(np.float32) for n in (6400, 16000, 20480)]
    eval_feats = (np.random.default_rng(4).standard_normal((5, 80, 128)) * 0.4).astype(np.float32)
    eval_labels = np.asarray([[tok.sot, 5 + i, 6, tok.eot] for i in range(5)], np.int32)
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    arrays.update({f"draft/{k}": v for k, v in _flatten(dparams).items()})
    arrays.update({f"medusa/{k}": v for k, v in _flatten(md).items()})
    arrays.update({f"serve/{k}": v for k, v in _flatten(sparams).items()})
    arrays.update(mel=mel, mel6=mel6, spans=spans, audio0=audios[0], audio1=audios[1],
                  clip0=clips[0], clip1=clips[1], clip2=clips[2], eval_feats=eval_feats,
                  eval_labels=eval_labels)
    for name, _, _ in REQUESTS:
        arrays[f"wav_{name}"] = _wav(_speech_like(np.random.default_rng(len(name)),
                                                  SECONDS[name]))
    arrays["stream_pcm"] = (np.clip(_speech_like(np.random.default_rng(9), 33.0), -1, 1)
                            * 32767).astype("<i2")
    np.savez(workdir / "inputs.npz", **arrays)
    spec = dict(decode_kernels=DECODE_KERNELS, draft=DRAFT, long=LONG, pipe_kw=PIPE_KW,
                sampled=SAMPLED, serve_flags=SERVE_FLAGS, serve_cfg=SERVE_CFG,
                requests=REQUESTS)
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
        # the references, in threads beside the ranks (JAX compiles with the
        # GIL released): the one-device port server, JAX's single-device
        # routes, the port's unsharded sampled rungs
        jspans = jnp.asarray(spans)
        coll = JaxCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                           bias_span_pad_id=tok.eot)
        items = [{"input_features": f, "labels": eval_labels[i], "bias_spans": []}
                 for i, f in enumerate(eval_feats)]

        def long_ref():
            toks, segs, ws = jax_long(params, jcfg, tok, audios, mel_fn=_np_mel,
                                      return_segments=True, word_timestamps=True, **LONG)
            return json.loads(json.dumps([toks, segs, [_words(w) for w in ws]]))

        def pipe_ref():
            pipe = JaxPipeline("tiny.en", config=jax_tiny(quantize_cross_kv=True,
                                                          gelu_approx=True),
                               params=params, model_parallelism=0)
            return [r.tokens for r in pipe.transcribe(clips, **PIPE_KW)]

        def sampled_refs():
            from whisper_context_biasing_tpu_torch.decode import (
                greedy_decode,
                transcribe_long_batch,
            )

            cfg = tiny_test_config(**DECODE_KERNELS)
            model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
            ids, mask = np.full((6, 1), tok.sot), np.ones((6, 1), bool)
            return (greedy_decode(model, mel6, ids, mask, max_new=6, temperature=1.0,
                                  generator=torch.Generator().manual_seed(5),
                                  device="cpu").tokens.tolist(),
                    transcribe_long_batch(model, tok, audios, mel_fn=_np_mel, device="cpu",
                                          generator=torch.Generator().manual_seed(5),
                                          **SAMPLED))

        jobs = {
            "server": lambda: _one_device_server(sparams, arrays),
            "speculative": lambda: jax_spec_batch(dparams, jcfg_d, params, jcfg, tok, mel,
                                                  max_new=6, k=3, bias_spans=jspans,
                                                  bias_boost=0.5),
            "medusa": lambda: jax_medusa_batch(params, jcfg, md, tok, mel, max_new=5),
            "long": long_ref,
            "chunked": lambda: jax_chunked(params, jcfg, tok, audios, mel_fn=_np_mel,
                                           use_timestamps=False, **LONG),
            "pipe": pipe_ref,
            "wer": lambda: jax_evaluate_wer(params, jcfg, tok, items, coll, 2, 5, medusa=md,
                                            refs_pred_file=str(workdir / "refs_jax.txt"),
                                            num_workers=1)["wer"],
            "sampled": sampled_refs,
        }
        with ThreadPoolExecutor(REF_THREADS) as pool:
            futures = {k: pool.submit(fn) for k, fn in jobs.items()}
            ref = {k: f.result(timeout=SPAWN_TIMEOUT_S) for k, f in futures.items()}
        # chain mode gives the same tokens (tests/test_parallel.py holds it
        # so); a draft and heads give the plain Pipeline's tokens
        ref["medusa_chains"] = ref["medusa"]
        ref["pipe_draft"] = ref["pipe_medusa"] = ref.pop("pipe")
        ref["sampled_greedy"], ref["sampled_long"] = ref.pop("sampled")
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
    return dict(workdir=workdir, ref=ref, ranks=ranks)


@pytest.mark.parametrize("route", ["speculative", "medusa", "medusa_chains", "chunked_True",
                                   "chunked_False", "pipe_draft", "pipe_medusa"])
def test_route_matches_jax(world, route):
    want = world["ref"][route.split("_")[0] if route.startswith("chunked") else route]
    assert any(want)
    for r in world["ranks"]:
        assert r[route] == want


def test_sequential_long_form_matches_jax(world):
    """Tokens (history-conditioned windows), segments and words; a word's
    probability within f32 rounding (the "model" sums in another order)."""
    toks, segs, words = world["ref"]["long"]
    assert any(words)
    for r in world["ranks"]:
        gt, gs, gw = r["long"]
        assert gt == toks and gs == segs
        for got, want in zip(gw, words, strict=True):
            assert [w[:4] for w in got] == [w[:4] for w in want]
            np.testing.assert_allclose([w[4] for w in got], [w[4] for w in want], atol=1e-5)


def test_evaluate_wer_medusa_matches_jax(world):
    assert [r["wer"] for r in world["ranks"]] == [world["ref"]["wer"]] * WORLD
    port = (world["workdir"] / "refs_port.txt").read_text()
    assert port == (world["workdir"] / "refs_jax.txt").read_text()
    assert port.count("Ref :") == 5


@pytest.mark.parametrize("what", ["sampled_greedy", "sampled_long"])
def test_sampled_rungs_match_unsharded(world, what):
    want = world["ref"][what]
    for r in world["ranks"]:
        assert r[what] == want
    if what == "sampled_greedy":
        # rows 0 and 3 have the same inputs and sit on different ranks of
        # "data": their draws differ
        assert want[0] != want[3] and want[1] != want[4]


FLOATS = ("avg_logprob", "no_speech_prob", "probability")


def _split_floats(x, out):
    """``x`` with the model's float outputs (``FLOATS``) taken out into
    ``out``, in order."""
    if isinstance(x, dict):
        return {k: (out.append(v) if k in FLOATS else _split_floats(v, out))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_split_floats(v, out) for v in x]
    return x


def test_server_matches_one_device(world):
    """Every reply (status and JSON, ``latency_ms`` aside) of the sharded
    server equals the one-device server's, the log-probabilities and word
    probabilities within f32 rounding (the "model" sums in another order,
    as tests/test_torch_serve.py holds them to JAX's); the followers closed
    the stream session too and every rank exited 0."""
    want = world["ref"]["server"]
    got = world["ranks"][0]["server"]
    got_f, want_f = [], []
    assert _split_floats(got, got_f) == _split_floats(want, want_f)
    assert len(want_f) > 10
    np.testing.assert_allclose(got_f, want_f, atol=1e-5, rtol=0)
    assert [x[0] for x in want[:5]] == [200, 200, 200, 200, 400]
    assert want[2][1].get("windows") and want[3][1].get("words") and want[-1][1]["text"]
    assert [r["server_streams_left"] for r in world["ranks"][1:]] == [0, 0, 0]


def test_server_stream_race_keeps_ranks_in_step(world):
    """Two concurrent ends of one session and a feed racing them: one end
    answers 200, the other 404, the feed 200 or 404 as it lands; nothing
    unknown reaches a broadcast, so every rank kept going to a clean exit
    with no session left."""
    race = world["ranks"][0]["race"]
    assert sorted(race[:2]) == [200, 404] and race[2] in (200, 404)
    assert [r["server_streams_left"] for r in world["ranks"][1:]] == [0, 0, 0]


# ---------------------------------------------------------------------------
# in-process: the draw rule
# ---------------------------------------------------------------------------

def test_shards_draw_the_unsharded_uniforms():
    """Six rows decoded at temperature 1.0 whole and as two shards of three
    (the second told its offset in the batch): the same tokens row by row.
    Rows 0 and 3 have the same inputs: their draws differ, so shards do not
    share uniforms."""
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    cfg = tiny_test_config()
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel3 = (np.random.default_rng(3).standard_normal((3, 80, 128)) * 0.5).astype(np.float32)
    mel = np.concatenate([mel3, mel3])
    ids, mask = pack_prefixes([[50257]] * 6, PAD)
    kw = dict(max_new=6, temperature=1.0, device="cpu")

    def run(rows, **over):
        return _greedy_decode(model, mel[rows], ids[rows], mask[rows],
                              generator=torch.Generator().manual_seed(9), **kw, **over).tokens

    whole = run(slice(0, 6))
    shards = torch.cat([run(slice(0, 3), row_offset=0, global_rows=6),
                        run(slice(3, 6), row_offset=3, global_rows=6)])
    assert torch.equal(shards, whole)
    assert not torch.equal(whole[:3], whole[3:])
