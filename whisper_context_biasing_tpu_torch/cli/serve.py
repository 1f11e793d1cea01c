"""HTTP transcription server on the card: the port's counterpart of the JAX
package's ``scripts/serve.py``, with its flags plus ``--device`` and
``--host``.

    python -m whisper_context_biasing_tpu_torch.cli.serve --model base.en --port 8080 \\
        [--init_checkpoint model.safetensors] [--num_beams 5] \\
        [--bias_words aspirin promisec --bias_boost 2.0] [--long_chunked]

    curl -s --data-binary @clip.wav http://localhost:8080/transcribe
    curl -s http://localhost:8080/health

A standard-library HTTP front over the port's pipeline: requests queue,
micro-batch up to ``--batch`` (padded with silence) or until ``--max_wait_ms``
passes, decode in one call and are answered. Requests over 30 s take the
sequential long-form loop, or with ``--long_chunked`` the chunked decoder.

POST /transcribe takes a WAV or MP3 body; optional headers:
    X-Context:         conditioning text (after <|startofprev|>)
    X-Bias-Words:      comma-separated bias words for this request
    X-Language:        a language code or "auto" (multilingual models)
    X-Task:            "translate" (multilingual models)
    X-Word-Timestamps: "1" adds per-word start/end times (any length)
    X-Window-Info:     "1" adds per-window QC dicts (requests over 30 s)

Streaming sessions (``decode/streaming.py``):
    POST /stream            -> {"session": id}   (the same option headers)
    POST /stream/<id>       a WAV or raw PCM16-LE body; returns the segments
                            the newly completed windows closed
    POST /stream/<id>/end   flush the tail; returns the final transcript

Device work is ordered by one lock: the micro-batch worker thread and the
HTTP handler threads that feed stream sessions each hold ``Engine.device_lock``
around every call into the model, so one call runs on the card at a time (on
the default stream), each with its own cache and K/V, and the kernels' launch
counters are updated by one thread at a time. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs on the CPU.
Greedy decoding runs speculatively with the same output on every route:
``--draft_model`` (``--draft_checkpoint``, ``--spec_k``; long-form and
streams only with the target's ``n_mels``) or ``--medusa medusa.npz``
(``--medusa_chains``), which wins over a draft.

Several cards: one process a card, launched by ``torchrun``, with
``--model_parallelism`` as in JAX (1: the micro-batches' rows over "data"
on every card; N > 1: (data, model) with the weights, and a draft's, over
groups of N; 0: rank 0 alone)::

    torchrun --nproc_per_node 4 -m whisper_context_biasing_tpu_torch.cli.serve \
        --model_parallelism 2 --port 8080 ...

JAX drives every chip from one process; the port is SPMD, so the ranks keep
in step by a protocol of their own:

  * rank 0 alone binds the socket and runs the handler threads, the
    micro-batch worker and the stream table's bookkeeping; ranks > 0 run
    ``Engine.follow()``;
  * every device task (a short-form batch, a long-form or chunked batch, a
    stream's opening, feed and end, the warm-up batch, dropping idle
    streams) is broadcast by rank 0 while it holds ``device_lock``, as its
    method's name and its numpy or plain-Python arguments, over a gloo
    group of its own (``torch.distributed.broadcast_object_list``), and
    then run by every rank: all ranks run the same calls in the same order,
    and every rank holds every stream session's state;
  * a request that validation refuses (``_validate_opt``, audio that does
    not decode, too many streams) is refused on rank 0 before anything is
    broadcast, and so is a feed or end of a session that is unknown once
    rank 0 holds ``device_lock`` (another call ended it, or it was reaped,
    while this one waited: 404, on one device too);
  * while no request comes, rank 0 broadcasts a no-op every
    ``HEARTBEAT_S`` seconds, so a waiting rank hears from it within the
    process group's timeout (``DIST_TIMEOUT_S``);
  * a failure of a device task on any rank ends that rank's process with a
    non-zero code, and a rank waiting on a peer that died fails when the
    process group's timeout expires: no rank catches such a failure and
    goes on;
  * ``Engine.close()`` (SIGTERM or SIGINT to rank 0) broadcasts the
    shutdown; ranks > 0 ignore those signals, leave their loop on it, and
    every rank exits 0.
"""

from __future__ import annotations

import argparse
import datetime
import io
import json
import os
import queue
import signal
import sys
import threading
import time
import traceback
import uuid
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..audio import pad_or_trim, pcm_to_float32, resample, select_mel_frontend
from ..audio.mel import N_SAMPLES
from ..data.collator import SpeechSeq2SeqCollator
from ..decode import (
    StreamingTranscriber,
    beam_decode_batch,
    decode_batch,
    detect_language,
    find_word_timestamps,
    load_draft,
    medusa_decode_batch,
    resolve_start_tokens,
    speculative_decode_batch,
    transcribe_chunked,
    transcribe_long_batch,
    unpack_long_form,
)
from ..models import (
    FAST_OVERRIDES,
    build_model,
    get_config,
    load_checkpoint_or_safetensors,
    load_medusa,
)
from ..models.convert import params_from_jax
from ..models.whisper import encode_audio
from ..parallel import auto_mesh, initialize_multihost, shard_params
from ..tokenizer import LANGUAGES, load_tokenizer
from ..utils import RtfMeter, warn_missing_assets
from . import report_devices

HEARTBEAT_S = 10.0  # rank 0's no-op broadcast while idle (ranks > 0 wait on it)
DIST_TIMEOUT_S = 600.0  # a rank waiting this long on a collective fails


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HTTP transcription server")
    p.add_argument("--model", default="base.en")
    p.add_argument("--init_checkpoint", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--merges", default=None)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch", type=int, default=8,
                   help="micro-batch size (padded with silence)")
    p.add_argument("--max_wait_ms", type=int, default=30,
                   help="max queueing delay before a partial batch is flushed")
    p.add_argument("--max_tokens", type=int, default=128)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--draft_model", default=None,
                   help="speculative decoding draft family (greedy path; output exactly "
                        "matches the target model)")
    p.add_argument("--draft_checkpoint", default=None)
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--medusa", default=None,
                   help="medusa.npz (cli.medusa): self-speculative multi-token heads, no "
                        "draft model; output exactly matches plain greedy. Applies to "
                        "short-form, long-form and streaming greedy paths")
    p.add_argument("--medusa_chains", type=int, default=None,
                   help="branch on head 1's top-S candidates per round (tree-attention "
                        "chain mode; default: the value saved in medusa.npz, else 1)")
    p.add_argument("--bias_words", nargs="*", default=None, help="server-wide default bias words")
    p.add_argument("--bias_boost", type=float, default=0.0)
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="under torchrun: 1 shards each batch's rows over every process "
                        "(data parallel), N > 1 a (data, model) mesh with the weights over "
                        "groups of N, 0 rank 0 alone")
    p.add_argument("--long_chunked", action="store_true",
                   help="serve >30 s requests with the chunked decoder (all windows of a "
                        "request batch in --chunked_batch decode calls)")
    p.add_argument("--chunked_batch", type=int, default=32,
                   help="window-batch size for --long_chunked")
    p.add_argument("--vad", action="store_true",
                   help="energy VAD: long-form/chunked windows and buffered stream windows "
                        "with no detected speech skip all device work")
    p.add_argument("--no_long_form", action="store_true",
                   help="truncate >30 s requests to one window instead of the long-form loop")
    p.add_argument("--timestamps", action="store_true",
                   help="long-form requests use timestamp-conditioned seeking")
    p.add_argument("--temperatures", type=float, nargs="*",
                   default=[0.0, 0.2, 0.4, 0.6, 0.8, 1.0], help="long-form fallback ladder")
    p.add_argument("--best_of", type=int, default=1,
                   help="sampled fallback rungs draw N candidates a window; the best average "
                        "logprob wins")
    p.add_argument("--logprob_threshold", type=float, default=-1.0,
                   help="long-form: avg token logprob below this triggers fallback; nan "
                        "disables")
    p.add_argument("--stream_ttl", type=int, default=600,
                   help="seconds before an idle streaming session is reaped")
    p.add_argument("--max_streams", type=int, default=64,
                   help="cap on concurrent streaming sessions")
    # the port's own
    p.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    p.add_argument("--host", default="0.0.0.0", help="address to bind")
    return p.parse_args(argv)


def _nan_off(x):
    return None if x is None or x != x else x


class Engine:
    """The model on one device, or this rank's shard of it, and (on rank 0)
    the micro-batching worker. ``config`` and ``params`` (the JAX package's
    params tree as numpy arrays) replace what ``args`` would load, and
    ``draft_config`` and ``draft_params`` what ``--draft_model`` would;
    ``warmup`` runs one silent batch before the first request.
    ``batches`` lists the real requests of each micro-batch the worker ran.

    In a process group of several ranks (the caller initialized it) with a
    mesh, every rank builds an ``Engine``; rank 0 serves and the others
    call ``follow()`` (the module's docstring has the protocol)."""

    MAX_SPANS = (16, 16)  # bias spans padded to one shape for every request

    def __init__(self, args, *, config=None, params=None, draft_config=None,
                 draft_params=None, warmup: bool = True):
        self.args = args
        self.device = resolve_device(args.device)
        self.tokenizer = load_tokenizer(args.vocab, args.merges,
                                        multilingual=not args.model.endswith(".en"))
        fast = self.device.type == "cuda"
        self.cfg = config if config is not None else get_config(
            args.model, dtype="bfloat16", **(FAST_OVERRIDES if fast else {}))
        warn_missing_assets(args.vocab, args.init_checkpoint or params, "serve")
        state = None
        if params is not None:
            state = params_from_jax(params, self.cfg)
        elif args.init_checkpoint:
            state, self.cfg = load_checkpoint_or_safetensors(args.init_checkpoint, self.cfg)
        self.model = build_model(self.cfg, state, seed=0, device=self.device)
        self.medusa = (load_medusa(args.medusa, n_chains=args.medusa_chains)
                       if args.medusa else None)
        # the draft inherits the serving overrides: the target's kernel family
        self.draft = self.draft_cfg = None
        if args.draft_model:
            self.draft, self.draft_cfg = load_draft(
                args.draft_model, args.draft_checkpoint,
                overrides=FAST_OVERRIDES if fast else {}, target_cfg=self.cfg,
                cfg=draft_config, params=draft_params, device=self.device)
        # the mesh: the weights (and the draft's) over "model", each batch's
        # rows over "data"; every rank of the group takes part
        self.mesh = auto_mesh(args.model_parallelism)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.tasks = None  # the gloo group rank 0 broadcasts device tasks over
        if self.mesh is not None:
            report_devices(self.device, self.mesh)
            self.model = shard_params(self.model, self.mesh)
            if self.draft is not None:
                self.draft = shard_params(self.draft, self.mesh)
            self.tasks = dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=DIST_TIMEOUT_S))
        self.frontend = select_mel_frontend()
        self.rtf = RtfMeter()
        self.collator = SpeechSeq2SeqCollator(
            pad_token_id=self.tokenizer.pad_token_id,
            decoder_start_token_id=self.tokenizer.sot,
            bias_span_pad_id=self.tokenizer.eot)
        self.collator.max_spans = self.MAX_SPANS
        # one call into the model at a time, from any thread
        self.device_lock = threading.Lock()
        self.batches: list[int] = []
        self.q: queue.Queue = queue.Queue()
        self.streams: dict = {}
        self.streams_lock = threading.Lock()
        if self.rank != 0:  # a follower: its tasks come from rank 0
            return
        self.last_task = time.monotonic()
        self.closing = threading.Event()
        self.worker = threading.Thread(target=self._worker, daemon=True)
        self.worker.start()
        if self.tasks is not None:
            self.heartbeat = threading.Thread(target=self._heartbeat, daemon=True)
            self.heartbeat.start()
        if warmup:
            print("warming up...", file=sys.stderr)
            with self.device_lock:
                self._task("_run", [np.zeros(16000, np.float32)] * args.batch,
                           [None] * args.batch, [None] * args.batch)
            print("ready", file=sys.stderr)

    def close(self) -> None:
        """Stop the worker after the batches already queued; under a mesh,
        then tell the other ranks to leave ``follow()``."""
        self.q.put(None)
        self.worker.join()
        if self.tasks is not None:
            self.closing.set()
            with self.device_lock:
                self._broadcast("_shutdown")
            self.heartbeat.join()

    # -- the ranks' protocol (the module's docstring) ----------------------

    def _broadcast(self, name: str, *args) -> None:
        dist.broadcast_object_list([(name, args)], src=0, group=self.tasks,
                                   device=torch.device("cpu"))
        self.last_task = time.monotonic()

    def _task(self, name: str, *args):
        """Run the device task ``name`` here and, under a mesh, on every
        other rank first told to (the caller holds ``device_lock``). A
        failure under a mesh ends the process: the ranks are out of step."""
        if self.tasks is None:
            return getattr(self, name)(*args)
        self._broadcast(name, *args)
        try:
            return getattr(self, name)(*args)
        except Exception:
            traceback.print_exc()
            print(f"rank {self.rank}: device task {name} failed; exiting", file=sys.stderr,
                  flush=True)
            os._exit(1)

    def _heartbeat(self) -> None:
        while not self.closing.wait(HEARTBEAT_S / 4):
            if time.monotonic() - self.last_task < HEARTBEAT_S:
                continue
            with self.device_lock:
                if not self.closing.is_set():
                    self._broadcast("_ping")

    def _ping(self) -> None:
        pass

    def follow(self) -> None:
        """Ranks > 0: run every device task rank 0 broadcasts, in its order,
        until its shutdown. Any failure propagates (the process exits)."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.tasks,
                                       device=torch.device("cpu"))
            name, args = box[0]
            if name == "_shutdown":
                return
            getattr(self, name)(*args)

    def mel(self, audio, n_mels: int | None = None) -> torch.Tensor:
        return self.frontend(torch.as_tensor(audio, dtype=torch.float32, device=self.device),
                             n_mels=n_mels or self.cfg.n_mels)

    def _long_draft(self):
        """The draft tuple of the long-form routes and streams: only a draft
        with the target's mel frontend (their mel is shared)."""
        if self.draft is None or self.draft_cfg.n_mels != self.cfg.n_mels:
            return None
        return (self.draft, self.draft_cfg, self.args.spec_k)

    def _spans_for(self, words_lists):
        if not any(words_lists):
            return None
        n_max, k_max = self.MAX_SPANS
        encoded = [[self.tokenizer.encode(w.strip().lower(), add_special_tokens=False)[:k_max]
                    for w in (words or [])[:n_max] if w.strip()] for words in words_lists]
        return self.collator.pad_bias_spans(encoded)

    @staticmethod
    def _needs_detection(o) -> bool:
        return o.get("language") == "auto" or (o.get("task") == "translate"
                                               and not o.get("language"))

    def _starts_for(self, mel, opts, enc_out=None):
        """Per-row decode starts from X-Language / X-Task, or None when every
        row starts with a bare ``[<|sot|>]``; rows asking for "auto" (or to
        translate without a language) share one language-id pass."""
        tok = self.tokenizer
        n = mel.shape[0]
        if not tok.multilingual or not any(
                o.get("language") or o.get("task") == "translate" for o in opts):
            return None, [None] * n
        detected = None
        if any(self._needs_detection(o) for o in opts):
            detected = detect_language(self.model, tok, mel, enc_out=enc_out)
        starts, langs = [], []
        for i, o in enumerate(opts):
            st, lg = resolve_start_tokens(
                tok, 1, language=o.get("language"), task=o.get("task", "transcribe"),
                detect=(lambda i=i: [detected[i]]) if detected else None)
            starts.append(st[0] if st else [tok.sot])
            langs.append(lg[0])
        return starts, langs

    @torch.no_grad()
    def _run(self, audios, contexts, bias_word_lists, opts=None):
        """One short-form micro-batch (the caller holds ``device_lock``)."""
        tok = self.tokenizer
        n = len(audios)
        opts = opts or [{} for _ in range(n)]
        # never raw PCM here, however routing changes: int16 normalizes first
        stacked = np.stack([pad_or_trim(pcm_to_float32(a)) for a in audios])
        mel = self.mel(stacked)
        ctx = None
        if any(contexts):
            # rows without a context stay unprompted
            ctx = [tok.encode(c.lower(), add_special_tokens=False) if c else []
                   for c in contexts]
        default_words = self.args.bias_words or []
        spans = self._spans_for([w if w is not None else default_words
                                 for w in bias_word_lists])
        want_words = any(o.get("words") for o in opts)
        enc = None
        if want_words or (tok.multilingual and any(self._needs_detection(o) for o in opts)):
            enc = encode_audio(self.model, mel)  # shared by language id and alignment
        starts, langs = self._starts_for(mel, opts, enc_out=enc)
        kwargs = dict(contexts=ctx, max_new=self.args.max_tokens, bias_spans=spans,
                      bias_boost=self.args.bias_boost, starts=starts, device=self.device,
                      mesh=self.mesh)
        if self.args.num_beams > 1:
            hyps = beam_decode_batch(self.model, tok, mel, num_beams=self.args.num_beams,
                                     **kwargs)
        elif self.medusa is not None:
            hyps = medusa_decode_batch(self.model, self.medusa, tok, mel, pad_to_multiple=32,
                                       **kwargs)
        elif self.draft is not None:
            mel_d = (None if self.draft_cfg.n_mels == self.cfg.n_mels
                     else self.mel(stacked, n_mels=self.draft_cfg.n_mels))
            hyps = speculative_decode_batch(self.draft, self.model, tok, mel,
                                            k=self.args.spec_k, pad_to_multiple=32,
                                            input_features_draft=mel_d, **kwargs)
        else:
            hyps = decode_batch(self.model, tok, mel, pad_to_multiple=32, **kwargs)
        results = [{"text": tok.decode(h, skip_special_tokens=True).strip()} for h in hyps]
        for r, lang in zip(results, langs):
            if lang:
                r["language"] = lang
        if want_words:
            timings = find_word_timestamps(
                self.model, tok, mel, hyps, starts=starts,
                num_frames=[min(len(a), N_SAMPLES) // 320 for a in audios],
                pad_to=self.args.max_tokens + 8, enc_out=enc)
            for r, o, ws in zip(results, opts, timings):
                if o.get("words"):
                    r["words"] = self._word_dicts(ws)
        return results

    def _prep_long(self, audios, contexts, bias_word_lists, opts):
        """Request preparation shared by both long-form routes: contexts,
        bias spans, per-file start tokens and languages (detected on each
        file's first window), and the logprob threshold (nan disables)."""
        tok = self.tokenizer
        ctx = [tok.encode(c.lower(), add_special_tokens=False) if c else [] for c in contexts]
        default_words = self.args.bias_words or []
        spans = self._spans_for([w if w is not None else default_words
                                 for w in bias_word_lists])
        start_tokens, langs = None, [None] * len(audios)
        if tok.multilingual and any(o.get("language") or o.get("task") == "translate"
                                    for o in opts):
            # int16 audio of the chunked route: normalize the detection
            # window only, not the whole file
            first = np.stack([pad_or_trim(pcm_to_float32(a[:N_SAMPLES])) for a in audios])
            start_tokens, langs = self._starts_for(self.mel(first), opts)
        return ctx, spans, start_tokens, langs, _nan_off(self.args.logprob_threshold)

    @staticmethod
    def _word_dicts(ws):
        return [{"word": w.word.strip(), "start": w.start, "end": w.end,
                 "probability": w.probability} for w in ws]

    def _long_results(self, out, n, audios, opts, langs, want_words, want_info):
        hyps, _, words, winfo = unpack_long_form(
            out, return_segments=want_words, word_timestamps=want_words,
            return_window_info=want_info)
        tok = self.tokenizer
        results = [{"text": tok.decode(h, skip_special_tokens=True).strip()} for h in hyps[:n]]
        for i, (r, lang) in enumerate(zip(results, langs[:n])):
            if lang:
                r["language"] = lang
            if words is not None and opts[i].get("words"):
                r["words"] = self._word_dicts(words[i])
            if winfo is not None and opts[i].get("window_info") and len(audios[i]) > N_SAMPLES:
                r["windows"] = winfo[i]
        return results

    @torch.no_grad()
    def _run_long_chunked(self, audios, contexts, bias_word_lists, opts):
        """Requests over 30 s with --long_chunked: every window of every
        request decodes in --chunked_batch batches padded with silence."""
        n = len(audios)
        opts = opts or [{} for _ in range(n)]
        ctx, spans, start_tokens, langs, lp = self._prep_long(audios, contexts, bias_word_lists,
                                                              opts)
        want_words = any(o.get("words") for o in opts[:n])
        # window QC is for requests that are themselves long: a short request
        # gets the same response whatever it was batched with
        want_info = any(o.get("window_info") and len(a) > N_SAMPLES
                        for o, a in zip(opts[:n], audios[:n]))
        out = transcribe_chunked(
            self.model, self.tokenizer, audios, mel_fn=self.mel, max_new=self.args.max_tokens,
            contexts=ctx if any(ctx) else None, bias_spans=spans,
            bias_boost=self.args.bias_boost, use_timestamps=self.args.timestamps,
            temperatures=tuple(self.args.temperatures), best_of=self.args.best_of,
            logprob_threshold=lp, prefix_pad_to_multiple=32,
            max_batch=self.args.chunked_batch, pad_batches=True, start_tokens=start_tokens,
            num_beams=self.args.num_beams, vad=self.args.vad, return_segments=want_words,
            word_timestamps=want_words, return_window_info=want_info, medusa=self.medusa,
            draft=self._long_draft(), mesh=self.mesh, device=self.device)
        return self._long_results(out, n, audios, opts, langs, want_words, want_info)

    @torch.no_grad()
    def _run_long(self, audios, contexts, bias_word_lists, opts=None):
        """Requests over 30 s: the sequential-window seek loop, the batch
        padded to --batch with silence (the caller holds ``device_lock``)."""
        bs = self.args.batch
        n = len(audios)
        opts = (opts or [{} for _ in range(n)]) + [{}] * (bs - n)
        audios = list(audios) + [np.zeros(160, np.float32)] * (bs - n)
        contexts = list(contexts) + [None] * (bs - n)
        bias_word_lists = list(bias_word_lists) + [None] * (bs - n)
        ctx, spans, start_tokens, langs, lp = self._prep_long(audios, contexts, bias_word_lists,
                                                              opts)
        want_words = any(o.get("words") for o in opts[:n])
        want_info = any(o.get("window_info") and len(a) > N_SAMPLES
                        for o, a in zip(opts[:n], audios[:n]))
        out = transcribe_long_batch(
            self.model, self.tokenizer, audios, mel_fn=self.mel, max_new=self.args.max_tokens,
            contexts=ctx if any(ctx) else None, bias_spans=spans,
            bias_boost=self.args.bias_boost, use_timestamps=self.args.timestamps,
            temperatures=tuple(self.args.temperatures), best_of=self.args.best_of,
            logprob_threshold=lp, prefix_pad_to_multiple=32, start_tokens=start_tokens,
            return_segments=want_words, word_timestamps=want_words,
            num_beams=self.args.num_beams, vad=self.args.vad, return_window_info=want_info,
            medusa=self.medusa, draft=self._long_draft(), mesh=self.mesh, device=self.device)
        return self._long_results(out, n, audios, opts, langs, want_words, want_info)

    # -- streaming sessions (decode/streaming.py) -------------------------

    def stream_start(self, context=None, bias_words=None, opt=None) -> str:
        """Open an incremental session. Stream windows decode at batch 1
        outside the micro-batch queue, under ``device_lock``. Language options
        as for /transcribe: a code forces it, "auto" (or translate without a
        code) detects on the first window."""
        self._reap_streams()
        sid = uuid.uuid4().hex[:16]
        with self.device_lock:
            with self.streams_lock:
                if len(self.streams) >= self.args.max_streams:
                    raise RuntimeError(f"too many active streams (max {self.args.max_streams})")
            self._task("_open_stream", sid, context, bias_words, opt or {})
        return sid

    def _open_stream(self, sid, context, bias_words, opt) -> None:
        tok = self.tokenizer
        spans = None
        words = bias_words if bias_words is not None else self.args.bias_words
        if words:
            spans = self.collator.pad_bias_spans(
                [[tok.encode(w.strip().lower(), add_special_tokens=False)[:16]
                  for w in words if w.strip()]])
        ctx = tok.encode(context.lower(), add_special_tokens=False) if context else None
        st = StreamingTranscriber(
            self.model, tok, mel_fn=self.mel, max_new=self.args.max_tokens, context=ctx,
            bias_spans=spans, bias_boost=self.args.bias_boost,
            use_timestamps=self.args.timestamps, temperatures=tuple(self.args.temperatures),
            best_of=self.args.best_of, logprob_threshold=_nan_off(self.args.logprob_threshold),
            language=opt.get("language") if tok.multilingual else None,
            task=opt.get("task", "transcribe") if tok.multilingual else "transcribe",
            word_timestamps=bool(opt.get("words")), vad=self.args.vad, medusa=self.medusa,
            draft=None if self.medusa is not None else self._long_draft(), device=self.device)
        with self.streams_lock:
            self.streams[sid] = [st, threading.Lock(), time.time()]

    def _reap_streams(self):
        """Drop sessions idle past the TTL (an abandoned client's buffered
        audio and history would stay forever), on every rank."""
        def idle():
            cutoff = time.time() - self.args.stream_ttl
            with self.streams_lock:
                return [s for s, rec in self.streams.items() if rec[2] < cutoff]

        if idle():
            with self.device_lock:  # a call may have touched one meanwhile
                sids = idle()
                if sids:
                    self._task("_drop_streams", sids)

    def _drop_streams(self, sids) -> None:
        with self.streams_lock:
            for sid in sids:
                self.streams.pop(sid, None)

    def _stream(self, sid):
        with self.streams_lock:
            if sid not in self.streams:
                raise KeyError(f"unknown stream session: {sid}")
            rec = self.streams[sid]
            rec[2] = time.time()
            return rec

    def _stream_task(self, name: str, sid, *args):
        """The session's device task ``name``, if the session is still open
        once ``device_lock`` is held (a concurrent end or the reaper may have
        closed it since ``_stream``): else KeyError, before any broadcast."""
        with self.device_lock:
            with self.streams_lock:
                if sid not in self.streams:
                    raise KeyError(f"unknown stream session: {sid}")
            return self._task(name, sid, *args)

    @staticmethod
    def _segment_dicts(segs):
        return [{"start": round(a, 3), "end": None if e is None else round(e, 3),
                 "text": t.strip()} for a, e, t in segs]

    def stream_feed(self, sid, audio):
        self._reap_streams()  # abandoned sessions go even if no stream starts
        st, lock, _ = self._stream(sid)
        with lock:
            n_words = len(st.words)
            segs = self._stream_task("_feed_stream", sid, audio)
            out = {"segments": self._segment_dicts(segs),
                   "buffered_seconds": round(st.buffered_samples / 16000, 2)}
            if st.word_timestamps:
                out["words"] = self._word_dicts(st.words[n_words:])
            if st.language:
                out["language"] = st.language
            return out

    @torch.no_grad()
    def _feed_stream(self, sid, audio):
        rec = self.streams.get(sid)  # rank 0 checked it under device_lock
        return [] if rec is None else rec[0].feed(audio)

    def stream_end(self, sid):
        st, lock, _ = self._stream(sid)
        with lock:
            n_words = len(st.words)
            segs = self._stream_task("_finish_stream", sid)
            out = {"segments": self._segment_dicts(segs), "text": st.text}
            if st.word_timestamps:
                out["words"] = self._word_dicts(st.words[n_words:])
            if st.language:
                out["language"] = st.language
        return out

    @torch.no_grad()
    def _finish_stream(self, sid):
        """The session's tail; the session is closed on every rank."""
        rec = self.streams.get(sid)  # rank 0 checked it under device_lock
        self._drop_streams([sid])
        return [] if rec is None else rec[0].finish()

    # -- the micro-batch queue --------------------------------------------

    def submit(self, audio, context, bias_words, opt=None):
        done = threading.Event()
        box = {}
        self.q.put((audio, context, bias_words, opt or {}, done, box))
        done.wait(timeout=300)
        if "error" in box:
            raise RuntimeError(box["error"])
        if "result" not in box:
            raise TimeoutError("decode timed out")
        return box["result"]

    def _worker(self):
        bs = self.args.batch
        while True:
            first = self.q.get()
            if first is None:  # shutdown sentinel
                return
            batch = [first]
            deadline = time.time() + self.args.max_wait_ms / 1000.0
            while len(batch) < bs:
                try:
                    item = self.q.get(timeout=max(0.0, deadline - time.time()))
                except queue.Empty:
                    break
                if item is None:
                    self.q.put(None)  # exit after this batch
                    break
                batch.append(item)
            audios = [b[0] for b in batch]
            ctxs = [b[1] for b in batch]
            words = [b[2] for b in batch]
            opts = [b[3] for b in batch]
            n = len(batch)
            while len(audios) < bs:  # padded to --batch with silence
                audios.append(np.zeros(16000, np.float32))
                ctxs.append(None)
                words.append(None)
                opts.append({})
            long_form = not self.args.no_long_form and any(len(a) > N_SAMPLES
                                                           for a in audios[:n])
            audio_s = (sum(len(a) for a in audios[:n]) / 16000 if long_form
                       else sum(min(len(a), N_SAMPLES) for a in audios[:n]) / 16000)
            t0 = time.time()
            try:
                with self.device_lock:
                    if long_form:  # the route rank 0 takes, named to every rank
                        route = "_run_long_chunked" if self.args.long_chunked else "_run_long"
                        results = self._task(route, audios[:n], ctxs[:n], words[:n], opts[:n])
                    else:
                        results = self._task("_run", audios, ctxs, words, opts)
                self.rtf.add(audio_s, time.time() - t0)
                self.batches.append(n)
                for (_, _, _, _, done, box), res in zip(batch, results[:n]):
                    box["result"] = res
                    done.set()
            except Exception as e:  # every waiter of the batch gets the error
                for _, _, _, _, done, box in batch:
                    box["error"] = f"{type(e).__name__}: {e}"
                    done.set()
                print(f"batch failed: {e}", file=sys.stderr)


def decode_audio_bytes(data: bytes, keep_int16: bool = False) -> np.ndarray:
    """An uploaded body by its magic bytes: WAV, or MP3 (through the
    libmpg123 binding, ``audio/mp3.py``, where the library is present).
    ``keep_int16``: a mono 16-bit 16 kHz WAV comes back as raw int16 (the
    chunked decoder normalizes on the card)."""
    if data[:4] == b"RIFF":
        return decode_wav_bytes(data, keep_int16=keep_int16)
    if data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        import tempfile

        from ..audio.io import EXTRA_DECODERS

        dec = EXTRA_DECODERS.get(".mp3")
        if dec is None:
            raise ValueError("mp3 decoder unavailable on this host")
        with tempfile.NamedTemporaryFile(suffix=".mp3") as f:
            f.write(data)
            f.flush()
            sig, sr = dec(f.name)
        if sr != 16000:
            sig = resample(sig, sr, 16000)
        return np.asarray(sig, np.float32)
    raise ValueError("unsupported audio container (expect WAV or MP3)")


def decode_wav_bytes(data: bytes, keep_int16: bool = False) -> np.ndarray:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if keep_int16 and width == 2 and ch == 1 and sr == 16000:
        return np.frombuffer(raw, dtype="<i2")
    if width == 2:
        sig = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        sig = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        sig = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if ch > 1:
        sig = sig.reshape(-1, ch).mean(axis=1)
    if sr != 16000:
        sig = resample(sig, sr, 16000)
    return sig


def _validate_opt(engine, opt) -> str | None:
    """Request validation before batching (language code, task name)."""
    lang = opt.get("language")
    tok = engine.tokenizer
    if lang and lang != "auto" and tok.multilingual and lang not in LANGUAGES[: tok.num_languages]:
        return f"unknown language code: {lang}"
    task = opt.get("task")
    if task and task not in ("transcribe", "translate"):
        return f"unknown task: {task}"
    return None


def _parse_opt_headers(headers) -> dict:
    """The option headers of /transcribe and /stream."""
    opt = {}
    if headers.get("X-Language"):
        opt["language"] = headers["X-Language"].strip()
    if headers.get("X-Task"):
        opt["task"] = headers["X-Task"].strip()
    if (headers.get("X-Word-Timestamps") or "").strip() in ("1", "true", "yes"):
        opt["words"] = True
    if (headers.get("X-Window-Info") or "").strip() in ("1", "true", "yes"):
        opt["window_info"] = True  # long-form only
    return opt


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "model": engine.args.model,
                                 "rtf": round(engine.rtf.rtf, 1) if engine.rtf.wall_s else None})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path.startswith("/stream"):
                self._stream_post()
                return
            if self.path != "/transcribe":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                # int16 is kept only for requests the chunked route takes (it
                # normalizes on the card); short requests arrive as float32
                keep = engine.args.long_chunked and not engine.args.no_long_form
                audio = decode_audio_bytes(self.rfile.read(n), keep_int16=keep)
                if audio.dtype == np.int16 and len(audio) <= N_SAMPLES:
                    audio = audio.astype(np.float32) / 32768.0
                ctx = self.headers.get("X-Context")
                words = self.headers.get("X-Bias-Words")
                words = words.split(",") if words else None
                opt = _parse_opt_headers(self.headers)
                # a bad option fails here, not every request of its micro-batch
                err = _validate_opt(engine, opt)
                if err:
                    self._json(400, {"error": err})
                    return
                t0 = time.time()
                result = engine.submit(audio, ctx, words, opt)
                result.update({"audio_seconds": round(len(audio) / 16000, 2),
                               "latency_ms": round((time.time() - t0) * 1000, 1)})
                self._json(200, result)
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def _stream_post(self):
            try:
                parts = [p for p in self.path.split("/") if p]
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if parts == ["stream"]:  # open a session
                    opt = _parse_opt_headers(self.headers)
                    err = _validate_opt(engine, opt)
                    if err:
                        self._json(400, {"error": err})
                        return
                    words = self.headers.get("X-Bias-Words")
                    sid = engine.stream_start(context=self.headers.get("X-Context"),
                                              bias_words=words.split(",") if words else None,
                                              opt=opt)
                    self._json(200, {"session": sid})
                elif len(parts) == 2:  # feed audio
                    audio = (decode_wav_bytes(body) if body[:4] == b"RIFF"
                             else np.frombuffer(body, dtype="<i2").astype(np.float32) / 32768.0)
                    self._json(200, engine.stream_feed(parts[1], audio))
                elif len(parts) == 3 and parts[2] == "end":
                    self._json(200, engine.stream_end(parts[1]))
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                self._json(404, {"error": str(e)})
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(args, **engine_kwargs) -> tuple[Engine, ThreadingHTTPServer]:
    """The engine and its HTTP server bound to ``--host``:``--port`` (0
    picks a free port: ``server.server_address[1]``), not yet serving. Rank
    0's alone: under a mesh the other ranks build an ``Engine`` and
    ``follow()`` it."""
    engine = Engine(args, **engine_kwargs)
    return engine, ThreadingHTTPServer((args.host, args.port), make_handler(engine))


def main(argv=None, **engine_kwargs) -> int:
    """Serve until SIGTERM or SIGINT (rank 0), or follow rank 0 (the other
    ranks of a ``torchrun`` launch); returns 0 after a clean shutdown.
    ``engine_kwargs`` go to every rank's ``Engine`` (e.g. ``config``)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    initialize_multihost(device=args.device,
                         timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        if dist.is_initialized() and dist.get_rank() != 0:
            # rank 0 decides when to stop: the signals a launcher sends every
            # rank are its to act on
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            engine = Engine(args, warmup=False, **engine_kwargs)
            if engine.tasks is not None:
                engine.follow()
            return 0
        engine, server = make_server(args, **engine_kwargs)
        stop = threading.Event()

        def on_signal(*_):
            if not stop.is_set():
                stop.set()
                threading.Thread(target=server.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, on_signal)
        signal.signal(signal.SIGINT, on_signal)
        print(f"serving on {args.host}:{server.server_address[1]} ({device}, pid {os.getpid()})",
              file=sys.stderr, flush=True)
        server.serve_forever()
        server.server_close()
        engine.close()
        print("shut down", file=sys.stderr, flush=True)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
