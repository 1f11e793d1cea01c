"""Server cells: the port's HTTP server's ``Engine`` (``cli/serve.py``)
under open-loop arrivals.

The Engine is built in-process as its command line builds it
(``parse_args`` of the mix's ``engine`` flags), with the seed's weights
written as an HF-named safetensors file in the run's temporary directory
and passed as ``--init_checkpoint``. Its own warm-up runs, then one
homogeneous burst of requests for each prefix bucket the mix's contexts
fill (so every call signature of the greedy step is captured before the
window), then a ramp of arrivals at the cell's rate. All of that is
set-up. In the window, one generator thread sleeps until each request's
due time (``core/arrivals.py``) and hands it to a pool of client threads
that call ``Engine.submit``, which queues it, micro-batches it with
others up to ``--batch`` or ``--max_wait_ms`` and returns its text. A
request's latency runs from its due time to the return of ``submit``;
one that fails, or is not done when the drain after the window ends, is
a failure.

Two things the Engine does not offer are supplied beneath it. Random
weights never choose <|endoftext|>, so each row's decode is capped at its
request's transcript length (the serving mix's caps), and the silent pad
rows at one token, through ``forced_eot_at`` of the program's
``greedy_decode``, which the Engine's ``decode_batch`` calls; and that
call's inputs and outputs (the prefix ids, the bias spans, the served
ids) are kept for the check. Both go through a subclass of the Engine
whose ``_run`` (one short-form micro-batch) knows which request sits in
which row, and puts a capping wrapper in place of the module's
``greedy_decode`` only while the program's own ``_run`` runs.

The mix's row shapes, audio and arrival schedule come from the serving
mix it names as ``rows_from`` (``core/runner.py:load_mix``).

The check, once the window has closed: every finished request's text
against the reference's reading of the ids its row served, and its
prefix and bias spans against the reference's own tokenization of its
strings (counts, limit 0); and a sample drawn from the seed, with the
request of most served tokens, each judged alone by the plain reference
as ``drivers/serve.py`` judges a batch's rows.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from core import arrivals, reference, trace, traffic
from core.weights import hf_shapes, make_weights

# cli/serve.py's Engine pads every decoder prefix to a multiple of 32 (its
# ``_run`` calls ``decode_batch(..., pad_to_multiple=32)``): a call
# signature of the captured step a bucket
PAD_TO_MULTIPLE = 32
CLIENTS = 384        # threads waiting on Engine.submit: more than the requests in flight
CLOSE_S = 60.0       # the Engine's close (it runs what is queued) is given up after this
# after the window: arrivals untraced, then the device traced, then the
# host traced too, and slack for the profiler's own start and stop
TRACE_LEAD_S, TRACE_S, TRACE_HOST_S, TRACE_SLACK_S = 2.0, 3.0, 2.0, 5.0


def port():
    """The program's entry points this driver calls."""
    from whisper_context_biasing_tpu_torch.cli import serve as cli
    from whisper_context_biasing_tpu_torch.decode import greedy
    from whisper_context_biasing_tpu_torch.models.config import FAST_OVERRIDES, get_config

    return dict(engine=cli.Engine, parse_args=cli.parse_args, greedy_module=greedy,
                greedy=greedy.greedy_decode, fast=FAST_OVERRIDES, get_config=get_config)


def write_safetensors(g: dict, flat: torch.Tensor, path: str) -> None:
    """The draw ``flat`` of ``make_weights`` as one F32 safetensors file
    under the HF names, in the draw's order (each tensor is the next slice
    of it)."""
    host = flat.float().cpu().numpy()
    header, off = {}, 0
    for name, shape in hf_shapes(g).items():
        n = int(np.prod(shape)) * 4
        header[name] = {"dtype": "F32", "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        f.write(host.data)


def tapped(engine_cls, greedy_module, greedy, request_of, on_decode):
    """The Engine whose short-form micro-batch (``_run``) decodes through
    ``greedy``, each row capped at its request's ``cap`` (a pad row, or a
    row of no request, at one token), and hands ``on_decode`` the rows'
    requests with the decode's inputs and outputs. The module's
    ``greedy_decode`` is replaced only while a ``_run`` runs (the Engine
    runs one at a time, under its ``device_lock``), and only for the
    thread that runs it: any other caller gets the function it replaced,
    also from a micro-batch that never returns."""

    class Tapped(engine_cls):
        def _run(self, audios, contexts, bias_word_lists, opts=None):
            rows = [request_of(a) for a in audios]
            orig, worker = greedy_module.greedy_decode, threading.get_ident()

            def capped(model, feats, ids, mask, **kw):
                if threading.get_ident() != worker:
                    return orig(model, feats, ids, mask, **kw)
                if feats.shape[0] != len(rows):
                    raise RuntimeError(f"a decode of {feats.shape[0]} rows in a micro-batch "
                                       f"of {len(rows)}")
                caps = np.array([r["cap"] if r else 1 for r in rows], np.int64)
                res = greedy(model, feats, ids, mask, forced_eot_at=caps, **kw)
                on_decode(rows, ids, mask, kw.get("bias_spans"), res)
                return res

            greedy_module.greedy_decode = capped
            try:
                return super()._run(audios, contexts, bias_word_lists, opts)
            finally:
                greedy_module.greedy_decode = orig

    return Tapped


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Driver:
    def __init__(self, spec: dict, seed: int, device):
        self.seed, self.dev = seed, torch.device(device)
        self.cfg, self.tr, self.cell, self.g = spec["config"], spec["traffic"], spec["cell"], spec["g"]
        self.tok = self.cfg["tokens"]
        self.p = port()
        self.shapes = traffic.serve_shapes(self.tr)
        self.audio = traffic.audio_sets(self.tr, self.shapes, seed)
        self.max_new = self.tr["engine"]["max_tokens"]
        if max(sh["cap"] for sh in self.shapes) >= self.max_new:
            raise ValueError(f"a cap of the mix reaches the Engine's --max_tokens {self.max_new}")
        self.by_audio: dict[int, dict] = {}   # id of a request's audio -> the request
        self.batches: list[dict] = []         # what each micro-batch's decode was given
        self.stats = dict(walls=[])
        self.wall = 0.0
        self.window_reqs: list[dict] = []
        self.done = threading.Condition()
        self.finished: dict[str, int] = {}
        self.tmp = tempfile.TemporaryDirectory(prefix="h100_bench_server_")
        path = os.path.join(self.tmp.name, "model.safetensors")
        w, flat = make_weights(self.g, seed, self.dev, getattr(torch, self.cfg["dtype"]))
        write_safetensors(self.g, flat, path)
        del w, flat
        fast = self.p["fast"] if self.dev.type == "cuda" else {}
        pcfg = self.p["get_config"](self.cfg["port_model"], dtype=self.cfg["dtype"], **fast)
        flags = ["--model", self.cfg["port_model"], "--init_checkpoint", path,
                 "--device", str(self.dev)]
        for k, v in self.tr["engine"].items():
            flags += [f"--{k}", str(v)]
        engine = tapped(self.p["engine"], self.p["greedy_module"], self.p["greedy"],
                        lambda audio: self.by_audio.get(id(audio)), self._decoded)
        self.engine = engine(self.p["parse_args"](flags), config=pcfg)
        self.handoff: collections.deque = collections.deque()
        self.handoff_cv = threading.Condition()
        self.clients = [threading.Thread(target=self._client, daemon=True)
                        for _ in range(CLIENTS)]
        for t in self.clients:
            t.start()
        self.ramp_end = None

    # ------------------------------------------------------------------
    # beneath the Engine: the row caps and the decode's inputs and outputs
    # ------------------------------------------------------------------

    def _decoded(self, rows, ids, mask, spans, res) -> None:
        for j, r in enumerate(rows):
            if r is not None:
                r["batch"], r["row"] = len(self.batches), j
        self.batches.append(dict(ids=ids, mask=mask, spans=spans, tokens=res.tokens,
                                 lengths=res.lengths, end=time.perf_counter()))

    # ------------------------------------------------------------------
    # the load: a generator thread and a pool of client threads
    # ------------------------------------------------------------------

    def _requests(self, phase: str, offsets: np.ndarray, tag: str | None = None,
                  first: int = 0, shapes: list[int] | None = None,
                  cap: int | None = None) -> list[dict]:
        """The requests due at ``offsets`` of ``phase`` (arrivals ``first``
        on), counted as done under ``tag``; ``shapes`` and ``cap`` force
        their row shapes and token cap."""
        tag = tag or phase
        out = []
        for j, off in enumerate(offsets):
            req = arrivals.request(self.tr, self.shapes, self.seed, phase, first + j,
                                   shape=None if shapes is None else shapes[j % len(shapes)])
            if cap is not None:
                req["cap"] = cap
            # a view of its own: the request's identity in the Engine's batch
            req["audio"] = self.audio[req["audio_set"]][req["shape"]][:]
            req["offset"], req["tag"] = float(off), tag
            self.by_audio[id(req["audio"])] = req
            out.append(req)
        self.finished[tag] = 0
        return out

    def _client(self) -> None:
        while True:
            with self.handoff_cv:
                self.handoff_cv.wait_for(lambda: self.handoff)
                req = self.handoff.popleft()
            if req is None:
                return
            req["sent"] = time.perf_counter()
            try:
                req["text"] = self.engine.submit(req["audio"], req["context"], req["words"])["text"]
            except Exception as e:  # the Engine's error or its time-out: a failed request
                req["error"] = f"{type(e).__name__}: {e}"
            req["done"] = time.perf_counter()
            with self.done:
                self.finished[req["tag"]] += 1
                self.done.notify_all()

    def _hand(self, reqs: list) -> None:
        with self.handoff_cv:
            self.handoff.extend(reqs)
            self.handoff_cv.notify(len(reqs))

    def _generate(self, reqs: list[dict], t0: float) -> threading.Thread:
        """A thread that hands each request over at ``t0`` + its offset."""
        for r in reqs:
            r["due"] = t0 + r["offset"]

        def run():
            for r in reqs:
                delay = r["due"] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                self._hand([r])

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def _wait(self, tag: str, n: int, until: float) -> None:
        with self.done:
            self.done.wait_for(lambda: self.finished[tag] >= n,
                               timeout=max(0.0, until - time.perf_counter()))

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------

    def warm_up(self) -> None:
        """A burst of ``--batch`` requests for each prefix bucket the mix's
        contexts fill (their cap the mix's largest), each burst awaited;
        then the ramp's arrivals at the cell's rate, until its last is due."""
        m = PAD_TO_MULTIPLE
        buckets: dict[int, list[int]] = {}
        for i, sh in enumerate(self.shapes):
            n = sh["ctx"] + 2 if sh["ctx"] else 1
            buckets.setdefault(-(-n // m), []).append(i)
        cap = max(sh["cap"] for sh in self.shapes)
        b = self.tr["engine"]["batch"]
        for k, shapes in sorted(buckets.items()):
            tag = f"warm{k}"
            reqs = self._requests("warm", np.zeros(b), tag=tag, first=k * b, shapes=shapes,
                                  cap=cap)
            for r in reqs:
                r["due"] = time.perf_counter()
            self._hand(reqs)
            self._wait(tag, len(reqs), time.perf_counter() + 120.0)
            bad = [r.get("error", "not done") for r in reqs if "text" not in r]
            if bad:
                raise RuntimeError(f"warm-up requests failed: {bad[0]}")
        ramp = self._requests("ramp", arrivals.due_times(self.tr, "ramp", self.tr["ramp_s"]))
        t0 = time.perf_counter()
        self._generate(ramp, t0).join()
        self.ramp_end = t0 + self.tr["ramp_s"]

    def window(self, seconds: float, tag: str = "window") -> dict:
        """The window's arrivals, handed over on time, then the drain; the
        95th percentile of the finished requests' latency. ``tag`` keeps
        a rate sweep's windows apart."""
        reqs = self._requests("window", arrivals.due_times(self.tr, "window", seconds), tag=tag)
        eng = self.engine
        b0, w0 = len(eng.batches), eng.rtf.wall_s
        k0 = len(self.batches)
        t0 = max(self.ramp_end or 0.0, time.perf_counter())
        self._generate(reqs, t0).join()
        end = t0 + seconds
        time.sleep(max(0.0, end - time.perf_counter()))
        self._wait(tag, len(reqs), end + self.tr["drain_s"])
        for r in reqs:  # what the drain's end saw
            r["ok"] = "text" in r and "done" in r
        b1, w1 = len(eng.batches), eng.rtf.wall_s
        self.window_reqs, self.wall = reqs, seconds
        ok = [r for r in reqs if r["ok"]]
        if not ok:
            raise RuntimeError(f"none of the window's {len(reqs)} requests completed")
        lat = [1e3 * (r["done"] - r["due"]) for r in ok]
        self.stats = dict(
            walls=[b["end"] - t0 for b in self.batches[k0:]],
            lag_ms=[1e3 * (r["sent"] - r["due"]) for r in reqs if "sent" in r],
            batch_rows=list(eng.batches[b0:b1]), batch_size=self.tr["engine"]["batch"],
            batch_wall_s=w1 - w0, latency_ms=lat)
        print(f"window: {len(reqs)} due, {len(ok)} done; latency ms p50 "
              f"{percentile(lat, 50):.1f} p95 {percentile(lat, 95):.1f} max {max(lat):.1f}; "
              f"{b1 - b0} micro-batches", file=sys.stderr, flush=True)
        return dict(serve_p95_ms=percentile(lat, 95))

    def attempted(self) -> int:
        return len(self.window_reqs)

    def failed(self) -> int:
        return sum(not r["ok"] for r in self.window_reqs)

    def _profile(self, seconds: float, host: bool = False) -> dict:
        """``trace.profile`` over ``seconds`` of the Engine at work, its
        profiler started and stopped while the Engine's ``device_lock`` is
        held, so no thread issues device work (a graph replay) as the
        profiler turns on or off."""
        lock = self.engine.device_lock

        def open_window():
            lock.release()
            time.sleep(seconds)
            lock.acquire()

        lock.acquire()
        try:
            return trace.profile(open_window, host=host)
        finally:
            lock.release()

    def traced(self) -> dict:
        """More arrivals at the cell's rate after the window: untraced for
        ``TRACE_LEAD_S``, then ``TRACE_S`` with the device traced, then
        ``TRACE_HOST_S`` with the host traced too, whose idle gaps name
        what the host was doing; then their drain. The arrivals run on
        ``TRACE_SLACK_S`` past these, as the profiler's start and stop take
        time of their own."""
        total = TRACE_LEAD_S + TRACE_S + TRACE_HOST_S + TRACE_SLACK_S
        reqs = self._requests("trace", arrivals.due_times(self.tr, "trace", total))
        t0 = time.perf_counter()
        gen = self._generate(reqs, t0)
        time.sleep(TRACE_LEAD_S)
        got = self._profile(TRACE_S)
        host = self._profile(TRACE_HOST_S, host=True)
        got["breakdown"]["idle_gaps"] = host["breakdown"]["idle_gaps"]
        gen.join()
        self._wait("trace", len(reqs), t0 + total + self.tr["drain_s"])
        return got

    def free(self) -> None:
        """Close the Engine (it runs what is queued, then its worker ends),
        end the clients, and take the kept decode outputs to the host."""
        closer = threading.Thread(target=self.engine.close, daemon=True)
        closer.start()
        closer.join(timeout=CLOSE_S)
        self._hand([None] * len(self.clients))
        deadline = time.perf_counter() + 5.0
        for t in self.clients:  # one still waiting on the Engine is left behind
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        for b in self.batches:
            b["tokens"] = b["tokens"].cpu().numpy()
            b["lengths"] = b["lengths"].cpu().numpy()
            b["ids"], b["mask"] = np.asarray(b["ids"]), np.asarray(b["mask"])
            if b["spans"] is not None:
                b["spans"] = (b["spans"].cpu().numpy() if isinstance(b["spans"], torch.Tensor)
                              else np.asarray(b["spans"]))
        del self.engine
        self.tmp.cleanup()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def served(self, r: dict) -> dict | None:
        """What request ``r``'s row was decoded from and produced: its
        prefix and bias words as the decode got them, the ids it returned
        (up to <|endoftext|>), and the ids the model chose (the forced
        <|endoftext|> at the cap is not a choice). None where no decode
        carried it."""
        if "batch" not in r:
            return None
        b, j = self.batches[r["batch"]], r["row"]
        eot = self.tok["eot"]
        n = int(b["lengths"][j])
        chosen = n + 1 if n < r["cap"] else n
        words = []
        if b["spans"] is not None:
            words = [[int(t) for t in s if t != eot] for s in b["spans"][j]]
        return dict(prefix=[int(t) for t in b["ids"][j][b["mask"][j]]],
                    words=[w for w in words if w],
                    returned=[int(t) for t in b["tokens"][j, :n]],
                    chosen=[int(t) for t in b["tokens"][j, :min(chosen, self.max_new)]])

    def sample(self, done: list[dict]) -> list[dict]:
        """The finished request with the most served tokens, and others
        drawn from the seed."""
        longest = max(done, key=lambda r: len(r["echo"]["chosen"]))
        rng = traffic.row_rng(self.seed, 4)
        n = min(self.cell["check_requests"], len(done))
        drawn = [done[i] for i in rng.choice(len(done), n, replace=False)]
        return [longest] + [r for r in drawn if r is not longest][:n - 1]

    def check(self, lowp: str | None = None) -> list[tuple[str, float]]:
        """The numbers compared: ``text_mismatch``, the window's finished
        requests whose text is not the reference's reading of the ids their
        row returned; ``input_mismatch``, those whose row was not decoded
        from the reference's own prefix and bias words for their strings;
        and over the sample, the widest served-token gap and the mean gap
        (``lowp``: the gaps of the tokens a lower-precision reference puts
        first, the control). ``checked`` keeps the tokens judged and the
        share of them that are not the reference's best."""
        eot = self.tok["eot"]
        done = [r for r in self.window_reqs if r["ok"]]
        text_bad = input_bad = 0
        for r in done:
            r["echo"] = e = self.served(r)
            if e is None:
                text_bad, input_bad = text_bad + 1, input_bad + 1
                r["echo"] = dict(chosen=[], prefix=[], words=[])
                continue
            text_bad += r["text"] != arrivals.expected_text(e["returned"], eot)
            input_bad += (e["prefix"] != arrivals.expected_prefix(r, self.tok)
                          or e["words"] != arrivals.expected_words(r))
        reqs = [r for r in self.sample(done) if r["echo"]["chosen"]]
        w, _ = make_weights(self.g, self.seed, self.dev, getattr(torch, self.cfg["dtype"]))
        reference.precise()
        ref = reference.Reference(w, self.g)
        low = reference.Reference(w, self.g, lowp=lowp) if lowp else None
        del w
        widest, total, tokens, off = 0.0, 0.0, 0, 0
        n_samples = self.tr["window_samples"]
        with torch.no_grad():
            for r in reqs:
                prefix = arrivals.expected_prefix(r, self.tok)
                served = r["echo"]["chosen"]
                audio = torch.zeros(1, n_samples, device=self.dev)
                n = min(len(r["audio"]), n_samples)
                audio[0, :n] = torch.from_numpy(r["audio"][:n]).to(self.dev)
                seq = prefix + served[:-1]
                ids = torch.tensor([seq], device=self.dev)
                at = slice(len(prefix) - 1, len(seq))
                mel = reference.log_mel(audio, self.g["n_mels"])
                lg = ref.logits(ids, ref.encode(mel))[0, at]
                pick = low.logits(ids, low.encode(mel))[0, at] if low is not None else None
                gaps = reference.served_gaps(lg, served, prefix, arrivals.expected_words(r),
                                             self.tr["engine"]["bias_boost"], pick)
                widest = max(widest, float(gaps.max()))
                total += float(gaps.sum())
                tokens += len(gaps)
                off += int((gaps > 0).sum())
        self.checked = dict(tokens=tokens, off_best_share=off / max(tokens, 1),
                            requests=len(done))
        return [("served_gap", widest), ("served_gap_mean", total / max(tokens, 1)),
                ("text_mismatch", float(text_bad)), ("input_mismatch", float(input_bad))]
