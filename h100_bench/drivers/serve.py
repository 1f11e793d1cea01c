"""Serving cells: biased short-form offline transcription through the
port's greedy decoder.

The window drives, batch after batch in a closed loop, what ``Pipeline``
does with a batch of clips, with a per-row token cap: the clips padded
or trimmed to the 30 s window and stacked on the host (as
``Pipeline.transcribe`` stacks them), the program's ``Pipeline.mel`` (its
staging of the batch on the card and the log-mel frontend), then
``greedy_decode`` on the serving fast path (``FAST_OVERRIDES``) with the
prompts packed as ``decode_batch`` packs them, the bias words as dense
spans (none where the mix has none) and each clip's transcript length as
``forced_eot_at`` (random weights never choose <|endoftext|>). A batch
starts once the tokens of the one before it are on the host.

Once the window has closed, a sample of the finished requests, drawn
from the seed and holding the one with the most served tokens, is judged
against the plain reference: by how much each served token's biased
reference logit lies below the reference's best, the widest gap and the
mean over the sample's served tokens.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from core import counts, reference, trace, traffic
from core.weights import make_weights, to_port


def port():
    """The program's entry points this driver calls."""
    from whisper_context_biasing_tpu_torch.audio import pad_or_trim
    from whisper_context_biasing_tpu_torch.decode.greedy import greedy_decode, pack_prefixes
    from whisper_context_biasing_tpu_torch.models.config import FAST_OVERRIDES, get_config
    from whisper_context_biasing_tpu_torch.models.convert import build_model
    from whisper_context_biasing_tpu_torch.ops import _build
    from whisper_context_biasing_tpu_torch.pipeline import Pipeline

    return dict(pad_or_trim=pad_or_trim, pipeline=Pipeline, greedy=greedy_decode,
                pack=pack_prefixes, fast=FAST_OVERRIDES, get_config=get_config,
                build_model=build_model, build=_build)


def mel_stage(pipeline_cls, model, cfg, device):
    """A ``Pipeline`` around the benchmark's model, whose ``mel`` is the
    program's own: built without ``__init__``, which would load a
    tokenizer and draw its own weights on the host."""
    pipe = pipeline_cls.__new__(pipeline_cls)
    pipe.model, pipe.cfg, pipe.device = model, cfg, device
    return pipe


class Driver:
    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed, self.dev = spec, seed, torch.device(device)
        self.cfg, self.tr, self.cell, self.g = spec["config"], spec["traffic"], spec["cell"], spec["g"]
        self.tok = self.cfg["tokens"]
        self.p = port()
        self.pcfg = self.p["get_config"](self.cfg["port_model"], **self.p["fast"],
                                         dtype=self.cfg["dtype"])
        w, flat = make_weights(self.g, seed, self.dev, getattr(torch, self.cfg["dtype"]))
        self.model = self.p["build_model"](self.pcfg, to_port(w), device=self.dev)
        del w, flat
        self.shapes = traffic.serve_shapes(self.tr)
        self.audio = traffic.audio_sets(self.tr, self.shapes, seed)
        self.pipe = mel_stage(self.p["pipeline"], self.model, self.pcfg, self.dev)
        self.records: list[dict] = []
        self.stats = dict(mel_ms=[], encode_ms=[], decode_ms=[], steps=[], flops=0.0, walls=[])

    def prefix(self, row: dict) -> list[int]:
        """<|startofprev|> and the context where the row has one, then the
        start of the transcript."""
        prev = [self.tok["sop"]] + row["ctx"] if row["ctx"] else []
        return prev + list(self.tok["prompt_start"])

    def batch(self, k: int) -> dict:
        """Batch ``k``: host stacking, ``Pipeline.mel``, greedy decode,
        tokens to the host. Returns its answers and timings."""
        b = traffic.serve_batch(self.tr, self.shapes, self.seed, k)
        clips = [self.audio[b["audio_set"]][r["shape"]] for r in b["rows"]]
        with torch.profiler.record_function("bench.stack"):
            n = self.tr["window_samples"]
            stacked = np.stack([self.p["pad_or_trim"](c, n) for c in clips])
        timed = self.dev.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with torch.profiler.record_function("bench.mel"):
            feats = self.pipe.mel(stacked)
        if timed:
            ev[1].record()
        eot = self.tok["eot"]
        ids, mask = self.p["pack"]([self.prefix(r) for r in b["rows"]], eot)
        spans = traffic.dense_spans([r["words"] for r in b["rows"]], eot)
        caps = np.array([r["cap"] for r in b["rows"]], np.int64)
        timings: dict = {}
        with torch.profiler.record_function("bench.decode"):
            res = self.p["greedy"](self.model, feats, ids, mask, max_new=self.tr["max_new"],
                                   eot_id=eot, bias_spans=spans,
                                   bias_boost=self.tr["bias_boost"], span_pad_id=eot,
                                   forced_eot_at=caps, device=self.dev, timings=timings)
        with torch.profiler.record_function("bench.tokens_to_host"):
            toks = res.tokens.cpu().numpy()
            lens = res.lengths.cpu().numpy()
        timings["mel_ms"] = ev[0].elapsed_time(ev[1]) if timed else None
        return dict(batch=b, tokens=toks, lengths=lens, timings=timings,
                    prefix_len=ids.shape[1])

    def keep(self, rec: dict) -> None:
        """A window batch's timings, work and answers."""
        t = rec["timings"]
        for key in ("mel_ms", "encode_ms", "decode_ms", "steps"):
            if t[key] is not None:
                self.stats[key].append(t[key])
        served = np.minimum(rec["lengths"] + 1, self.tr["max_new"])
        self.stats["flops"] += sum(counts.serve_row_flops(self.g, rec["prefix_len"], int(s))
                                   for s in served)
        self.records.append(rec)

    def audio_s(self) -> float:
        return sum(s["samples"] for s in self.shapes) / self.tr["sample_rate"]

    def warm_up(self) -> None:
        self.batch(20_000)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        k = 0
        while True:
            self.keep(self.batch(k))
            k += 1
            wall = time.perf_counter() - t0
            self.stats["walls"].append(wall)
            if wall >= seconds:
                break
        self.wall = wall
        return dict(serve_audio_s_per_s=k * self.audio_s() / wall)

    def attempted(self) -> int:
        return len(self.records) * self.tr["batch"]

    def failed(self) -> int:
        """Requests of the window with no answer: rows a batch did not
        return."""
        return sum(self.tr["batch"] - len(r["lengths"]) for r in self.records)

    def traced(self) -> dict:
        """One more batch with the device traced, with the bounds of the
        kernel launches its shapes imply; then one with the host traced
        too, whose idle gaps name what the host was doing."""
        n = 1
        before = dict(self.p["build"].launches)
        recs: list[dict] = []
        got = trace.profile(lambda: recs.append(self.batch(10_000)))
        steps = [r["timings"]["steps"] for r in recs]
        after = dict(self.p["build"].launches)
        host = trace.profile(lambda: self.batch(10_001), host=True)
        got["breakdown"]["idle_gaps"] = host["breakdown"]["idle_gaps"]
        g, b = self.g, self.tr["batch"]
        dh = g["d"] // g["heads"]
        t_pad = -(-g["t_audio"] // 128) * 128
        k2 = n * g["enc_layers"] * counts.bound_s(
            *counts.flash_fwd_work(b, g["heads"], g["t_audio"], g["t_audio"], dh, False))
        k3 = sum(steps) * g["dec_layers"] * counts.bound_s(
            *counts.quant_cross_work(b, g["t_audio"], t_pad, g["d"]))
        got["bounds"] = dict(k2=k2, k3=k3)
        got["expected_launches"] = dict(k2=n * g["enc_layers"], k3=sum(steps) * g["dec_layers"])
        got["counted_launches"] = dict(
            k2=after.get("flash_attention", 0) - before.get("flash_attention", 0),
            k3=after.get("quant_cross_attention", 0) - before.get("quant_cross_attention", 0))
        return got

    def free(self) -> None:
        del self.model, self.pipe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def sample(self) -> list[tuple[int, int]]:
        """(record, row) pairs: the request with the most served tokens and
        others drawn from the seed."""
        pairs = [(i, j) for i, r in enumerate(self.records) for j in range(len(r["lengths"]))]
        longest = max(pairs, key=lambda p: int(self.records[p[0]]["lengths"][p[1]]))
        rng = traffic.row_rng(self.seed, 4)
        n = min(self.cell["check_requests"], len(pairs))
        drawn = [pairs[i] for i in rng.choice(len(pairs), n, replace=False)]
        return [longest] + [p for p in drawn if p != longest][:n - 1]

    def judged(self, i: int, j: int) -> dict:
        """One request's inputs and the tokens the model chose (the forced
        <|endoftext|> at the cap is not a choice)."""
        rec = self.records[i]
        row = rec["batch"]["rows"][j]
        n = int(rec["lengths"][j])
        chosen = n + 1 if n < row["cap"] else n  # an <|endoftext|> it chose itself
        toks = [int(x) for x in rec["tokens"][j, :min(chosen, self.tr["max_new"])]]
        clip = self.audio[rec["batch"]["audio_set"]][row["shape"]]
        return dict(prefix=self.prefix(row), served=toks, words=row["words"], clip=clip)

    def check(self, lowp: str | None = None) -> list[tuple[str, float]]:
        """The numbers compared: the widest served-token gap over the
        sample, and the mean gap over its served tokens (``lowp``: the gaps
        of the tokens a lower-precision reference puts first, the control).
        ``checked`` keeps the tokens judged and the share of them that are
        not the reference's best."""
        reqs = [self.judged(i, j) for i, j in self.sample()]
        w, _ = make_weights(self.g, self.seed, self.dev, getattr(torch, self.cfg["dtype"]))
        reference.precise()
        ref = reference.Reference(w, self.g)
        low = reference.Reference(w, self.g, lowp=lowp) if lowp else None
        del w
        widest, total, tokens, off = 0.0, 0.0, 0, 0
        with torch.no_grad():
            for r in reqs:
                audio = torch.zeros(1, self.tr["window_samples"], device=self.dev)
                n = min(len(r["clip"]), audio.shape[1])
                audio[0, :n] = torch.from_numpy(r["clip"][:n]).to(self.dev)
                seq = r["prefix"] + r["served"][:-1]
                ids = torch.tensor([seq], device=self.dev)
                at = slice(len(r["prefix"]) - 1, len(seq))
                mel = reference.log_mel(audio, self.g["n_mels"])
                lg = ref.logits(ids, ref.encode(mel))[0, at]
                pick = None
                if low is not None:
                    pick = low.logits(ids, low.encode(mel))[0, at]
                gaps = reference.served_gaps(lg, r["served"], r["prefix"], r["words"],
                                             self.tr["bias_boost"], pick)
                widest = max(widest, float(gaps.max()))
                total += float(gaps.sum())
                tokens += len(gaps)
                off += int((gaps > 0).sum())
        self.checked = dict(tokens=tokens, off_best_share=off / tokens)
        return [("served_gap", widest), ("served_gap_mean", total / tokens)]
