"""Training cells: WeightCE fine-tuning through the port's training step.

Set-up builds one training state (f32 masters, the port's AdamW at a
constant learning rate) and one step from ``make_train_step`` (the
configuration's dtype with the mix's ``port_config``, such as flash
attention and remat "full"; log-mel on the card inside the step;
``grad_accum`` microbatches), collates ``STEP_SETS`` steps' rows with the
port's collator, and drives the state through its first
``checked_steps`` steps on rows that all differ: their losses, the first gradient (from the
first moment after one step) and the parameters' change are kept for the
check. The window then runs the same step on the same state, one
optimizer step after another, each ending with the loss on the host.

Once the window has closed and the program's state is freed, the plain
reference follows the same first steps from the same weights and rows,
and the check compares each step's loss, each tensor's first-gradient
norm and each tensor's norm of change.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from core import counts, faults, reference, trace, traffic
from core.weights import make_weights, port_name, to_port


def port():
    from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
    from whisper_context_biasing_tpu_torch.models.config import get_config
    from whisper_context_biasing_tpu_torch.models.convert import build_model
    from whisper_context_biasing_tpu_torch.ops import _build
    from whisper_context_biasing_tpu_torch.train.optim import AdamW
    from whisper_context_biasing_tpu_torch.train.step import init_train_state, make_train_step

    return dict(collator=SpeechSeq2SeqCollator, get_config=get_config, build_model=build_model,
                build=_build, adamw=AdamW, init_state=init_train_state,
                make_step=make_train_step)


def _relative_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst tensor's gap between the program's norm and the
    reference's, over the larger of that tensor's reference norm and the
    median tensor's."""
    names = [k for k in ref if keep is None or keep(k)]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


STEP_SETS = 4   # distinct steps of rows the window cycles through


class Driver:
    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed, self.dev = spec, seed, torch.device(device)
        self.cfg, self.tr, self.cell, self.g = spec["config"], spec["traffic"], spec["cell"], spec["g"]
        self.tok = self.cfg["tokens"]
        self.a, self.b = self.cell["grad_accum"], self.cell["batch"]
        if self.a * self.b != self.tr["rows_per_step"]:
            raise ValueError("a cell's batch x grad_accum must be the traffic's rows_per_step")
        p = self.p = self.take_port()
        self.pcfg = p["get_config"](self.cfg["port_model"], dtype=self.cfg["dtype"],
                                    **self.tr["port_config"])
        w, flat = make_weights(self.g, seed, self.dev, torch.float32)
        self.model = p["build_model"](self.pcfg, to_port(w), device=self.dev, train=True)
        # the initial weights, for the change after the checked steps
        self.w0 = flat.cpu() if self.checks_here() else None
        self.w0_views = {k: (v.storage_offset(), v.shape) for k, v in w.items()}
        del w, flat
        opt = self.tr["optimizer"]
        self.opt = p["adamw"](lambda count: opt["lr"], b1=opt["betas"][0], b2=opt["betas"][1],
                              eps=opt["eps"], weight_decay=opt["weight_decay"],
                              max_grad_norm=opt["max_grad_norm"])
        self.state = p["init_state"](self.model, self.opt)
        self.step = p["make_step"](self.pcfg, self.opt, bias_weight=self.tr["bias_weight"],
                                   grad_accum=self.a, mel_on_device=True, **self.step_options())
        pad = self.tok["label_pad"]
        self.collate = p["collator"](pad_token_id=pad, decoder_start_token_id=self.tok["sot"],
                                     decoder_prev_token_id=self.tok["sop"],
                                     bias_span_pad_id=pad)
        self.shapes = traffic.train_shapes(self.tr)
        self.batches = [self.make_batch(k) for k in range(STEP_SETS)]
        self.seq = self.batches[0]["decoder_input_ids"].shape[-1]
        self.stats: dict = dict(losses=[], walls=[])

    def take_port(self) -> dict:
        """The program's entry points, with the fault that the spec's
        ``fault`` names planted (calibration and tests only)."""
        fault = self.spec.get("fault")
        return faults.TRAIN_ALL[fault](port()) if fault else port()

    def step_options(self) -> dict:
        """Further options of ``make_train_step``."""
        return {}

    def checks_here(self) -> bool:
        """Whether this process judges the run (keeps what the check needs)."""
        return True

    def rows(self, k: int) -> list[dict]:
        return traffic.train_rows(self.tr, self.shapes, self.seed, k, self.tok)

    def make_batch(self, k: int) -> dict:
        return self.collated(self.rows(k))

    def collated(self, rows: list[dict]) -> dict:
        """``rows`` through the port's collator; under ``grad_accum`` every
        array gets its leading microbatch axis."""
        batch = self.collate([dict(audio=r["audio"], labels=r["label"], bias_spans=r["spans"])
                              for r in rows])
        # the collator pads to the 30 s window; a shorter window (a test's) is cut
        batch["audio"] = np.ascontiguousarray(batch["audio"][:, :self.tr["window_samples"]])
        if self.a > 1:
            batch = {k: v.reshape(self.a, len(rows) // self.a, *v.shape[1:])
                     for k, v in batch.items()}
        return batch

    def one_step(self, k: int) -> float:
        with torch.profiler.record_function("bench.step"):
            self.state, m = self.step(self.state, self.batches[k % len(self.batches)])
        with torch.profiler.record_function("bench.loss_to_host"):
            return float(m["loss"])

    def named(self) -> list[tuple[str, torch.Tensor]]:
        return list(self.model.named_parameters())

    def warm_up(self) -> None:
        """The checked steps: each step's loss, the first gradient's norm a
        tensor (its first moment over 1 - beta1 after one step), and the
        norm of each tensor's change after the last."""
        hf = {port_name(k): k for k in self.w0_views}
        b1 = self.tr["optimizer"]["betas"][0]
        self.prog = dict(loss=[], grad1={}, change={})
        for k in range(self.tr["checked_steps"]):
            self.prog["loss"].append(self.one_step(k))
            if k == 0:
                for (name, _), mu in zip(self.named(), self.state.opt_state.mu):
                    self.prog["grad1"][hf[name]] = float((mu / (1 - b1)).norm())
        for name, p in self.named():
            off, shape = self.w0_views[hf[name]]
            p0 = self.w0[off:off + p.numel()].view(shape).to(self.dev)
            self.prog["change"][hf[name]] = float((p.detach() - p0).norm())
        del self.w0

    def audio_s(self) -> float:
        return sum(s["samples"] for s in self.shapes) / self.tr["sample_rate"]

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        k = self.tr["checked_steps"]
        n = 0
        while True:
            self.stats["losses"].append(self.one_step(k))
            k, n = k + 1, n + 1
            wall = time.perf_counter() - t0
            self.stats["walls"].append(wall)
            if wall >= seconds:
                break
        self.wall, self.steps = wall, n
        rows = self.tr["rows_per_step"]
        self.stats["flops"] = n * rows * counts.train_row_flops(self.g, self.seq)
        return dict(train_audio_s_per_s=n * self.audio_s() / wall)

    def attempted(self) -> int:
        return self.steps

    def failed(self) -> int:
        """Window steps whose loss is not a finite number."""
        return sum(not np.isfinite(x) for x in self.stats["losses"])

    def traced(self) -> dict:
        """A few more steps with the device traced, with the bounds of the
        kernel launches their shapes imply; then one with the host traced
        too, whose idle gaps name what the host was doing."""
        n = self.cell.get("trace_steps", 1)
        before = dict(self.p["build"].launches)
        got = trace.profile(lambda: [self.one_step(10_000 + i) for i in range(n)])
        after = dict(self.p["build"].launches)
        host = trace.profile(lambda: self.one_step(10_000 + n), host=True)
        got["breakdown"]["idle_gaps"] = host["breakdown"]["idle_gaps"]
        g, s = self.g, self.seq
        h, dh, t = g["heads"], g["d"] // g["heads"], g["t_audio"]
        # per microbatch, under remat "full" every forward runs twice
        k2 = 2 * g["enc_layers"] * counts.bound_s(*counts.flash_fwd_work(self.b, h, t, t, dh, False))
        k4 = g["enc_layers"] * counts.bound_s(*counts.flash_bwd_work(self.b, h, t, t, dh, False))
        launches2, launches4 = 2 * g["enc_layers"], g["enc_layers"]
        if s >= self.pcfg.flash_decoder_min_seq:
            for tk, causal in ((s, True), (t, False)):
                k2 += 2 * g["dec_layers"] * counts.bound_s(
                    *counts.flash_fwd_work(self.b, h, s, tk, dh, causal))
                k4 += g["dec_layers"] * counts.bound_s(
                    *counts.flash_bwd_work(self.b, h, s, tk, dh, causal))
            launches2 += 4 * g["dec_layers"]
            launches4 += 2 * g["dec_layers"]
        mb = n * self.a
        got["steps"] = n
        got["bounds"] = dict(k2=mb * k2, k4=mb * k4)
        got["expected_launches"] = dict(k2=mb * launches2, k4=mb * launches4)
        got["counted_launches"] = dict(
            k2=after.get("flash_attention", 0) - before.get("flash_attention", 0),
            k4=after.get("flash_attention_bwd", 0) - before.get("flash_attention_bwd", 0))
        return got

    def free(self) -> None:
        del self.model, self.state, self.step, self.opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def ref_parts(self, k: int) -> list[list[dict]]:
        """The rows of checked step ``k``, in parts that the reference
        computes apart and adds: one here."""
        return [self.rows(k)]

    def ref_devices(self) -> list[torch.device]:
        """The devices the reference's parts run on, in turn."""
        return [self.dev]

    def ref_inputs(self, rows: list[dict], ref, dev) -> dict:
        """One part's rows on ``dev``: decoder inputs, targets, span weights
        and the audio in the 30 s window."""
        sot, pad = self.tok["sot"], self.tok["label_pad"]
        inp, tgt = reference.collate_labels([r["label"] for r in rows], sot, pad)
        wts = np.stack([reference.span_weights(tgt[i], r["spans"], self.tr["bias_weight"], pad)
                        for i, r in enumerate(rows)])
        audio = np.zeros((len(rows), self.tr["window_samples"]), np.float32)
        for i, r in enumerate(rows):
            clip = r["audio"][:audio.shape[1]]
            audio[i, :len(clip)] = clip
        on = lambda x: torch.from_numpy(x).to(dev)
        return dict(ref=ref, tgt=tgt, inp=on(inp), y=on(tgt), wts=on(wts), audio=on(audio),
                    total=torch.zeros((), dtype=torch.float64, device=dev))

    def reference_steps(self, lowp: str | None = None) -> dict:
        """The reference through the checked steps from the same weights
        and rows: each step's loss, the first (clipped) gradient's norm a
        tensor, each tensor's change. With several parts (``ref_parts``)
        each device holds a copy of the weights and sums its parts'
        gradients in plain f32, with no collective; the first device adds
        the others' sums, steps, and copies the weights back to them."""
        reference.precise()
        devs = self.ref_devices()
        w, _ = make_weights(self.g, self.seed, devs[0], torch.float32)
        refs = [reference.Reference(w, self.g, lowp=lowp, grad=True)]
        refs += [reference.Reference({n: t.detach().to(d) for n, t in refs[0].w.items()}, self.g,
                                     lowp=lowp, grad=True) for d in devs[1:]]
        o = self.tr["optimizer"]
        opt = reference.AdamW(refs[0].w, o["lr"], o["betas"], o["eps"], o["weight_decay"],
                              o["max_grad_norm"])
        # rows a forward and backward: the float8 control keeps more alive
        chunk = 1 if lowp else self.cell.get("reference_rows", self.b)
        out = dict(loss=[], grad1={}, change={})
        for k in range(self.tr["checked_steps"]):
            parts = [self.ref_inputs(rows, refs[i % len(refs)], devs[i % len(devs)])
                     for i, rows in enumerate(self.ref_parts(k))]
            # each microbatch's valid targets over every part: the loss's denominator
            mb_counts = [float(sum((p["tgt"][a * self.b:(a + 1) * self.b] != reference.IGNORE)
                                   .sum() for p in parts)) for a in range(self.a)]

            def backward(mine: list[dict]) -> None:
                """The forward and backward of one device's parts, chunk by
                chunk: their gradients sum in its copy's ``.grad``."""
                for p in mine:
                    for a in range(self.a):
                        stop = (a + 1) * self.b
                        for c in range(a * self.b, stop, chunk):
                            idx = slice(c, min(c + chunk, stop))
                            ref = p["ref"]
                            lg = ref.logits(p["inp"][idx], ref.encode(
                                reference.log_mel(p["audio"][idx], self.g["n_mels"])))
                            y = p["y"][idx]
                            nll = torch.nn.functional.cross_entropy(
                                lg.flatten(0, 1), y.flatten(), ignore_index=reference.IGNORE,
                                reduction="none").view(y.shape)
                            part = (nll * p["wts"][idx]).sum() / (mb_counts[a] + 1e-8) / self.a
                            part.backward()
                            p["total"] += part.detach().double()
                            del lg, nll, part

            # one host thread a device: the reference's issue keeps one card busy
            by_ref = [[p for p in parts if p["ref"] is r] for r in refs]
            with ThreadPoolExecutor(len(by_ref)) as pool:
                list(pool.map(backward, by_ref))
            out["loss"].append(sum(float(p["total"]) for p in parts))
            del parts
            grads = {n: t.grad for n, t in refs[0].w.items()}
            for r in refs[1:]:
                for n, t in r.w.items():
                    grads[n] += t.grad.to(devs[0])
            clipped = opt.step(grads)
            if k == 0:
                out["grad1"] = {n: float(g.norm()) for n, g in clipped.items()}
            del clipped, grads
            with torch.no_grad():
                for r in refs:
                    for n, t in r.w.items():
                        t.grad = None
                        if r is not refs[0]:
                            t.copy_(refs[0].w[n])
        out["change"] = {n: float((refs[0].w[n].detach() - w[n]).norm()) for n in w}
        return out

    def check(self) -> list[tuple[str, float]]:
        """The numbers compared: the worst step's loss gap (relative), the
        worst tensor's first-gradient gap and change gap (each against the
        larger of its reference norm and the median tensor's). Tensors
        whose reference gradient is under a thousandth of the median
        tensor's move by round-off alone and are left out of the change."""
        return self.compare(self.prog, self.reference_steps())

    def compare(self, prog: dict, ref: dict) -> list[tuple[str, float]]:
        """``check``'s numbers for the readings ``prog`` against ``ref``."""
        loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
        med = float(np.median(list(ref["grad1"].values())))
        moved = lambda n: ref["grad1"][n] >= 1e-3 * med
        return [("loss_gap", loss), ("grad1_gap", _relative_gap(prog["grad1"], ref["grad1"])),
                ("change_gap", _relative_gap(prog["change"], ref["change"], moved))]
