"""Draft-model distillation for speculative decoding.

The counterpart of the JAX package's ``train/distill.py``. Speculative
throughput scales with the draft/target top-1 agreement (the acceptance
rate), so the objective matches the frozen target's softened distribution:

  loss = (1 - hard_weight) * T^2 * KL(teacher_T || student_T)
         + hard_weight * CE(student, labels)

in f32, over the valid label positions. The teacher (the serving target)
runs under ``torch.no_grad()``; the per-batch top-1 agreement between the
two argmaxes, the quantity ``speculative_greedy_decode`` accepts on, is
reported every step and picks the best checkpoint.

  * one step: the teacher forward, the student forward and backward, the
    port's clipped AdamW; microbatches accumulate through
    ``accumulate_microbatch_grads`` as in ``step.py``
  * mismatched mel frontends (an 80-mel draft for a 128-mel large-v3
    target): the batch carries raw audio and the mel kernel runs once per
    distinct ``n_mels`` inside the step (``_features_for``)
  * the pair must share a token space (verification compares token ids)

On one device only: ``mesh``, ``shard_fn``, ``eval_shard_fn`` and the Orbax
backend raise ``NotImplementedError`` naming ROADMAP Queue A.9. ``mel_interpret``
is the JAX signature's (Pallas interpret mode) and changes nothing here: the
mel wrapper runs its plain version for CPU tensors.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..data.collator import IGNORE_INDEX
from ..data.prefetch import BatchLoader, prefetch_to_device
from ..models.config import WhisperConfig
from ..models.convert import build_model
from ..models.whisper import Whisper, forward
from ..ops.mel_kernel import log_mel_spectrogram_fused
from ..utils.logging import RunLogger
from .checkpoint import save_checkpoint
from .optim import AdamW, global_norm, make_optimizer
from .step import TrainState, _on_device, accumulate_microbatch_grads, init_train_state

_A9 = "is not ported yet (ROADMAP Queue A.9)"


def _features_for(cfg_draft: WhisperConfig, cfg_target: WhisperConfig, batch: dict):
    """(student feats, teacher feats) from a batch that carries either
    precomputed ``input_features`` (the same n_mels for both; an optional
    ``input_features_draft``) or raw ``audio`` (the mel kernel once per
    distinct n_mels)."""
    if "audio" in batch:
        feats_t = log_mel_spectrogram_fused(batch["audio"], n_mels=cfg_target.n_mels)
        if cfg_draft.n_mels == cfg_target.n_mels:
            return feats_t, feats_t
        return log_mel_spectrogram_fused(batch["audio"], n_mels=cfg_draft.n_mels), feats_t
    feats = batch["input_features"]
    return batch.get("input_features_draft", feats), feats


def make_distill_loss_fn(cfg_draft: WhisperConfig, cfg_target: WhisperConfig,
                         temperature: float = 2.0, hard_weight: float = 0.5,
                         mel_interpret: bool = False):
    """``loss_fn(student, teacher, batch) -> (loss, aux)`` with aux
    ``{soft, hard, agreement}`` averaged over valid label positions; the
    loss is differentiable in the student only."""
    if cfg_draft.n_vocab != cfg_target.n_vocab:
        raise ValueError(
            f"draft/target vocab mismatch ({cfg_draft.n_vocab} vs "
            f"{cfg_target.n_vocab}): speculative verification compares token "
            "ids, so the pair must share a tokenizer")
    temp = float(temperature)
    hw = float(hard_weight)

    def loss_fn(student: Whisper, teacher: Whisper, batch: dict):
        feats_d, feats_t = _features_for(cfg_draft, cfg_target, batch)
        dec = batch["decoder_input_ids"]
        labels = batch["labels"].to(torch.int64)
        with torch.no_grad():
            t32 = forward(teacher, feats_t, dec).float()
        s32 = forward(student, feats_d, dec).float()

        valid = labels != IGNORE_INDEX
        nvalid = valid.sum().float() + 1e-8
        # softened KL(teacher || student), Hinton's T^2 keeps gradient
        # magnitudes comparable across temperatures
        t_logp = torch.log_softmax(t32 / temp, dim=-1)
        s_logp = torch.log_softmax(s32 / temp, dim=-1)
        kl = (t_logp.exp() * (t_logp - s_logp)).sum(dim=-1)  # (B, S)
        soft = (kl * valid).sum() / nvalid * (temp * temp)
        # hard CE against the labels (keeps the student honest where the
        # teacher itself is wrong)
        safe = torch.where(valid, labels, 0)
        nll = -torch.log_softmax(s32, dim=-1).gather(-1, safe[..., None])[..., 0]
        hard = (nll * valid).sum() / nvalid
        loss = (1.0 - hw) * soft + hw * hard
        agree = ((s32.argmax(-1) == t32.argmax(-1)) & valid).sum() / nvalid
        return loss, {"soft": soft.detach(), "hard": hard.detach(), "agreement": agree}

    return loss_fn


def make_distill_step(cfg_draft: WhisperConfig, cfg_target: WhisperConfig, optimizer: AdamW,
                      temperature: float = 2.0, hard_weight: float = 0.5, grad_accum: int = 1,
                      donate: bool = True, mel_interpret: bool = False):
    """Returns ``step(state, teacher, batch) -> (state, metrics)``: ``state``
    (``init_train_state``) holds the student, updated in place; the teacher
    rides along frozen. Metrics: loss, grad_norm, soft, hard, agreement
    (0-d tensors). With ``grad_accum > 1`` every tensor in ``batch`` carries
    a leading microbatch axis. ``donate`` is the JAX signature's and changes
    nothing here."""
    loss_fn = make_distill_loss_fn(cfg_draft, cfg_target, temperature, hard_weight)

    def step(state: TrainState, teacher: Whisper, batch: dict):
        student = state.model
        batch = _on_device(batch, next(student.parameters()).device)
        auxes = []

        def loss_only(model, mb):
            loss, aux = loss_fn(model, teacher, mb)
            auxes.append(aux)
            return loss

        loss, grads = accumulate_microbatch_grads(loss_only, student, batch, grad_accum)
        aux = {k: torch.stack([a[k] for a in auxes]).sum() / grad_accum for k in auxes[0]}
        norm = global_norm(grads)
        optimizer.update_(student.parameters(), grads, state.opt_state, norm=norm)
        state.step += 1
        return state, {"loss": loss, "grad_norm": norm, **aux}

    return step


def make_agreement_step(cfg_draft: WhisperConfig, cfg_target: WhisperConfig,
                        temperature: float = 2.0, hard_weight: float = 0.5,
                        mel_interpret: bool = False):
    """Forward-only evaluation: ``eval_step(student, teacher, batch)`` ->
    ``{loss, soft, hard, agreement}`` for one batch (the dev-set acceptance
    probe)."""
    loss_fn = make_distill_loss_fn(cfg_draft, cfg_target, temperature, hard_weight)

    @torch.no_grad()
    def eval_step(student: Whisper, teacher: Whisper, batch: dict) -> dict:
        loss, aux = loss_fn(student, teacher,
                            _on_device(batch, next(student.parameters()).device))
        return {"loss": loss, **aux}

    return eval_step


@dataclass
class DistillConfig:
    output_dir: str
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4
    num_train_epochs: float = 3
    warmup_steps: int = 50
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    temperature: float = 2.0
    hard_weight: float = 0.5
    eval_steps: int = 200
    save_steps: int = 200
    logging_steps: int = 50
    eval_batches: int = 16          # dev batches per acceptance probe
    save_total_limit: int = 2
    seed: int = 42
    mel_interpret: bool = False     # the JAX signature's; unused here
    checkpoint_backend: str = "npz"  # "orbax" is not ported (ROADMAP A.9)


def distill_and_evaluate(
    cfg_draft: WhisperConfig,
    params_draft,
    cfg_target: WhisperConfig,
    params_target,
    data_train,
    data_eval,
    collator,
    dcfg: DistillConfig,
    shard_fn=None,
    eval_shard_fn=None,
    mesh=None,
    device="cuda",
):
    """Train the student against the frozen teacher on ``device``; returns
    ``(student model, log_history)``. ``params_draft`` and ``params_target``
    are state dicts (None: the seeded init); the student trains f32
    masters, the teacher serves in the compute dtype. Checkpoints carry
    ``eval_agreement`` (higher is better) and ``eval_disagreement``, which
    retention minimizes; the best-agreement step is in the log."""
    if mesh is not None or shard_fn is not None or eval_shard_fn is not None:
        raise NotImplementedError(f"sharded distillation {_A9}")
    if dcfg.checkpoint_backend == "orbax":
        raise NotImplementedError(f"the Orbax checkpoint backend {_A9}")
    device = resolve_device(device)
    accum = dcfg.gradient_accumulation_steps
    steps_per_epoch = max(1, len(data_train) // (dcfg.per_device_train_batch_size * accum))
    total_steps = int(steps_per_epoch * dcfg.num_train_epochs)

    optimizer = make_optimizer(
        peak_lr=dcfg.learning_rate, total_steps=total_steps,
        warmup_steps=dcfg.warmup_steps, weight_decay=dcfg.weight_decay,
        max_grad_norm=dcfg.max_grad_norm)
    student = build_model(cfg_draft, params_draft, seed=dcfg.seed + 1, device=device, train=True)
    teacher = build_model(cfg_target, params_target, seed=dcfg.seed, device=device)
    state = init_train_state(student, optimizer)
    step_fn = make_distill_step(cfg_draft, cfg_target, optimizer, temperature=dcfg.temperature,
                                hard_weight=dcfg.hard_weight, grad_accum=accum)
    eval_fn = make_agreement_step(cfg_draft, cfg_target, temperature=dcfg.temperature,
                                  hard_weight=dcfg.hard_weight)

    loader = BatchLoader(data_train, collator,
                         batch_size=dcfg.per_device_train_batch_size * accum,
                         shuffle=True, seed=dcfg.seed, drop_last=True)

    def reshape_accum(batch):
        if accum <= 1:
            return batch
        return {k: v.reshape(accum, dcfg.per_device_train_batch_size, *v.shape[1:])
                for k, v in batch.items()}

    eval_bs = dcfg.per_device_train_batch_size

    def pad_rows(b):
        # cycle-pad a final partial batch to the eval batch size, as JAX
        # does (duplicated rows bias the probe's mean negligibly; it is a
        # selection signal, not a reported metric)
        n0 = next(iter(b.values())).shape[0]
        if n0 == eval_bs:
            return b
        idx = np.arange(eval_bs) % n0
        return {k: v[idx] for k, v in b.items()}

    def probe_agreement():
        ev = BatchLoader(data_eval, collator, batch_size=eval_bs, shuffle=False,
                         drop_last=False)
        tot, n = 0.0, 0
        for i, b in enumerate(ev):
            if i >= dcfg.eval_batches:
                break
            tot += float(eval_fn(state.model, teacher, pad_rows(b))["agreement"])
            n += 1
        return tot / max(n, 1)

    os.makedirs(dcfg.output_dir, exist_ok=True)
    logger = RunLogger(dcfg.output_dir)
    log_history: list[dict] = []
    best = {"agreement": -1.0, "step": -1}
    last_eval: tuple[float, int] | None = None
    gstep = 0
    t0 = time.time()

    def batches():
        for raw in loader:
            yield reshape_accum(raw)

    for epoch in range(int(np.ceil(dcfg.num_train_epochs))):
        if gstep >= total_steps:
            break
        for batch in prefetch_to_device(batches(), size=2, device=device):
            if gstep >= total_steps:
                break
            state, metrics = step_fn(state, teacher, batch)
            gstep += 1
            if gstep % dcfg.logging_steps == 0 or gstep == total_steps:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(step=gstep, epoch=epoch, wall_s=round(time.time() - t0, 1))
                log_history.append(row)
                logger.log(row)
            if gstep % dcfg.eval_steps == 0 or gstep == total_steps:
                acc = probe_agreement()
                row = {"step": gstep, "eval_agreement": acc}
                log_history.append(row)
                logger.log(row)
                last_eval = (acc, gstep)
                if acc > best["agreement"]:
                    best = {"agreement": acc, "step": gstep}
            if gstep % dcfg.save_steps == 0 or gstep == total_steps:
                meta = {"log_history": list(log_history)}
                if last_eval is not None:
                    # train/loop.py's attribution contract: the stamp carries
                    # the step the metric was measured at; retention
                    # minimizes its key, so 1 - agreement rides along
                    acc, estep = last_eval
                    meta.update(eval_agreement=acc, eval_disagreement=1.0 - acc,
                                eval_step=estep)
                save_checkpoint(dcfg.output_dir, gstep, state.model, state.opt_state,
                                metadata=meta, keep=dcfg.save_total_limit,
                                best_metric_key="eval_disagreement")

    row = {"best_agreement": best["agreement"], "best_step": best["step"],
           "total_steps": gstep}
    log_history.append(row)
    logger.log(row)
    return state.model, log_history
