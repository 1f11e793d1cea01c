"""Medusa head training: fit the multi-token prediction heads.

The counterpart of the JAX package's ``train/medusa.py``. The heads
(``models/medusa.py``) train teacher-forced on the corpus: the frozen base
model gives the decoder's final hidden states (under ``no_grad``), and head
j learns to predict the token ``j`` positions past the base model's own
next-token target, ``labels[t+j]`` from the hidden at position ``t``. Only
the K·d² head parameters train, with the port's clipped AdamW
(``train/optim.py``).

The K heads' losses are computed one head at a time (as JAX's ``lax.map``
does), each under ``torch.utils.checkpoint``, so one head's (B, S, V) f32
logits exist at a time, in the backward too: all K at once at base.en,
8 x 448 tokens, would be about 3 GB.

Per-head top-1 accuracy on dev is the metric that matters: head j's
accuracy is the probability its proposal survives verification at depth j,
so the expected accepted run per round is ``1 + sum_j prod_{i<=j} acc_i``
(``expected_tokens_per_round``)."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.prefetch import BatchLoader, prefetch_to_device
from ..models.config import WhisperConfig
from ..models.medusa import medusa_head_logits, save_medusa
from ..models.whisper import Whisper, forward_hidden
from ..utils.logging import RunLogger
from .optim import AdamW, global_norm, make_optimizer
from .step import TrainState, _on_device

IGNORE = -100


def make_medusa_loss_fn(cfg: WhisperConfig, n_heads: int):
    """``loss_fn(medusa, base_params, batch) -> (loss, aux)`` with aux
    ``{"head_acc": (K,) f32}``: masked CE and accuracy per head, the loss
    differentiable in the head tensors only (``base_params``, the base
    ``Whisper``, runs under ``no_grad``)."""

    def loss_fn(medusa: dict, base_params: Whisper, batch: dict):
        with torch.no_grad():
            _, hid = forward_hidden(base_params, batch["input_features"],
                                    batch["decoder_input_ids"])
        labels = batch["labels"].to(torch.int64)  # (B, S): target for input pos t
        s = labels.shape[1]

        def head(w, b, j):
            # the hidden at t predicts labels[t + j]
            lgj = medusa_head_logits(base_params, w, b, hid[:, : s - j]).float()
            tgt = labels[:, j:]
            valid = tgt != IGNORE
            nvalid = valid.sum().float() + 1e-8
            safe = torch.where(valid, tgt, 0)
            nll = -torch.log_softmax(lgj, dim=-1).gather(-1, safe[..., None])[..., 0]
            acc = ((lgj.argmax(-1) == safe) & valid).sum() / nvalid
            return (nll * valid).sum() / nvalid, acc.detach()

        total = torch.zeros((), dtype=torch.float32, device=hid.device)
        accs = []
        for j in range(1, n_heads + 1):
            w, b = medusa["w"][j - 1], medusa["b"][j - 1]
            if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
                loss_j, acc = checkpoint(head, w, b, j, use_reentrant=False)
            else:
                loss_j, acc = head(w, b, j)
            total = total + loss_j
            accs.append(acc)
        return total / n_heads, {"head_acc": torch.stack(accs)}

    return loss_fn


def init_medusa_state(medusa: dict, optimizer: AdamW) -> TrainState:
    """The training state of the head dict ``medusa`` (its ``w`` and ``b``,
    in that order, are the optimizer's parameters)."""
    return TrainState(medusa, optimizer.init([medusa["w"], medusa["b"]]), 0)


def make_medusa_train_step(cfg: WhisperConfig, optimizer: AdamW, n_heads: int,
                           donate: bool = True):
    """``step(state, base_params, batch) -> (state, metrics)``: ``state``
    (``init_medusa_state``) is a ``TrainState`` whose ``model`` is the head
    dict, updated in place;
    the base is frozen. ``donate`` is the JAX signature's (buffer donation)
    and changes nothing here."""
    loss_fn = make_medusa_loss_fn(cfg, n_heads)

    def step(state: TrainState, base_params: Whisper, batch: dict):
        heads = state.model
        params = [heads["w"], heads["b"]]
        for p in params:
            p.requires_grad_(True)
        batch = _on_device(batch, heads["w"].device)
        loss, aux = loss_fn(heads, base_params, batch)
        grads = torch.autograd.grad(loss, params)
        norm = global_norm(grads)
        for p in params:
            p.requires_grad_(False)
        opt_state = optimizer.update_(params, grads, state.opt_state, norm=norm)
        return TrainState(heads, opt_state, state.step + 1), {
            "loss": loss.detach(), "grad_norm": norm, **aux}

    return step


def expected_tokens_per_round(head_acc) -> float:
    """1 + sum_j prod_{i<=j} acc_i: the decode-speed predictor (each round
    always advances the verified correction plus the accepted run)."""
    run = 1.0
    total = 1.0
    for a in np.asarray(head_acc, np.float64):
        run *= float(a)
        total += run
    return total


@dataclass
class MedusaConfig:
    output_dir: str
    n_heads: int = 4
    per_device_train_batch_size: int = 8
    learning_rate: float = 1e-3
    num_train_epochs: float = 2
    warmup_steps: int = 50
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    eval_steps: int = 200
    logging_steps: int = 50
    eval_batches: int = 16
    seed: int = 42
    n_chains: int = 1       # stamped into medusa.npz: the decode-time chain
                            # branching width (decode/medusa.py n_chains)


def train_medusa_heads(
    cfg: WhisperConfig,
    base_params: Whisper,
    medusa: dict,
    data_train,
    data_eval,
    collator,
    mcfg: MedusaConfig,
):
    """Trains the heads on ``base_params``'s device; returns ``(medusa,
    log_history)`` and writes ``medusa.npz`` and ``medusa_results.json``
    into ``output_dir``."""
    device = next(base_params.parameters()).device
    steps_per_epoch = max(1, len(data_train) // mcfg.per_device_train_batch_size)
    total_steps = int(steps_per_epoch * mcfg.num_train_epochs)
    optimizer = make_optimizer(
        peak_lr=mcfg.learning_rate, total_steps=total_steps,
        warmup_steps=mcfg.warmup_steps, weight_decay=mcfg.weight_decay,
        max_grad_norm=mcfg.max_grad_norm)
    heads = {k: torch.as_tensor(medusa[k], dtype=torch.float32).to(device).clone()
             for k in ("w", "b")}
    state = init_medusa_state(heads, optimizer)
    step_fn = make_medusa_train_step(cfg, optimizer, mcfg.n_heads)
    eval_loss = make_medusa_loss_fn(cfg, mcfg.n_heads)

    loader = BatchLoader(data_train, collator, batch_size=mcfg.per_device_train_batch_size,
                         shuffle=True, seed=mcfg.seed, drop_last=True)

    @torch.no_grad()
    def probe():
        ev = BatchLoader(data_eval, collator, batch_size=mcfg.per_device_train_batch_size,
                         shuffle=False, drop_last=True)
        accs, n = 0.0, 0
        for i, batch in enumerate(ev):
            if i >= mcfg.eval_batches:
                break
            _, aux = eval_loss(state.model, base_params, _on_device(batch, device))
            accs = accs + aux["head_acc"].cpu().numpy()
            n += 1
        return (accs / n) if n else np.zeros(mcfg.n_heads)

    os.makedirs(mcfg.output_dir, exist_ok=True)
    logger = RunLogger(mcfg.output_dir, filename="medusa_log.jsonl")
    log_history: list[dict] = []
    gstep = 0
    last_probe_step = -1
    acc = np.zeros(mcfg.n_heads)
    t0 = time.time()
    for _ in range(int(np.ceil(mcfg.num_train_epochs))):
        if gstep >= total_steps:
            break
        for batch in prefetch_to_device(iter(loader), device=device):
            if gstep >= total_steps:
                break
            state, m = step_fn(state, base_params, batch)
            gstep += 1
            if gstep % mcfg.logging_steps == 0 or gstep == total_steps:
                row = {"step": gstep, "loss": float(m["loss"]),
                       "head_acc": [round(float(a), 4) for a in m["head_acc"].cpu().numpy()],
                       "wall_s": round(time.time() - t0, 1)}
                log_history.append(row)
                logger.log(row)
            if gstep % mcfg.eval_steps == 0 or gstep == total_steps:
                acc = probe()
                last_probe_step = gstep
                row = {"step": gstep, "eval_head_acc": [round(float(a), 4) for a in acc],
                       "eval_tokens_per_round": round(expected_tokens_per_round(acc), 3)}
                log_history.append(row)
                logger.log(row)

    if last_probe_step != gstep:  # normal exits probe at total_steps already
        acc = probe()
    summary = {"n_heads": mcfg.n_heads, "total_steps": gstep,
               "eval_head_acc": [round(float(a), 4) for a in acc],
               "eval_tokens_per_round": round(expected_tokens_per_round(acc), 3)}
    to_save = dict(state.model)
    if mcfg.n_chains > 1:
        to_save["n_chains"] = mcfg.n_chains
    save_medusa(os.path.join(mcfg.output_dir, "medusa.npz"), to_save)
    with open(os.path.join(mcfg.output_dir, "medusa_results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log_history.append(summary)
    logger.log(summary)
    return state.model, log_history
