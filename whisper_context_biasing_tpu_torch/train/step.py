"""The WeightCE training step: forward and backward with microbatch gradient
accumulation, then clipped AdamW; optional encoder freezing and log-mel from
raw audio inside the step, and SpecAugment of the features inside the
step.

The counterpart of the JAX package's ``train/step.py``. The model holds f32
master weights (``build_model(..., train=True)``) and computes in
``cfg.dtype``; with ``cfg.flash_attention`` the encoder, and the decoder at
label lengths of at least ``cfg.flash_decoder_min_seq``, run the flash
forward and backward kernels, and every block runs under ``cfg.remat``.
The step updates the model in place and leaves the averaged gradients in
each parameter's ``.grad``.

Under a (data, model) mesh (``parallel/``) the batch holds this rank's rows
and the model its shard (``shard_batch``, ``shard_params``): the loss's
denominator is the global batch's, the gradients sum over "data" once a
step (after the microbatches), the clip's norm sums the sharded squares
over "model", and AdamW runs on the local shards. The metrics are the
global ones on every rank.

While a ``torch.profiler`` session is active a step is traced
(``utils/profiling.py``): a ``train.step`` span with ``train.to_device``, a
``train.forward`` and a ``train.backward`` a microbatch, and
``train.optimizer`` (the global norm, the clip and the update), each timed
on the card too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import WhisperConfig
from ..models.whisper import Whisper, decode_tokens, encode_audio, forward
from ..ops.mel_kernel import log_mel_spectrogram_fused
from ..parallel.mesh import DATA_AXIS, axis_group
from ..parallel.sharding import sharded_dims
from ..utils.profiling import span
from .augment import SpecAugmentConfig, make_augment_fn
from .loss import weighted_ce_loss
from .optim import AdamW, OptState, global_norm


@dataclass
class TrainState:
    model: Whisper
    opt_state: OptState
    step: int = 0


def init_train_state(model: Whisper, optimizer: AdamW) -> TrainState:
    return TrainState(model, optimizer.init(model.parameters()), 0)


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) if isinstance(v, (np.ndarray, torch.Tensor))
            else v for k, v in batch.items()}


def make_loss_fn(cfg: WhisperConfig, bias_weight: float, use_bias_spans: bool = True,
                 mel_on_device: bool = False, freeze_encoder: bool = False, mesh=None):
    """``loss_fn(model, batch) -> scalar loss``. With ``mel_on_device`` the
    batch carries raw ``audio`` (B, samples) and the mel kernel runs inside
    the step; otherwise it carries ``input_features``. ``freeze_encoder``
    runs the encoder without a graph, so no encoder backward is built. Under
    a ``mesh`` the loss is this rank's share of the global batch's (its sum
    over "data" is the loss)."""
    pad_id = cfg.pad_token_id  # span pad and special-id threshold
    group = axis_group(mesh, DATA_AXIS)

    def loss_fn(model: Whisper, batch: dict) -> torch.Tensor:
        if mel_on_device:
            feats = log_mel_spectrogram_fused(batch["audio"], n_mels=cfg.n_mels)
        else:
            feats = batch["input_features"]
        if freeze_encoder:
            with torch.no_grad():
                enc_out = encode_audio(model, feats)
            logits, _ = decode_tokens(model, batch["decoder_input_ids"], enc_out=enc_out)
        else:
            logits = forward(model, feats, batch["decoder_input_ids"])
        spans = batch.get("bias_spans") if use_bias_spans else None
        return weighted_ce_loss(logits, batch["labels"], spans, bias_weight,
                                span_pad_id=pad_id, special_id_threshold=pad_id, group=group)

    return loss_fn


def _sum_over_data(loss: torch.Tensor, grads: list, group) -> torch.Tensor:
    """The loss shares and the gradients summed over "data", in place, in
    one all-reduce."""
    live = [g for g in grads if g is not None]
    flat = torch.cat([loss.reshape(1).float(), *(g.reshape(-1) for g in live)])
    dist.all_reduce(flat, group=group)
    off = 1
    for g in live:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[0]


def accumulate_microbatch_grads(loss_fn, model: Whisper, batch: dict, grad_accum: int,
                                mesh=None):
    """Mean loss and mean gradients over ``grad_accum`` microbatches: every
    tensor in ``batch`` carries a leading (A, ...) axis (none when
    ``grad_accum`` is 1). Gradients sum in each parameter's ``.grad`` (f32,
    like the masters) and are scaled by 1/A at the end; peak memory is one
    microbatch. Under a ``mesh`` (a ``loss_fn`` of the same mesh) the loss
    and gradients are then summed over "data". Returns (loss, grads aligned
    with ``model.parameters()``, None where a parameter got no gradient)."""
    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    if grad_accum == 1:
        with span("train.forward", dev):
            loss = loss_fn(model, batch)
        with span("train.backward", dev):
            loss.backward()
        loss = loss.detach()
    else:
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(grad_accum):
            with span("train.forward", dev):
                mb_loss = loss_fn(model, {k: v[a] if isinstance(v, torch.Tensor) else v
                                          for k, v in batch.items()})
            with span("train.backward", dev):
                mb_loss.backward()
            loss = loss + mb_loss.detach()
        scale = 1.0 / grad_accum
        loss = loss * scale
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(scale)
    grads = [p.grad for p in model.parameters()]
    group = axis_group(mesh, DATA_AXIS)
    if group is not None:
        loss = _sum_over_data(loss, grads, group)
    return loss, grads


def _check_augment(spec_augment, augment_seed: int, mel_on_device: bool, mesh=None):
    """The step's SpecAugment function, or None; shared with the LoRA step."""
    if spec_augment is None:
        return None
    if mel_on_device:
        raise ValueError("spec_augment needs precomputed input_features "
                         "(mel_on_device computes mel inside the loss)")
    return make_augment_fn(spec_augment, augment_seed, mesh)


def make_train_step(
    cfg: WhisperConfig,
    optimizer: AdamW,
    bias_weight: float = 1.5,
    grad_accum: int = 1,
    freeze_encoder: bool = False,
    use_bias_spans: bool = True,
    mel_on_device: bool = False,
    spec_augment: SpecAugmentConfig | None = None,
    augment_seed: int = 0,
    mesh=None,
):
    """Returns ``step(state, batch) -> (state, {"loss", "grad_norm"})``:
    the model and optimizer state update in place; ``grad_norm`` is the
    global norm of the unclipped gradients. Both metrics are 0-d device
    tensors (reading them syncs). With ``grad_accum > 1`` every tensor in
    ``batch`` carries a leading microbatch axis (A, ...). numpy arrays in
    ``batch`` move to the model's device.

    ``spec_augment`` masks the mel features inside the step (train time
    only; the masks come from ``(augment_seed, state.step)``, so a resume
    draws the same ones). It needs precomputed ``input_features``: with
    ``mel_on_device`` it raises ``ValueError``, as in the JAX package.

    ``mesh``: the batch holds this rank's rows (``shard_batch``) and the
    model its shard (``shard_params``); see the module's docstring."""
    augment = _check_augment(spec_augment, augment_seed, mel_on_device, mesh)
    loss_fn = make_loss_fn(cfg, bias_weight, use_bias_spans, mel_on_device, freeze_encoder,
                           mesh)

    def step(state: TrainState, batch: dict):
        model = state.model
        dev = next(model.parameters()).device
        with span("train.step"):
            with span("train.to_device", dev):
                batch = _on_device(batch, dev)
            if augment is not None:
                batch = augment(batch, state.step)
            loss, grads = accumulate_microbatch_grads(loss_fn, model, batch, grad_accum, mesh)
            with span("train.optimizer", dev):
                tp = model.tp
                gnorm = (global_norm(grads) if tp is None else
                         global_norm(grads, [d is not None for d in sharded_dims(model)],
                                     tp.group))
                frozen = ()
                if freeze_encoder:  # weight decay must not move the encoder either
                    enc = {id(p) for p in model.encoder.parameters()}
                    frozen = [i for i, p in enumerate(model.parameters()) if id(p) in enc]
                optimizer.update_(model.parameters(), grads, state.opt_state, norm=gnorm,
                                  frozen=frozen)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_eval_loss_step(cfg: WhisperConfig, bias_weight: float = 1.5,
                        use_bias_spans: bool = True, mesh=None):
    """``eval_step(model, batch) -> scalar loss`` without a graph; under a
    ``mesh``, of the global batch whose rows the ranks hold."""
    loss_fn = make_loss_fn(cfg, bias_weight, use_bias_spans, mesh=mesh)
    group = axis_group(mesh, DATA_AXIS)

    @torch.no_grad()
    def eval_step(model: Whisper, batch: dict) -> torch.Tensor:
        loss = loss_fn(model, _on_device(batch, next(model.parameters()).device))
        if group is not None:
            dist.all_reduce(loss, group=group)
        return loss

    return eval_step
