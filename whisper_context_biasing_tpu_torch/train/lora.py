"""LoRA fine-tuning: low-rank adapters over the attention projections.

The counterpart of the JAX package's ``train/lora.py``. The reference
fine-tunes every weight (HF Seq2SeqTrainer over the full module,
scripts/train.py:225-273); LoRA (Hu et al. 2021) trains rank-``r``
factors per target projection instead, with the frozen base weights
entering as ``W + (alpha/r)·A@B``.

The adapters keep the JAX package's tree layout, stacked over layers:
``lora[top][blk][t] = {"a": (L, d, r), "b": (L, r, e)}`` for ``top/blk`` in
encoder/attn, decoder/self_attn and decoder/cross_attn and ``t`` in the
targets (``wq``, ``wv``), so a JAX adapter checkpoint loads unchanged. The
port's projections are ``nn.Linear`` weights (out, in), so the merged
weight of layer l is ``W_l + (alpha/r)·(A_l @ B_l)ᵀ``, computed on the f32
masters before the compute-dtype cast at each use, as JAX merges and then
casts.

The step swaps the merged weights into the frozen base model with
``torch.func.functional_call`` for the whole forward and backward of every
microbatch (so a block recomputed under ``remat="full"`` replays the same
merged weights), takes the gradients of the merged weights, and carries
them to A and B through the merge once a step. The model code and its
kernels are untouched: the merged model runs the flash kernels and, under
``fused_ln``, the fused LayerNorm+matmul, whose ``[Wq|Wk|Wv]`` is built
from the swapped weights at each call.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..models.config import WhisperConfig
from ..models.convert import build_model
from ..models.whisper import Whisper
from .augment import SpecAugmentConfig
from .checkpoint import _flatten, _unflatten
from .optim import AdamW, OptState, global_norm
from .step import (
    TrainState,
    _check_augment,
    _on_device,
    accumulate_microbatch_grads,
    make_loss_fn,
)

# every attention block of the model, in the JAX params tree's names
_BLOCKS = (("encoder", "attn"), ("decoder", "self_attn"), ("decoder", "cross_attn"))
DEFAULT_TARGETS = ("wq", "wv")  # the LoRA paper's best cost/quality point
_LINEAR = {"wq": "query", "wk": "key", "wv": "value", "wo": "out"}


def _weight_name(top: str, i: int, blk: str, t: str) -> str:
    return f"{top}.blocks.{i}.{blk}.{_LINEAR[t]}.weight"


def _leaves(lora: dict):
    """(path, tensor) of every adapter tensor, in the JAX tree's leaf order
    (sorted keys), the order of the optimizer state and of a checkpoint."""
    for top in sorted(lora):
        for blk in sorted(lora[top]):
            for t in sorted(lora[top][blk]):
                for ab in ("a", "b"):
                    yield (top, blk, t, ab), lora[top][blk][t][ab]


def init_lora_params(model: Whisper, rank: int, generator: torch.Generator | None = None,
                     targets: tuple[str, ...] = DEFAULT_TARGETS,
                     include_encoder: bool = True) -> dict:
    """Adapter tree over ``model``'s attention projections: ``a`` (L, d, r)
    normal / sqrt(d), drawn from ``generator`` (a CPU one seeded 0 when
    None; other numbers than ``jax.random``'s for one seed), ``b`` (L, r, e)
    zeros, so the merged model starts exactly at the base weights; f32 on
    the model's device. ``include_encoder=False`` adapts the decoder only
    (the LoRA analog of the reference's freeze_encoder())."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    generator = generator or torch.Generator().manual_seed(0)
    device = next(model.parameters()).device
    lora: dict = {}
    for top, blk in _BLOCKS:
        if not include_encoder and top == "encoder":
            continue
        blocks = getattr(model, top).blocks
        for t in targets:
            e, d = getattr(getattr(blocks[0], blk), _LINEAR[t]).weight.shape
            a = torch.randn((len(blocks), d, rank), generator=generator,
                            device=generator.device) / math.sqrt(d)
            b = torch.zeros((len(blocks), rank, e))
            lora.setdefault(top, {}).setdefault(blk, {})[t] = {
                "a": a.to(device), "b": b.to(device)}
    return lora


def lora_weights(model: Whisper, lora: dict, alpha: float = 16.0) -> dict[str, torch.Tensor]:
    """The adapted projections' merged weights by parameter name,
    ``W + (alpha/r)·(A_l @ B_l)ᵀ`` in the base weight's dtype, differentiable
    in the adapters (the base weights enter detached)."""
    params = dict(model.named_parameters())
    out = {}
    for top, blocks in lora.items():
        for blk, tgts in blocks.items():
            for t, ab in tgts.items():
                rank = ab["a"].shape[-1]
                delta = torch.einsum("ldr,lre->lde", ab["a"], ab["b"])  # (L, in, out)
                for i in range(delta.shape[0]):
                    name = _weight_name(top, i, blk, t)
                    w = params[name].detach()
                    out[name] = w + (alpha / rank) * delta[i].t().to(w.dtype)
    return out


@torch.no_grad()
def merge_lora(model: Whisper, lora: dict, alpha: float = 16.0) -> Whisper:
    """A new model with dense weights ``W + (alpha/r)·A@B`` per adapted
    projection, every other weight copied from ``model``; same device and
    mode (training masters or serving) as ``model``, which is unchanged."""
    sd = {n: p.detach() for n, p in model.state_dict().items()}
    sd.update(lora_weights(model, lora, alpha))
    return build_model(model.cfg, sd, device=next(model.parameters()).device,
                       train=model.training)


def lora_param_count(lora: dict) -> int:
    return sum(x.numel() for _, x in _leaves(lora))


class _Call(nn.Module):
    """Holds the base model so that ``functional_call`` swaps its weights
    for the duration of ``fn(model)``."""

    def __init__(self, model: Whisper):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def init_lora_state(lora: dict, optimizer: AdamW) -> TrainState:
    """The training state of the adapter tree (its leaves, in ``_leaves``
    order, are the optimizer's parameters)."""
    return TrainState(lora, optimizer.init([x for _, x in _leaves(lora)]), 0)


def make_lora_grad_fn(cfg: WhisperConfig, alpha: float = 16.0, bias_weight: float = 1.5,
                      grad_accum: int = 1, use_bias_spans: bool = True):
    """``grad_fn(lora, base_model, batch) -> (loss, grads)``: the WeightCE
    loss of the merged model (mean over ``grad_accum`` microbatches, each
    tensor of ``batch`` then with a leading (A, ...) axis) and its gradients
    with respect to the adapter tensors, in ``_leaves`` order. The base
    model gets no gradient."""
    loss_full = make_loss_fn(cfg, bias_weight, use_bias_spans)

    def grad_fn(lora: dict, base_model: Whisper, batch: dict):
        leaves = [x for _, x in _leaves(lora)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            return _loss_and_grads(lora, leaves, base_model, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)

    def _loss_and_grads(lora, leaves, base_model, batch):
        merged = lora_weights(base_model, lora, alpha)
        swapped = {n: w.detach().requires_grad_() for n, w in merged.items()}
        params = {f"model.{n}": p.detach() for n, p in base_model.named_parameters()}
        params.update({f"model.{n}": w for n, w in swapped.items()})

        # forward and backward inside the swap, so a remat replay sees it
        # too; the swapped weights' mean gradients land in their .grad
        loss, _ = functional_call(_Call(base_model), params, (
            lambda model: accumulate_microbatch_grads(loss_full, model, batch, grad_accum),))
        names = list(merged)
        dw = [swapped[n].grad if swapped[n].grad is not None else torch.zeros_like(swapped[n])
              for n in names]
        grads = torch.autograd.grad([merged[n] for n in names], leaves, dw)
        return loss, list(grads)

    return grad_fn


def make_lora_train_step(
    cfg: WhisperConfig,
    optimizer: AdamW,
    alpha: float = 16.0,
    bias_weight: float = 1.5,
    grad_accum: int = 1,
    use_bias_spans: bool = True,
    donate: bool = True,
    spec_augment: SpecAugmentConfig | None = None,
    augment_seed: int = 0,
):
    """Returns ``step(state, base_model, batch) -> (state, metrics)``:
    ``state`` (``init_lora_state``) holds the adapter tree, updated in
    place; ``base_model`` rides along frozen. Metrics as
    ``make_train_step``'s; ``grad_norm`` is the adapters' gradient norm.
    ``donate`` is the JAX signature's (buffer donation) and changes
    nothing here."""
    grad_fn = make_lora_grad_fn(cfg, alpha, bias_weight, grad_accum, use_bias_spans)
    augment = _check_augment(spec_augment, augment_seed, False)

    def step(state: TrainState, base_model: Whisper, batch: dict):
        leaves = [x for _, x in _leaves(state.model)]
        batch = _on_device(batch, leaves[0].device)
        if augment is not None:
            batch = augment(batch, state.step)
        loss, grads = grad_fn(state.model, base_model, batch)
        norm = global_norm(grads)
        optimizer.update_(leaves, grads, state.opt_state, norm=norm)
        state.step += 1
        return state, {"loss": loss, "grad_norm": norm}

    return step


def lora_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's adapter tree (numpy or jax arrays, the same layout)
    as f32 tensors on ``device``."""
    return {top: {blk: {t: {ab: torch.from_numpy(np.array(x, np.float32)).to(device)
                            for ab, x in v.items()}
                        for t, v in tgts.items()}
                  for blk, tgts in blocks.items()}
            for top, blocks in tree.items()}


def lora_host_arrays(lora: dict, opt_state: OptState | None = None):
    """(adapter tree, optimizer leaves or None) as host numpy copies in the
    JAX layout (``train/checkpoint.py``'s ``host_arrays`` for adapters)."""
    tree: dict = {}
    for (top, blk, t, ab), x in _leaves(lora):
        tree.setdefault(top, {}).setdefault(blk, {}).setdefault(t, {})[ab] = \
            x.detach().cpu().numpy()
    if opt_state is None:
        return tree, None
    count = np.asarray(opt_state.count, np.int32)
    mu = [m.detach().cpu().numpy() for m in opt_state.mu]
    nu = [v.detach().cpu().numpy() for v in opt_state.nu]
    return tree, [count, *mu, *nu, count]


def load_lora_checkpoint(path: str, load_opt_state: bool = False, device="cpu"):
    """(adapter tree, OptState or None, metadata) from a ``checkpoint-N``
    dir written by a LoRA run of either package, on ``device``."""
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    lora = lora_from_jax(tree, device)
    opt_state = None
    opt_file = os.path.join(path, "opt_state.npz")
    if load_opt_state and os.path.isfile(opt_file):
        with np.load(opt_file) as z:
            leaves = [z[str(i)] for i in range(len(z.files))]
        n = len(_flatten(tree))
        if len(leaves) != 2 * n + 2:
            raise ValueError(f"{opt_file}: {len(leaves)} leaves, expected {2 * n + 2} "
                             "(Adam count, mu, nu, schedule count)")
        as_t = [torch.from_numpy(np.array(x, np.float32)).to(device) for x in leaves[1:-1]]
        opt_state = OptState(int(leaves[0]), as_t[:n], as_t[n:])
    with open(os.path.join(path, "trainer_state.json")) as f:
        meta = json.load(f)
    return lora, opt_state, meta
