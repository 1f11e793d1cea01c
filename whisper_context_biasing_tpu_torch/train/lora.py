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

Under a (data, model) mesh the base model is a rank's shard
(``shard_params``) and so are the adapters: a column-parallel target (q, k,
v) splits B (L, r, e) along e over "model" and keeps A whole; the
row-parallel ``wo`` splits A (L, d, r) along d and keeps B whole. A rank's
merged weight is then its shard of the whole merge. The gradient of a whole
factor is a partial sum on each rank (each shard of the projection adds
its part), so it sums over "model"; every gradient and the loss sum over
"data"; the clip norm counts a whole factor once. The adapters are drawn
whole from the one generator and then cut, so a sharded run starts where
the unsharded run does for one seed.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..models.config import WhisperConfig
from ..models.convert import build_model
from ..models.whisper import Whisper
from ..parallel.mesh import DATA_AXIS, axis_group
from ..parallel.sharding import _gather_dim, _local_slice, like_shard
from .augment import SpecAugmentConfig
from .checkpoint import (
    DCP_OPT,
    DCP_PARAMS,
    _OCP,
    _flatten,
    _unflatten,
    dcp_entry,
    opt_entries,
    read_dcp,
    read_opt_state,
)
from .optim import AdamW, OptState, global_norm
from .step import (
    TrainState,
    _check_augment,
    _on_device,
    _sum_over_data,
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


def _split_dim(t: str, ab: str) -> int | None:
    """The dim of target ``t``'s factor ``ab`` split over "model" under
    tensor parallelism (None: held whole)."""
    if t == "wo":
        return 1 if ab == "a" else None
    return 2 if ab == "b" else None


def _layouts(lora: dict, tp) -> list[tuple[int, int] | None]:
    """(dim, whole length) of each split factor of a rank's adapter tree,
    None for a whole one, in ``_leaves`` order."""
    out = []
    for (_, _, t, ab), x in _leaves(lora):
        d = None if tp is None else _split_dim(t, ab)
        out.append(None if d is None else (d, x.shape[d] * tp.size))
    return out


def shard_lora(lora: dict, tp, opt_state: OptState | None = None):
    """(this rank's shard of a whole adapter tree, of its optimizer moments
    too when given); both unchanged without tensor parallelism (``tp``,
    the base model's)."""
    if tp is None:
        return lora, opt_state

    def cut(path, x):
        d = _split_dim(path[2], path[3])
        return x if d is None else _local_slice(x, d, tp)

    local: dict = {}
    for path, x in _leaves(lora):
        top, blk, t, ab = path
        local.setdefault(top, {}).setdefault(blk, {}).setdefault(t, {})[ab] = cut(path, x)
    if opt_state is not None:
        paths = [p for p, _ in _leaves(lora)]
        opt_state = OptState(opt_state.count, [cut(p, m) for p, m in zip(paths, opt_state.mu)],
                             [cut(p, v) for p, v in zip(paths, opt_state.nu)])
    return local, opt_state


def init_lora_params(model: Whisper, rank: int, generator: torch.Generator | None = None,
                     targets: tuple[str, ...] = DEFAULT_TARGETS,
                     include_encoder: bool = True) -> dict:
    """Adapter tree over ``model``'s attention projections: ``a`` (L, d, r)
    normal / sqrt(d), drawn from ``generator`` (a CPU one seeded 0 when
    None; other numbers than ``jax.random``'s for one seed), ``b`` (L, r, e)
    zeros, so the merged model starts exactly at the base weights; f32 on
    the model's device. ``include_encoder=False`` adapts the decoder only
    (the LoRA analog of the reference's freeze_encoder()). For a
    tensor-parallel shard the whole factors are drawn, then cut to the
    rank's shard (``shard_lora``)."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    generator = generator or torch.Generator().manual_seed(0)
    device = next(model.parameters()).device
    tp = model.tp
    lora: dict = {}
    for top, blk in _BLOCKS:
        if not include_encoder and top == "encoder":
            continue
        blocks = getattr(model, top).blocks
        for t in targets:
            e, d = getattr(getattr(blocks[0], blk), _LINEAR[t]).weight.shape
            if tp is not None:  # the whole projection's (out, in)
                e, d = (e, d * tp.size) if t == "wo" else (e * tp.size, d)
            a = torch.randn((len(blocks), d, rank), generator=generator,
                            device=generator.device) / math.sqrt(d)
            b = torch.zeros((len(blocks), rank, e))
            lora.setdefault(top, {}).setdefault(blk, {})[t] = {
                "a": a.to(device), "b": b.to(device)}
    return shard_lora(lora, tp)[0]


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
    mode (training masters or serving) as ``model``, which is unchanged.
    For a tensor-parallel shard (and the rank's adapters) it is the rank's
    shard of the merged model."""
    sd = {n: p.detach() for n, p in model.state_dict().items()}
    sd.update(lora_weights(model, lora, alpha))
    if model.tp is not None:
        return like_shard(model, {n: t.clone() for n, t in sd.items()})
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
                      grad_accum: int = 1, use_bias_spans: bool = True, mesh=None):
    """``grad_fn(lora, base_model, batch) -> (loss, grads)``: the WeightCE
    loss of the merged model (mean over ``grad_accum`` microbatches, each
    tensor of ``batch`` then with a leading (A, ...) axis) and its gradients
    with respect to the adapter tensors, in ``_leaves`` order. The base
    model gets no gradient. Under a ``mesh`` (``base_model`` and ``lora`` a
    rank's shards, ``batch`` its rows) both are the global batch's, the
    gradients this rank's shards."""
    loss_full = make_loss_fn(cfg, bias_weight, use_bias_spans, mesh=mesh)
    data = axis_group(mesh, DATA_AXIS)

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
        grads = list(torch.autograd.grad([merged[n] for n in names], leaves, dw))
        tp = base_model.tp
        if tp is not None:  # a whole factor's gradient: each shard's part, summed
            whole = [g for g, lay in zip(grads, _layouts(lora, tp)) if lay is None]
            flat = torch.cat([g.reshape(-1) for g in whole])
            dist.all_reduce(flat, group=tp.group)
            parts = flat.split([g.numel() for g in whole])
            torch._foreach_copy_(whole, [f.view_as(g) for f, g in zip(parts, whole)])
        if data is not None:
            loss = _sum_over_data(loss, grads, data)
        return loss, grads

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
    mesh=None,
):
    """Returns ``step(state, base_model, batch) -> (state, metrics)``:
    ``state`` (``init_lora_state``) holds the adapter tree, updated in
    place; ``base_model`` rides along frozen. Metrics as
    ``make_train_step``'s; ``grad_norm`` is the adapters' gradient norm.
    ``donate`` is the JAX signature's (buffer donation) and changes
    nothing here. ``mesh``: as ``make_lora_grad_fn``'s; the metrics are the
    global ones on every rank."""
    grad_fn = make_lora_grad_fn(cfg, alpha, bias_weight, grad_accum, use_bias_spans, mesh)
    augment = _check_augment(spec_augment, augment_seed, False, mesh)

    def step(state: TrainState, base_model: Whisper, batch: dict):
        leaves = [x for _, x in _leaves(state.model)]
        batch = _on_device(batch, leaves[0].device)
        if augment is not None:
            batch = augment(batch, state.step)
        loss, grads = grad_fn(state.model, base_model, batch)
        tp = base_model.tp
        norm = (global_norm(grads) if tp is None else
                global_norm(grads, [lay is not None for lay in _layouts(state.model, tp)],
                            tp.group))
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


def lora_host_arrays(lora: dict, opt_state: OptState | None = None, tp=None):
    """(adapter tree, optimizer leaves or None) as host numpy copies in the
    JAX layout (``train/checkpoint.py``'s ``host_arrays`` for adapters). A
    rank's shards (``tp``, the base model's) are gathered whole first
    (collective over "model")."""
    layouts = _layouts(lora, tp)

    def whole(x, lay):
        x = x.detach()
        return (x if lay is None else _gather_dim(x, lay[0], tp, lay[1])).cpu().numpy()

    tree: dict = {}
    for ((top, blk, t, ab), x), lay in zip(_leaves(lora), layouts):
        tree.setdefault(top, {}).setdefault(blk, {}).setdefault(t, {})[ab] = whole(x, lay)
    if opt_state is None:
        return tree, None
    count = np.asarray(opt_state.count, np.int32)
    mu = [whole(m, lay) for m, lay in zip(opt_state.mu, layouts)]
    nu = [whole(v, lay) for v, lay in zip(opt_state.nu, layouts)]
    return tree, [count, *mu, *nu, count]


def lora_dcp_entries(lora: dict, opt_state: OptState | None = None, mesh=None, tp=None):
    """(params, optimizer) entries of the sharded checkpoint backend
    (``checkpoint.save_sharded``) for a rank's adapters: keyed by the JAX
    tree's "/"-joined paths, each split factor written as the rank's shard."""
    layouts = _layouts(lora, tp)
    keys = ["/".join(p) for p, _ in _leaves(lora)]
    params = {k: dcp_entry(x, mesh, lay) for k, (_, x), lay in zip(keys, _leaves(lora), layouts)}
    opt = None if opt_state is None else opt_entries(keys, opt_state, mesh, layouts)
    return params, opt


def load_lora_checkpoint(path: str, load_opt_state: bool = False, device="cpu"):
    """(adapter tree, OptState or None, metadata) from a ``checkpoint-N``
    dir written by a LoRA run of either package (npz) or of the port's
    sharded backend (DCP), whole, on ``device``."""
    with open(os.path.join(path, "trainer_state.json")) as f:
        meta = json.load(f)
    opt_state = None
    if os.path.isdir(os.path.join(path, DCP_PARAMS)):
        lora = _unflatten({k: v.float().to(device)
                           for k, v in read_dcp(os.path.join(path, DCP_PARAMS)).items()})
        opt_dir = os.path.join(path, DCP_OPT)
        if load_opt_state and os.path.isdir(opt_dir):
            opt_state = read_opt_state(opt_dir, ["/".join(p) for p, _ in _leaves(lora)])
            opt_state.mu = [m.to(device) for m in opt_state.mu]
            opt_state.nu = [v.to(device) for v in opt_state.nu]
        return lora, opt_state, meta
    if os.path.isdir(os.path.join(path, "params_ocp")):
        raise ValueError(_OCP.format(path))
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    lora = lora_from_jax(tree, device)
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
    return lora, opt_state, meta
