"""Parameter, batch and decode-input sharding: the counterpart of the JAX
package's ``parallel/sharding.py``, with its per-name Megatron rules mapped
onto the port's state-dict names.

  * column-parallel (output rows over "model"): the q, k, v and fc1
    products' weights and biases, so heads and the FFN's hidden units are
    computed locally
  * row-parallel (input columns over "model"): the attention output and fc2
    weights; their outputs are all-reduced once, before the replicated bias
  * vocab-parallel (rows over "model"): the token embedding and an untied
    ``proj_out``, with the int8 per-row scales of a quantized model
  * everything else (layer norms, conv stems, position tables, the biases
    of row-parallel products) is replicated
  * batches: the leading (post-accumulation) axis over "data"

``nn.Linear`` stores (out, in) where the JAX package stores (in, out), so a
column-parallel weight splits dim 0 here (the JAX spec's last dim) and a
row-parallel one dim 1 (the JAX spec's second-to-last).

With the default group's ranks as devices (``parallel/mesh.py``), a
"sharded array" is a rank's local tensor: ``shard_params`` gives each rank a
``Whisper`` that holds its shard, ``shard_batch`` and
``shard_decode_inputs`` its rows, and ``gather_params`` / ``gather_rows``
put the whole back together on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size
from .tp import TensorParallel, shard_bounds

_COL_PARALLEL = {"query", "key", "value", "fc1"}   # split the output rows (dim 0)
_ROW_PARALLEL = {"out", "fc2"}                      # split the input columns (dim 1)
_VOCAB = {"decoder.token_emb", "proj_out", "decoder.token_emb_scale", "proj_out_scale"}


def _model_dim(name: str, ndim: int) -> int | None:
    """The dim of ``name`` split over "model", or None (replicated)."""
    if name in _VOCAB:
        return 0
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in _COL_PARALLEL and leaf in ("weight", "bias", "scale"):
        return 0
    if module in _ROW_PARALLEL and leaf == "weight" and ndim == 2:
        return 1
    return None


def param_specs(state_dict: dict) -> dict:
    """Placements over (data, model) of every entry of ``state_dict``:
    ``(Replicate(), Shard(d))`` for a tensor split over "model" along d,
    ``(Replicate(), Replicate())`` otherwise."""
    out = {}
    for name, t in state_dict.items():
        d = _model_dim(name, t.ndim)
        out[name] = (Replicate(), Replicate() if d is None else Shard(d))
    return out


def _local_slice(t: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """Rank ``tp.rank``'s shard of ``t`` along ``dim``, zero-padded to the
    common width when ``tp.size`` does not divide it (the vocabulary)."""
    start, stop, width = shard_bounds(t.shape[dim], tp.size, tp.rank)
    part = t.narrow(dim, start, stop - start)
    if stop - start < width:
        pad = list(part.shape)
        pad[dim] = width - (stop - start)
        part = torch.cat([part, part.new_zeros(pad)], dim=dim)
    return part.clone()


def _set_tensor(model: nn.Module, name: str, value: torch.Tensor, requires_grad: bool) -> None:
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    if leaf in mod._parameters:
        mod._parameters[leaf] = nn.Parameter(value, requires_grad=requires_grad)
    else:
        mod._buffers[leaf] = value


def shard_params(model, mesh, cfg=None, device=None):
    """The ``Whisper`` that holds this rank's shard of ``model`` (a
    ``Whisper``, or a state dict with ``cfg`` and ``device``, built as a
    serving model). Tensors are split over "model" by ``param_specs`` and
    replicated over "data"; the returned model runs the collectives of
    ``parallel/tp.py`` in its forward. With one rank on "model" it is
    ``model`` itself. The attention heads and the FFN width must divide by
    the model axis; the vocabulary need not."""
    from ..models.convert import build_model
    from ..models.whisper import Whisper, int8_decoder_layout

    if not isinstance(model, Whisper):
        model = build_model(cfg, model, device=device or "cuda")
    size = axis_size(mesh, MODEL_AXIS)
    if size == 1:
        return model
    cfg = model.cfg
    if cfg.n_heads % size:
        raise ValueError(f"{cfg.n_heads} attention heads do not divide over "
                         f"model_parallelism={size}")
    tp = TensorParallel(axis_group(mesh, MODEL_AXIS))
    sd = model.state_dict()
    grads = {n: p.requires_grad for n, p in model.named_parameters()}
    int8 = sd["decoder.token_emb"].dtype == torch.int8
    with torch.device("meta"):  # every tensor is set below
        local = Whisper(cfg, untied_head=model.proj_out is not None)
        if int8:
            int8_decoder_layout(local)
    for name, t in sd.items():
        d = _model_dim(name, t.ndim)
        _set_tensor(local, name, t.detach().clone() if d is None else _local_slice(t, d, tp),
                    grads.get(name, False))
    local.tp = local.decoder.tp = tp
    for blk in [*local.encoder.blocks, *local.decoder.blocks]:
        for attn in [getattr(blk, a) for a in ("attn", "self_attn", "cross_attn")
                     if hasattr(blk, a)]:
            attn.query.tp_col = attn.key.tp_col = attn.value.tp_col = tp
            attn.out.tp_row = tp
        blk.mlp.fc1.tp_col = tp
        blk.mlp.fc2.tp_row = tp
    return local.train(model.training)


def sharded_dims(model: Whisper) -> list[int | None]:
    """For each of a sharded model's ``parameters()``, the dim split over
    "model" (None when replicated)."""
    return [_model_dim(n, p.ndim) for n, p in model.named_parameters()]


def _gather_dim(t: torch.Tensor, dim: int, tp: TensorParallel, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.contiguous(), group=tp.group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)


def gather_tensor(model: Whisper, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t``, the shard of ``model``'s entry ``name`` (or a
    tensor laid out like it, e.g. an optimizer moment), on every rank."""
    tp = getattr(model, "tp", None)
    d = None if tp is None else _model_dim(name, t.ndim)
    if d is None:
        return t
    n = model.cfg.n_vocab if name in _VOCAB else t.shape[d] * tp.size
    return _gather_dim(t, d, tp, n)


def gather_params(model: Whisper) -> dict:
    """The whole state dict of a sharded model (``model``'s own for an
    unsharded one), on every rank of its model group: what checkpoints and
    exports write, identical to an unsharded run's. Collective over
    "model"."""
    return {n: gather_tensor(model, n, t.detach()) for n, t in model.state_dict().items()}


@torch.no_grad()
def load_params(model, state_dict: dict) -> None:
    """Copy a whole state dict (e.g. ``load_checkpoint``'s) into ``model``
    in place, each entry cut to the model's shard: ``load_state_dict`` of a
    sharded model."""
    tp = getattr(model, "tp", None)
    for name, t in model.state_dict().items():
        full = state_dict[name]
        d = None if tp is None else _model_dim(name, full.ndim)
        t.copy_(full if d is None else _local_slice(full, d, tp))


def shard_opt_state(opt_state, model: Whisper, mesh):
    """Optimizer moments of the whole model (``load_checkpoint``'s) -> this
    rank's shards, following each parameter's split; the count is host
    state. Returns a new ``OptState``."""
    from ..train.optim import OptState

    tp = getattr(model, "tp", None)
    names = [n for n, _ in model.named_parameters()]

    def local(name, t):
        d = None if tp is None else _model_dim(name, t.ndim)
        return t if d is None else _local_slice(t, d, tp)

    return OptState(opt_state.count, [local(n, m) for n, m in zip(names, opt_state.mu)],
                    [local(n, v) for n, v in zip(names, opt_state.nu)])


def _rows(x, start: int, stop: int, axis: int):
    idx = (slice(None),) * axis + (slice(start, stop),)
    return x[idx]


def shard_batch(batch: dict, mesh, extra_leading_axes: int = 0) -> dict:
    """This rank's rows of every array of ``batch`` along its batch axis
    (axis ``extra_leading_axes``: 1 for microbatched (A, B, ...) inputs).
    The axis must divide evenly over "data", as GSPMD requires; other
    entries pass through."""
    dp, r = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    def put(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        n = x.shape[extra_leading_axes]
        if n % dp:
            raise ValueError(f"batch axis {n} does not divide over data={dp}")
        per = n // dp
        return _rows(x, r * per, (r + 1) * per, extra_leading_axes)

    return {k: put(v) for k, v in batch.items()}


def shard_decode_inputs(mesh, *arrays, batch_axis: int = 0) -> tuple[list, int]:
    """This rank's rows of the decode inputs (mel features, prefix ids and
    mask, bias spans, per-row values), the batch first padded up to a
    multiple of "data" by repeating its first row (even shards; the caller
    strips the padded rows after ``gather_rows``). Returns ([local arrays],
    original batch size); ``None`` entries pass through. numpy arrays and
    tensors both."""
    dp, r = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    sizes = {a.shape[batch_axis] for a in arrays if a is not None}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes: {sizes}")
    b = sizes.pop()
    padded = -(-b // dp) * dp
    per = padded // dp
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        if padded != b:
            first = _rows(a, 0, 1, batch_axis)
            if isinstance(a, torch.Tensor):
                reps = first.repeat_interleave(padded - b, dim=batch_axis)
                a = torch.cat([a, reps], dim=batch_axis)
            else:
                a = np.concatenate([np.asarray(a), np.repeat(first, padded - b, axis=batch_axis)],
                                   axis=batch_axis)
        out.append(_rows(a, r * per, (r + 1) * per, batch_axis))
    return out, b


def gather_rows(x: torch.Tensor | None, mesh, b: int | None = None):
    """The rows of every rank of "data" joined along axis 0 (``x`` on each
    rank holds its own), the first ``b`` kept: the padded rows of
    ``shard_decode_inputs`` dropped. Collective over "data"."""
    if x is None:
        return None
    group = axis_group(mesh, DATA_AXIS)
    if group is not None:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts)
    return x if b is None else x[:b]

