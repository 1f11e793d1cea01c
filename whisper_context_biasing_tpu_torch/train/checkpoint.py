"""Checkpoint / resume: the JAX package's npz file layout, and a sharded
backend through ``torch.distributed.checkpoint`` (DCP).

The counterpart of the JAX package's ``train/checkpoint.py``; the
reference relies on HF Trainer ``checkpoint-NNN`` dirs with
``save_total_limit=1`` and best-by-eval-WER selection
(scripts/train.py:236,242-245; scripts/evaluation.py:75-94). A
``checkpoint-{step}/`` dir holds ``trainer_state.json`` (the step and
metadata: log history, eval stamps) and, with the npz backend:

  * ``params.npz``: the JAX params tree (``models/convert.state_dict_to_jax``:
    stacked (L, ...) block weights, linear weights (in, out)), flattened by
    the same ``_flatten`` ("/"-joined sorted keys)
  * ``opt_state.npz``: the optimizer state as the leaves of the JAX
    package's ``make_optimizer(...).init(params)``, in ``jax.tree.leaves``
    order: optax's chain of clip (no leaves), Adam (count, mu tree, nu tree)
    and the schedule (count); the trees' leaves in ``_flatten`` order

so a checkpoint written by either package loads, and resumes, in the other.
A tensor-parallel run gathers its shards to write them.

``backend="orbax"`` (the JAX flag's name; the JAX package writes Orbax
there) writes ``params_dcp/`` and ``opt_dcp/``, two DCP directories
(``.metadata`` and one ``__<rank>_0.distcp`` a writing rank) keyed by the
port's parameter names, ``mu/<name>``, ``nu/<name>`` and ``count``. Under a
mesh every rank passes its own shards as ``DTensor``s (split over "model"
as ``parallel/sharding.py`` splits them, replicated over "data"), so no
tensor is gathered and each shard is written once. ``load_checkpoint``
reads either layout back as whole f32 CPU tensors, in any process, with or
without a process group, whatever mesh wrote it. A JAX Orbax directory
(``params_ocp/``, OCDBT through tensorstore) is recognised but not read:
the npz backend moves checkpoints between the packages.

Retention (keep the newest N plus the best by wer), ``latest_checkpoint``,
``find_best_checkpoint`` and ``is_native_checkpoint`` are copies.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import warnings
from typing import Any

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.convert import params_from_jax, state_dict_to_jax
from ..models.whisper import Whisper
from ..parallel.mesh import MODEL_AXIS, axis_index, axis_size
from ..parallel.multihost import process_index
from ..parallel.sharding import gather_tensor, shard_layout
from ..parallel.tp import shard_bounds
from .optim import OptState

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
DCP_PARAMS, DCP_OPT = "params_dcp", "opt_dcp"
_OCP = ("{}: a JAX Orbax checkpoint (params_ocp/, OCDBT written by tensorstore) cannot be "
        "read here; save it with the npz backend (--checkpoint_backend npz) to move it "
        "between the packages")


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[k]) for k in sorted(keys, key=int)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def is_native_checkpoint(path: str) -> bool:
    """True when ``path`` is a checkpoint-N dir of either package — npz
    (``params.npz``), DCP (``params_dcp/``) or JAX Orbax (``params_ocp/``)
    backed. The one detection rule every entry point shares."""
    if not path or not os.path.isdir(path):
        return False
    return (os.path.isfile(os.path.join(path, "params.npz"))
            or any(os.path.isdir(os.path.join(path, d)) for d in (DCP_PARAMS, "params_ocp")))


def dcp_entry(t: torch.Tensor, mesh=None, layout: tuple[int, int] | None = None):
    """``t`` as the sharded backend writes it: without a mesh ``t`` itself;
    under one a ``DTensor`` over it made from this rank's tensor without a
    copy or a collective: ``Shard(dim)`` over "model" when ``layout`` is
    ``(dim, whole length)`` (``shard_layout``; the zero padding of an
    uneven last shard dropped), whole otherwise, and replicated over
    "data"."""
    t = t.detach()
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape, place = list(t.shape), Replicate()
    if layout is not None:
        d, n = layout
        start, stop, _ = shard_bounds(n, axis_size(mesh, MODEL_AXIS),
                                      axis_index(mesh, MODEL_AXIS))
        t, shape[d], place = t.narrow(d, 0, stop - start), n, Shard(d)
    shape = torch.Size(shape)
    return DTensor.from_local(t.contiguous(), mesh, (Replicate(), place), run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def write_dcp(path: str, entries: dict, mesh=None) -> None:
    """One DCP directory of ``entries`` (``dcp_entry``'s). Under a mesh
    every rank of the default group calls it and writes its own shards, a
    tensor held by several ranks once; it returns on every rank after the
    metadata is written. Without one, this process writes it alone."""
    import torch.distributed.checkpoint as dcp

    with _one_process_quiet():
        dcp.save(entries, storage_writer=dcp.FileSystemWriter(path), no_dist=mesh is None)


def read_dcp(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a DCP directory, whole, on the CPU in its stored
    dtype; no collective, whatever group or mesh wrote it."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    out = {k: torch.empty(m.size, dtype=m.properties.dtype)
           for k, m in reader.read_metadata().state_dict_metadata.items()}
    with _one_process_quiet():
        dcp.load(out, storage_reader=reader, no_dist=True)
    return out


@contextlib.contextmanager
def _one_process_quiet():
    """DCP warns that it assumes one process whenever no group is up, even
    when the caller asked for one process (``no_dist``)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def opt_entries(names, opt_state: OptState, mesh=None, layouts=None) -> dict:
    """The optimizer state's DCP entries: ``mu/<name>``, ``nu/<name>`` and
    ``count`` (``layouts``: each moment's ``shard_layout``, None when
    whole)."""
    layouts = layouts or [None] * len(opt_state.mu)
    out = {}
    for n, m, v, lay in zip(names, opt_state.mu, opt_state.nu, layouts):
        out[f"mu/{n}"], out[f"nu/{n}"] = dcp_entry(m, mesh, lay), dcp_entry(v, mesh, lay)
    out["count"] = dcp_entry(torch.tensor(opt_state.count, device=opt_state.mu[0].device),
                             mesh)
    return out


def read_opt_state(path: str, names) -> OptState:
    """``opt_entries``' directory back as an ``OptState`` over ``names`` (f32,
    CPU)."""
    o = read_dcp(path)
    return OptState(int(o["count"]), [o[f"mu/{n}"].float() for n in names],
                    [o[f"nu/{n}"].float() for n in names])


def save_sharded(output_dir: str, step: int, params: dict, opt: dict | None = None,
                 metadata: dict | None = None, keep: int = 1, best_metric_key: str = "eval_wer",
                 mesh=None) -> str:
    """Write ``checkpoint-{step}/`` with the sharded backend: ``params`` and
    ``opt`` (DCP entries) into ``params_dcp/`` and ``opt_dcp/``, then, on
    rank 0 alone and after every rank's shards are written,
    ``trainer_state.json`` and retention. Under a mesh every rank calls
    it; without one only rank 0 writes."""
    path = os.path.join(output_dir, f"checkpoint-{step}")
    if mesh is None and process_index() != 0:
        return path
    os.makedirs(path, exist_ok=True)
    write_dcp(os.path.join(path, DCP_PARAMS), params, mesh)
    if opt is not None:
        write_dcp(os.path.join(path, DCP_OPT), opt, mesh)
    if process_index() == 0:
        _finish(output_dir, path, step, metadata, keep, best_metric_key)
    return path


def _param_names(cfg: WhisperConfig, untied_head: bool = False) -> list[str]:
    """Parameter names of a ``Whisper(cfg)`` in ``named_parameters`` order
    (the order ``OptState``'s moments follow)."""
    with torch.device("meta"):
        return [n for n, _ in Whisper(cfg, untied_head=untied_head).named_parameters()]


def host_arrays(model: Whisper, opt_state: OptState | None = None):
    """(params tree, optimizer leaves or None): host numpy copies of the
    model's parameters in the JAX params layout, and of ``opt_state`` in
    the JAX optimizer's leaf order. Taken on the step's thread, so a
    background save writes the values of this step. A tensor-parallel
    shard's tensors are gathered whole first (collective over "model": every
    rank of the group calls it), so the files are an unsharded run's."""
    cfg = model.cfg
    named = dict(model.named_parameters())
    params = state_dict_to_jax({n: gather_tensor(model, n, p.detach()) for n, p in named.items()},
                               cfg)
    if opt_state is None:
        return params, None
    count = np.asarray(opt_state.count, np.int32)
    mu, nu = (_flatten(state_dict_to_jax({n: gather_tensor(model, n, t)
                                          for n, t in zip(named, m)}, cfg))
              for m in (opt_state.mu, opt_state.nu))
    return params, [count, *mu.values(), *nu.values(), count]


def write_checkpoint(
    output_dir: str,
    step: int,
    params: Any,
    opt_leaves: list | None = None,
    metadata: dict | None = None,
    keep: int = 1,
    best_metric_key: str = "eval_wer",
) -> str:
    """Write ``checkpoint-{step}/`` from ``host_arrays``' output, then apply
    retention. Returns the checkpoint's path."""
    path = os.path.join(output_dir, f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_leaves is not None:
        np.savez(os.path.join(path, "opt_state.npz"),
                 **{str(i): a for i, a in enumerate(opt_leaves)})
    _finish(output_dir, path, step, metadata, keep, best_metric_key)
    return path


def _finish(output_dir, path, step, metadata, keep, best_metric_key) -> None:
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f, indent=2)
    _apply_retention(output_dir, keep, best_metric_key)


def save_checkpoint(
    output_dir: str,
    step: int,
    model: Whisper,
    opt_state: OptState | None = None,
    metadata: dict | None = None,
    keep: int = 1,
    best_metric_key: str = "eval_wer",
    backend: str = "npz",
    mesh=None,
) -> str:
    """Save ``model`` (and ``opt_state``) as ``checkpoint-{step}/``, in the
    JAX package's npz layout or, with ``backend="orbax"``, the DCP layout;
    ``trainer_state.json`` holds ``step`` and ``metadata``. Keeps the
    newest ``keep`` checkpoints plus the best. Under ``mesh`` (``model``
    this rank's shard) every rank calls it: npz gathers the shards, DCP
    writes each where it lies."""
    check_backend(backend)
    if backend == "orbax":
        named = dict(model.named_parameters())
        layouts = [shard_layout(model, n, p) for n, p in named.items()]
        params = {n: dcp_entry(p, mesh, lay) for (n, p), lay in zip(named.items(), layouts)}
        opt = None if opt_state is None else opt_entries(named, opt_state, mesh, layouts)
        return save_sharded(output_dir, step, params, opt, metadata, keep, best_metric_key,
                            mesh)
    params, leaves = host_arrays(model, opt_state)
    if process_index() != 0:
        return os.path.join(output_dir, f"checkpoint-{step}")
    return write_checkpoint(output_dir, step, params, leaves, metadata, keep, best_metric_key)


def check_backend(backend: str) -> None:
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'npz' or 'orbax')")


def _apply_retention(output_dir: str, keep: int, best_metric_key: str) -> None:
    ckpts = list_checkpoints(output_dir)
    if len(ckpts) <= keep:
        return
    best = find_best_checkpoint(output_dir, metric_key=best_metric_key)
    by_step = sorted(ckpts, key=lambda p: checkpoint_step(p))
    protected = set(by_step[-keep:])
    if best:
        protected.add(best)
    for c in by_step:
        if c not in protected:
            shutil.rmtree(c, ignore_errors=True)


def list_checkpoints(output_dir: str) -> list[str]:
    if not os.path.isdir(output_dir):
        return []
    return [
        os.path.join(output_dir, d)
        for d in os.listdir(output_dir)
        if _CKPT_RE.match(d) and os.path.isdir(os.path.join(output_dir, d))
    ]


def checkpoint_step(path: str) -> int:
    m = _CKPT_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else -1


def latest_checkpoint(output_dir: str) -> str | None:
    """Resume source: newest checkpoint-N (scripts/train.py:172-176)."""
    ckpts = list_checkpoints(output_dir)
    return max(ckpts, key=checkpoint_step) if ckpts else None


def find_best_checkpoint(output_dir: str, metric_key: str = "eval_wer") -> str | None:
    """Checkpoint whose OWN eval metric is lowest.

    Attribution rule: the save path stamps the latest eval value plus the
    step it was measured at (``eval_step``). The stamp counts as the
    checkpoint's own metric only when ``eval_step`` equals the checkpoint's
    step — when save_steps is not a multiple of eval_steps the stamped value
    was produced by an EARLIER step's params, and judging by it could retain
    a checkpoint that never achieved it. Checkpoints with same-step stamps
    are preferred outright; only if none exist does selection fall back to
    stale stamps / scanning log_history (the reference's method,
    scripts/evaluation.py:75-94, kept for reference-style checkpoints)."""
    attributed, attributed_val = None, float("inf")
    fallback, fallback_val = None, float("inf")
    for c in sorted(list_checkpoints(output_dir), key=checkpoint_step):
        state_file = os.path.join(c, "trainer_state.json")
        if not os.path.isfile(state_file):
            continue
        with open(state_file) as f:
            meta = json.load(f)
        step = checkpoint_step(c)
        # a stamp is the checkpoint's OWN metric when eval_step matches, or
        # (legacy stamps without eval_step) when log_history shows an eval
        # at exactly this step with this value — verifiable attribution for
        # checkpoints written before the eval_step key existed
        own = metric_key in meta and (
            meta.get("eval_step") == step
            or ("eval_step" not in meta and any(
                e.get("step") == step and e.get(metric_key) == meta[metric_key]
                for e in meta.get("log_history", [])))
        )
        if own:
            if meta[metric_key] < attributed_val:
                attributed_val, attributed = meta[metric_key], c
            continue
        if metric_key in meta:
            val = meta[metric_key]  # stale or legacy (no eval_step) stamp
        else:
            val = min((e[metric_key] for e in meta.get("log_history", [])
                       if metric_key in e), default=None)
        if val is not None and val < fallback_val:
            fallback_val, fallback = val, c
    return attributed if attributed is not None else fallback


def load_checkpoint(path: str, cfg: WhisperConfig, load_opt_state: bool = False):
    """Returns (state dict, OptState or None, metadata). The state dict comes
    through ``params_from_jax`` (f32, CPU); with ``load_opt_state`` and an
    ``opt_state.npz`` (or ``opt_dcp/``) present, the optimizer state with its
    moments aligned to ``Whisper(cfg).parameters()`` (f32, CPU: the caller
    moves them to the model's device). Either backend's layout, whole
    whatever mesh wrote it; a JAX Orbax dir raises ``ValueError``."""
    opt_state = None
    if os.path.isdir(os.path.join(path, DCP_PARAMS)):
        whole = read_dcp(os.path.join(path, DCP_PARAMS))
        # the npz path's dict: the same names and f32 values
        state_dict = params_from_jax(state_dict_to_jax(whole, cfg), cfg)
        opt_dir = os.path.join(path, DCP_OPT)
        if load_opt_state and os.path.isdir(opt_dir):
            opt_state = read_opt_state(opt_dir, _param_names(cfg, "proj_out" in state_dict))
    elif os.path.isdir(os.path.join(path, "params_ocp")):
        raise ValueError(_OCP.format(path))
    else:
        with np.load(os.path.join(path, "params.npz")) as z:
            state_dict = params_from_jax(_unflatten({k: z[k] for k in z.files}), cfg)
        opt_file = os.path.join(path, "opt_state.npz")
        if load_opt_state and os.path.isfile(opt_file):
            with np.load(opt_file) as z:
                leaves = [z[str(i)] for i in range(len(z.files))]
            keys = list(_flatten(state_dict_to_jax(state_dict, cfg)))
            n = len(keys)
            if len(leaves) != 2 * n + 2:
                raise ValueError(f"{opt_file}: {len(leaves)} leaves, expected {2 * n + 2} "
                                 "(Adam count, mu, nu, schedule count)")
            names = _param_names(cfg, "proj_out" in state_dict)
            mu, nu = (params_from_jax(
                _unflatten(dict(zip(keys, leaves[1 + i * n:1 + (i + 1) * n]))), cfg)
                for i in (0, 1))
            opt_state = OptState(int(leaves[0]), [mu[k] for k in names], [nu[k] for k in names])
    with open(os.path.join(path, "trainer_state.json")) as f:
        meta = json.load(f)
    return state_dict, opt_state, meta
