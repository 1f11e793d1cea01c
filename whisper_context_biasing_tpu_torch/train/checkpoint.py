"""Checkpoint / resume, in the JAX package's npz file layout.

The counterpart of the JAX package's ``train/checkpoint.py``; the
reference relies on HF Trainer ``checkpoint-NNN`` dirs with
``save_total_limit=1`` and best-by-eval-WER selection
(scripts/train.py:236,242-245; scripts/evaluation.py:75-94). A
``checkpoint-{step}/`` dir holds:

  * ``params.npz``: the JAX params tree (``models/convert.state_dict_to_jax``:
    stacked (L, ...) block weights, linear weights (in, out)), flattened by
    the same ``_flatten`` ("/"-joined sorted keys)
  * ``opt_state.npz``: the optimizer state as the leaves of the JAX
    package's ``make_optimizer(...).init(params)``, in ``jax.tree.leaves``
    order: optax's chain of clip (no leaves), Adam (count, mu tree, nu tree)
    and the schedule (count); the trees' leaves in ``_flatten`` order
  * ``trainer_state.json``: the step and metadata (log history, eval stamps)

so a checkpoint written by either package loads, and resumes, in the other.
Retention (keep the newest N plus the best by wer), ``latest_checkpoint``,
``find_best_checkpoint`` and ``is_native_checkpoint`` are copies. The Orbax
backend is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.convert import params_from_jax, state_dict_to_jax
from ..models.whisper import Whisper
from ..parallel.sharding import gather_tensor
from .optim import OptState

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
_ORBAX = "the Orbax checkpoint backend is not ported yet (ROADMAP Queue A.9)"


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
    """True when ``path`` is a checkpoint-N dir of this layout — npz
    (``params.npz``) or Orbax (``params_ocp/``) backed. The one detection
    rule every entry point shares."""
    if not path or not os.path.isdir(path):
        return False
    return (os.path.isfile(os.path.join(path, "params.npz"))
            or os.path.isdir(os.path.join(path, "params_ocp")))


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
    meta = {"step": step, **(metadata or {})}
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump(meta, f, indent=2)
    _apply_retention(output_dir, keep, best_metric_key)
    return path


def save_checkpoint(
    output_dir: str,
    step: int,
    model: Whisper,
    opt_state: OptState | None = None,
    metadata: dict | None = None,
    keep: int = 1,
    best_metric_key: str = "eval_wer",
    backend: str = "npz",
) -> str:
    """Save ``model`` (and ``opt_state``) as ``checkpoint-{step}/`` in the
    JAX package's npz layout; ``trainer_state.json`` holds ``step`` and
    ``metadata``. Keeps the newest ``keep`` checkpoints plus the best."""
    if backend == "orbax":
        raise NotImplementedError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'npz' or 'orbax')")
    params, leaves = host_arrays(model, opt_state)
    return write_checkpoint(output_dir, step, params, leaves, metadata, keep, best_metric_key)


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
    ``opt_state.npz`` present, the optimizer state is rebuilt from the JAX
    leaf order with its moments aligned to ``Whisper(cfg).parameters()``
    (f32, CPU: the caller moves them to the model's device)."""
    if os.path.isdir(os.path.join(path, "params_ocp")):
        raise NotImplementedError(_ORBAX)
    with np.load(os.path.join(path, "params.npz")) as z:
        state_dict = params_from_jax(_unflatten({k: z[k] for k in z.files}), cfg)
    opt_state = None
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
        mu, nu = (params_from_jax(_unflatten(dict(zip(keys, leaves[1 + i * n:1 + (i + 1) * n]))),
                                  cfg) for i in (0, 1))
        opt_state = OptState(int(leaves[0]), [mu[k] for k in names], [nu[k] for k in names])
    with open(os.path.join(path, "trainer_state.json")) as f:
        meta = json.load(f)
    return state_dict, opt_state, meta
