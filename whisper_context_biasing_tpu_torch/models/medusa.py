"""Medusa heads: multi-token prediction for self-speculative decoding.

The counterpart of the JAX package's ``models/medusa.py``. "Whisper in
Medusa's Ear" (arXiv:2409.15869) applies Medusa (Cai et al.) to Whisper: K
small heads on the decoder's final hidden state predict tokens t+2 .. t+K+1,
so one decoder forward both verifies the previous round's proposal and
produces the next one (``decode/medusa.py`` runs the loop,
``train/medusa.py`` fits the heads).

Head j is the Medusa-1 residual block with the vocab projection tied to the
model's own (``project_vocab``)::

    h_j = hidden + silu(hidden @ w_j + b_j)        w_j: (d, d)
    logits_j = project_vocab(h_j)

The heads are a dict ``{"w": (K, d, d), "b": (K, d)}`` of f32 tensors (and
an optional ``"n_chains"`` decode setting), saved in the JAX package's npz
layout so either package reads the other's file. ``init_medusa_params``
draws from a ``torch.Generator``: the JAX init's distribution, other
numbers for one seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import WhisperConfig
from .whisper import Whisper, project_vocab


def init_medusa_params(cfg: WhisperConfig, n_heads: int,
                       key: torch.Generator | int = 0) -> dict:
    """{"w": (K, d, d), "b": (K, d)} f32 on the CPU: near-zero weights, so
    untrained heads start as the identity residual (each proposes the
    model's own next-token distribution)."""
    g = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(key)
    d = cfg.d_model
    w = torch.randn((n_heads, d, d), generator=g, dtype=torch.float32) * 1e-3
    return {"w": w, "b": torch.zeros((n_heads, d), dtype=torch.float32)}


def medusa_head_logits(params: Whisper, w: torch.Tensor, b: torch.Tensor,
                       hidden: torch.Tensor) -> torch.Tensor:
    """One head's logits (B, S, V) of (B, S, D) ``hidden``: the residual
    block with ``w`` (d, d) and ``b`` (d,) in ``hidden``'s dtype, then
    ``project_vocab``."""
    dt = hidden.dtype
    w = w.to(device=hidden.device, dtype=dt)
    b = b.to(device=hidden.device, dtype=dt)
    return project_vocab(params, hidden + F.silu(hidden @ w + b))


def medusa_logits(params: Whisper, medusa: dict, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) hidden -> (K, B, S, V) per-head logits."""
    return torch.stack([medusa_head_logits(params, w, b, hidden)
                        for w, b in zip(medusa["w"], medusa["b"])])


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_medusa(path: str, medusa: dict) -> None:
    extra = {}
    if "n_chains" in medusa:
        extra["n_chains"] = np.int32(medusa["n_chains"])
    np.savez(path, w=_numpy(medusa["w"]), b=_numpy(medusa["b"]), **extra)


def load_medusa(path: str, n_chains: int | None = None) -> dict:
    """Load saved heads (f32 CPU tensors); ``n_chains`` (when truthy)
    overrides any stored chain setting."""
    with np.load(path) as z:
        md = {"w": torch.from_numpy(np.array(z["w"], np.float32)),
              "b": torch.from_numpy(np.array(z["b"], np.float32))}
        if "n_chains" in z:
            md["n_chains"] = int(z["n_chains"])
    if n_chains:
        md["n_chains"] = int(n_chains)
    return md


def split_medusa(medusa: dict) -> tuple[dict, int]:
    """(heads, n_chains): the head tensors apart from the optional
    ``n_chains`` decode setting bundled in a medusa dict."""
    return ({"w": medusa["w"], "b": medusa["b"]}, int(medusa.get("n_chains", 1)))
