"""Flash attention forward: the CUDA kernel and its plain torch version.

The counterpart of the JAX package's ``ops/flash_attention.py`` forward
(``flash_attention`` / ``_fwd_kernel``), non-causal, for the encoder's
self-attention. The kernel (``csrc/flash_attention.cu``) reads merged-head
activations in place through strides, walks the keys in tiles with an
online softmax, and also returns the per-row logsumexp for the backward.
The causal and decoder uses, and the backward, come with the training path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIM = 64  # the kernel's head width (every Whisper size uses 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# dtype, q, k, v, o, lse, B, H, Tq, kv_len, scale, 4 x (batch, row, head) strides, stream
_SIGNATURES = {"wcb_flash_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F] + [_L] * 12 + [_P]}


def flash_attention_fwd_plain(q, k, v, kv_len: int | None = None):
    """Plain torch version of the kernel. q (B, Tq, H, dh), k/v (B, Tk, H, dh)
    -> (o (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32). Keys at or past
    ``kv_len`` get the f32 minimum; probabilities are cast to v's dtype
    before P.V and the output is normalised after it."""
    tk = k.shape[1]
    kv_len = tk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))  # (B, H, T, dh)
    s = (qh @ kh.transpose(-1, -2)) * scale
    keep = torch.arange(tk, device=q.device) < kv_len
    s = torch.where(keep, s, torch.finfo(torch.float32).min)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vh) / denom
    lse = (m + torch.log(denom))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_fwd(q, k, v, kv_len: int | None = None):
    """Flash forward over (B, T, H, dh) tensors (any strides, last axis
    contiguous): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Returns (o (B, Tq, H, dh), lse (B, H, Tq) f32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    kv_len = tk if kv_len is None else kv_len
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh != HEAD_DIM or k.shape != (b, tk, h, dh) or v.shape != k.shape:
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (head dim must be {HEAD_DIM})")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash attention needs the head-dim axis contiguous")
    if not 0 < kv_len <= tk:
        raise ValueError(f"flash attention: kv_len {kv_len} outside (0, {tk}]")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k, v on different devices")
    o = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.wcb_flash_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, tq, kv_len, 1.0 / math.sqrt(dh),
        *(st for x in (q, k, v, o) for st in x.stride()[:3]),
        _build.stream_handle(q.device))
    _build.check(lib, err, "flash attention")
    _build.launches["flash_attention"] += 1
    return o, lse


def flash_attention(q, k, v, n_heads: int):
    """Multi-head attention over merged-head (B, T, D) tensors, matching
    ``models.whisper.attention`` without a mask. Returns (B, Tq, D)."""
    b, tq, d = q.shape
    dh = d // n_heads
    o, _ = flash_attention_fwd(q.view(b, tq, n_heads, dh),
                               k.view(b, k.shape[1], n_heads, dh),
                               v.view(b, v.shape[1], n_heads, dh))
    return o.reshape(b, tq, d)
