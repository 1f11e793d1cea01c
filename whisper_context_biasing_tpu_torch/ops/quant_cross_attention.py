"""Int8 cross-attention for the decode step: the CUDA kernel and its plain
torch version.

The counterpart of the JAX package's ``ops/quant_cross_attention.py``
(``quant_cross_attention_step_indexed``). K/V are int8 with one f32 scale
per (layer, row, position), stored (L, B, 1, T_pad); a zero k-scale marks a
padded position. The kernel (``csrc/quant_cross_attention.cu``) reads
layer ``l`` of the stacked tensors through a pointer offset; a thread block
cluster of up to 8 blocks shares one (batch row, head) along T_pad and
exchanges the softmax statistics and the partial outputs through
distributed shared memory (one launch, no workspace, the same bits on every
run). It needs T_pad to be a multiple of 64 (``quantize_cross_kv`` pads to
128) and at most 8 x 512 rows. The one-layer form,
``quant_cross_attention_step`` (JAX's function of that name), is this
kernel applied to ``layer=0`` of a (1, B, T_pad, D) view; as in JAX, no
path calls it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._device import acc_dtype
from . import _build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k_q, k_s, v_q, v_s, out, B, T_pad, D, splits, sqrt(dh), stream
    "wcb_quant_cross": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "wcb_quant_cross_info": [_I, _I, _P],  # dtype, key rows a block, int out[5]
}
SPLIT_ROWS = 64         # a block's slice of T_pad is a whole multiple of this
MAX_SPLITS = 8          # blocks of one cluster
MAX_BLOCK_ROWS = 512    # a thread holds its part of 8 x 64 key and value rows in registers
TARGET_BLOCKS = 132     # a block for each of the card's SMs


def quant_cross_attention_plain(q, k_q, k_s, v_q, v_s, n_heads: int):
    """Cross attention of q (B, S, D) against one layer's int8 K/V: k_q/v_q
    (B, T_pad, D) int8, k_s/v_s (B, 1, T_pad) f32. The op order of the JAX
    package's ``models.whisper._attention_quant_cross``, in f32 (float64 for
    a float64 q)."""
    b, s, d = q.shape
    dh = d // n_heads
    t = k_q.shape[1]
    ft = acc_dtype(q)
    qh = q.view(b, s, n_heads, dh).transpose(1, 2).to(ft)              # (B, H, S, dh)
    kh = k_q.to(q.dtype).view(b, t, n_heads, dh).permute(0, 2, 3, 1).to(ft)  # (B, H, dh, T)
    scores = qh @ kh                                                   # (B, H, S, T)
    ks = k_s[:, None]                                                  # (B, 1, 1, T)
    scores = torch.where(ks > 0.0, scores * (ks / math.sqrt(dh)), torch.finfo(ft).min)
    w = torch.softmax(scores, dim=-1)
    # fold the value scale into the probabilities
    w = (w * v_s[:, None]).to(q.dtype)
    vh = v_q.to(q.dtype).view(b, t, n_heads, dh).transpose(1, 2).to(ft)
    out = w.to(ft) @ vh                                                # (B, H, S, dh)
    return out.transpose(1, 2).reshape(b, s, d).to(q.dtype)


def quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s, layer: int,
                                             n_heads: int):
    """Plain torch version of the kernel: layer ``layer`` of the stacked
    (L, B, T_pad, D) int8 K/V (a view, no copy)."""
    return quant_cross_attention_plain(q, k_q[layer], k_s[layer], v_q[layer],
                                       v_s[layer], n_heads)


def pick_splits(t_pad: int, rows_heads: int) -> int:
    """How many blocks (one cluster) share a (batch row, head) along T_pad:
    the fewest that put TARGET_BLOCKS blocks on the card, so that every SM
    has loads in flight, else the most there are. A block's slice must be a
    whole multiple of SPLIT_ROWS and at most MAX_BLOCK_ROWS."""
    fits = [c for c in range(1, MAX_SPLITS + 1)
            if t_pad % (c * SPLIT_ROWS) == 0 and t_pad // c <= MAX_BLOCK_ROWS]
    if not fits:
        raise ValueError(f"quant cross attention: k_q has T_pad = {t_pad}; the kernel takes a "
                         f"multiple of {SPLIT_ROWS} up to {MAX_SPLITS * MAX_BLOCK_ROWS}")
    return next((c for c in fits if c * rows_heads >= TARGET_BLOCKS), fits[-1])


def quant_cross_attention_step_indexed(q, k_q, k_s, v_q, v_s, layer: int,
                                       n_heads: int):
    """Single-query cross attention of q (B, 1, D) against layer ``layer``
    of k_q/v_q (L, B, T_pad, D) int8 and k_s/v_s (L, B, 1, T_pad) f32:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (B, 1, D) in q's dtype."""
    if q.device.type == "cpu":
        return quant_cross_attention_step_indexed_plain(q, k_q, k_s, v_q, v_s,
                                                        layer, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"quant cross attention: unsupported device {q.device}")
    n_layers, b, t_pad, d = k_q.shape
    if q.dtype not in _DTYPES or q.shape != (b, 1, d) or d != n_heads * HEAD_DIM:
        raise ValueError(f"quant cross attention: q {tuple(q.shape)} {q.dtype} against "
                         f"K/V {tuple(k_q.shape)} with {n_heads} heads of {HEAD_DIM}")
    if (k_q.dtype != torch.int8 or v_q.dtype != torch.int8 or v_q.shape != k_q.shape
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32
            or k_s.shape != (n_layers, b, 1, t_pad) or v_s.shape != k_s.shape):
        raise ValueError("quant cross attention: K/V must be int8 (L, B, T_pad, D) "
                         "with f32 scales (L, B, 1, T_pad)")
    if not all(x.is_contiguous() for x in (q, k_q, k_s, v_q, v_s)):
        raise ValueError("quant cross attention: inputs must be contiguous")
    if not all(x.device == q.device for x in (k_q, k_s, v_q, v_s)):
        raise ValueError("quant cross attention: inputs on different devices")
    if q.data_ptr() % 16 or k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("quant cross attention: q, k_q and v_q must start on a 16-byte boundary "
                         "(the kernel loads 16 bytes at a time)")
    if not 0 <= layer < n_layers:
        raise ValueError(f"quant cross attention: layer {layer} outside [0, {n_layers})")
    splits = pick_splits(t_pad, b * n_heads)
    out = torch.empty_like(q)
    kv_off = layer * b * t_pad * d          # int8: elements are bytes
    s_off = layer * b * t_pad * 4           # f32 scales
    lib = _build.library("quant_cross_attention", _SIGNATURES)
    err = lib.wcb_quant_cross(
        _DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr() + kv_off, k_s.data_ptr() + s_off,
        v_q.data_ptr() + kv_off, v_s.data_ptr() + s_off, out.data_ptr(), b, t_pad, d,
        splits, math.sqrt(d // n_heads), _build.stream_handle(q.device))
    _build.check(lib, err, "quant cross attention")
    _build.count_launch("quant_cross_attention")
    return out


def quant_cross_attention_step(q, k_q, k_s, v_q, v_s, n_heads: int):
    """Single-query cross attention of q (B, 1, D) against one layer's int8
    K/V: k_q/v_q (B, T_pad, D) int8, k_s/v_s (B, 1, T_pad) f32. The kernel
    (on ``layer=0`` of a one-layer view) for CUDA tensors, the plain version
    for CPU tensors. Returns (B, 1, D) in q's dtype."""
    if q.device.type == "cpu":
        return quant_cross_attention_plain(q, k_q, k_s, v_q, v_s, n_heads)
    return quant_cross_attention_step_indexed(q, k_q[None], k_s[None], v_q[None], v_s[None],
                                              0, n_heads)


def kernel_info(block_rows: int) -> list[dict]:
    """``_build.kernel_info_row`` of the f32 and bf16 kernels when a block
    owns ``block_rows`` key rows."""
    lib = _build.library("quant_cross_attention", _SIGNATURES)
    return [_build.kernel_info_row(lib, lib.wcb_quant_cross_info, (code, block_rows),
                                   "quant cross", dtype) for dtype, code in _DTYPES.items()]
