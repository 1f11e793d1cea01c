"""Flash attention, forward and backward: the CUDA kernels and their plain
torch versions.

The counterpart of the JAX package's ``ops/flash_attention.py``
(``flash_attention``: ``_fwd_kernel`` and ``_bwd_kernel`` under a
``custom_vjp``), full or causal, Tq != Tk. It runs the encoder's
self-attention and, in the full-sequence (training) decoder, the causal
self-attention and the cross-attention over the audio states.

The forward kernel (``csrc/flash_attention.cu``) reads merged-head
activations in place through strides, walks the keys in tiles with an
online softmax, and also returns the per-row logsumexp. The backward
(``csrc/flash_attention_bwd.cu``) recomputes the probabilities from that
logsumexp in two deterministic kernels (dq over q-tiles, dk/dv over
k-tiles). ``flash_attention`` ties them together as an autograd function.

bf16 runs every product on the tensor cores, with tiles moved by 16-byte
asynchronous copies: each bf16 tensor must start on a 16-byte boundary and
have batch, row and head strides that are multiples of 8 elements, or the
wrappers raise ``ValueError`` (contiguous tensors, merged-head views and
slices of a fused QKV projection at multiples of 8 all qualify). f32 is
true f32 on the CUDA cores and takes any strides.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._device import acc_dtype
from . import _build

HEAD_DIM = 64  # the kernels' head width (every Whisper size uses 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_FWD_SIGNATURES = {
    # dtype, q, k, v, o, lse, B, H, Tq, kv_len, scale, causal,
    # 4 x (batch, row, head) strides, stream
    "wcb_flash_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I] + [_L] * 12 + [_P],
    "wcb_flash_fwd_info": [_I, _P],  # dtype, int out[5]
}
_BWD_SIGNATURES = {
    # dtype, q, k, v, o, lse, do, dq, dk, dv, dterm, B, H, Tq, Tk, kv_len, scale,
    # causal, strides (24 int64: q, k, v, o, do, dq, dk, dv), stream
    "wcb_flash_bwd": [_I] + [_P] * 10 + [_I] * 5 + [_F, _I, _P, _P],
    "wcb_flash_bwd_info": [_I, _I, _P],  # dtype, dq (0) or dk/dv (1) kernel, int out[5]
}
ALIGN_BYTES = 16  # the bf16 kernels' copy width: 8 elements


def _keep_mask(tq: int, tk: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    """(Tq, Tk) True where query row i attends key j: j < kv_len, and j <= i
    when causal (``_masked_scores`` in the JAX package)."""
    col = torch.arange(tk, device=device)
    keep = (col < kv_len)[None, :].expand(tq, tk)
    if causal:
        keep = keep & (col[None, :] <= torch.arange(tq, device=device)[:, None])
    return keep


def _check_causal(tq: int, tk: int, causal: bool) -> None:
    if causal and tq != tk:
        raise ValueError(f"causal flash attention requires Tq == Tk, got {tq} != {tk}")


def flash_attention_fwd_plain(q, k, v, kv_len: int | None = None, causal: bool = False):
    """Plain torch version of the forward kernel. q (B, Tq, H, dh), k/v
    (B, Tk, H, dh) -> (o (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32,
    float64 for float64 inputs). Masked keys get the accumulator's minimum;
    probabilities are cast to v's dtype before P.V and the output is
    normalised after it."""
    tq, tk = q.shape[1], k.shape[1]
    _check_causal(tq, tk, causal)
    kv_len = tk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    ft = acc_dtype(q)
    qh, kh, vh = (x.transpose(1, 2).to(ft) for x in (q, k, v))  # (B, H, T, dh)
    s = (qh @ kh.transpose(-1, -2)) * scale
    s = torch.where(_keep_mask(tq, tk, kv_len, causal, q.device), s, torch.finfo(ft).min)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).to(ft) @ vh) / denom
    lse = (m + torch.log(denom))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_len: int | None = None,
                              causal: bool = False):
    """Plain torch version of the backward kernels: (dq, dk, dv) in the
    layouts and dtypes of q, k, v, from the forward's output ``o`` and
    logsumexp ``lse`` (B, H, Tq) and the output gradient ``do``. P is
    exp(S - lse), exactly 0 where masked; dS = P (do.v^T - rowsum(do*o))
    scale; dS is rounded to the input dtype before dS.k and dS^T.q, and P
    before P^T.do, as in the JAX package's ``_bwd_kernel``."""
    tq, tk = q.shape[1], k.shape[1]
    _check_causal(tq, tk, causal)
    kv_len = tk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    ft = acc_dtype(q)
    qh, kh, vh, oh, doh = (x.transpose(1, 2).to(ft) for x in (q, k, v, o, do))
    s = (qh @ kh.transpose(-1, -2)) * scale
    keep = _keep_mask(tq, tk, kv_len, causal, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = doh @ vh.transpose(-1, -2)
    dterm = (doh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - dterm) * scale
    dq = ds.to(k.dtype).to(ft) @ kh
    dk = ds.to(q.dtype).to(ft).transpose(-1, -2) @ qh
    dv = p.to(do.dtype).to(ft).transpose(-1, -2) @ doh
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _copy_aligned(x: torch.Tensor) -> bool:
    """Whether every head row of ``x`` (B, T, H, dh) starts on a 16-byte
    boundary; the stride of an axis of size 1 addresses nothing."""
    per = ALIGN_BYTES // x.element_size()
    return x.data_ptr() % ALIGN_BYTES == 0 and all(
        x.stride(i) % per == 0 for i in range(3) if x.shape[i] > 1)


def _check_kernel_inputs(what: str, tensors: dict, kv_len: int, tk: int) -> None:
    q = tensors["q"]
    bad = {n: x.dtype for n, x in tensors.items() if x.dtype != q.dtype}
    if q.dtype not in _DTYPES or bad:
        raise ValueError(f"{what} takes f32 or bf16 tensors of one dtype, got q {q.dtype}"
                         f"{', ' + str(bad) if bad else ''}")
    if q.shape[-1] != HEAD_DIM or any(x.ndim != 4 for x in tensors.values()):
        raise ValueError(f"{what} shapes: " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in tensors.items())
            + f" (4-D, head dim must be {HEAD_DIM})")
    if any(x.stride(-1) != 1 for x in tensors.values()):
        raise ValueError(f"{what} needs the head-dim axis contiguous")
    if any(x.device != q.device for x in tensors.values()):
        raise ValueError(f"{what}: tensors on different devices")
    if q.dtype == torch.bfloat16:
        for n, x in tensors.items():
            if not _copy_aligned(x):
                raise ValueError(
                    f"{what}: bf16 tensor {n} must start on a {ALIGN_BYTES}-byte boundary and "
                    f"have batch, row and head strides that are multiples of 8 elements (the "
                    f"kernels copy 16 bytes at a time), got data_ptr % {ALIGN_BYTES} = "
                    f"{x.data_ptr() % ALIGN_BYTES}, strides {tuple(x.stride())}")
    if not 0 < kv_len <= tk:
        raise ValueError(f"{what}: kv_len {kv_len} outside (0, {tk}]")


def flash_attention_fwd(q, k, v, kv_len: int | None = None, causal: bool = False):
    """Flash forward over (B, T, H, dh) tensors (any strides, last axis
    contiguous): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Returns (o (B, Tq, H, dh), lse (B, H, Tq) f32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_len, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    _check_causal(tq, tk, causal)
    kv_len = tk if kv_len is None else kv_len
    _check_kernel_inputs("flash attention", dict(q=q, k=k, v=v), kv_len, tk)
    if k.shape != (b, tk, h, dh) or v.shape != k.shape:
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    o = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _FWD_SIGNATURES)
    err = lib.wcb_flash_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, tq, kv_len, 1.0 / math.sqrt(dh), int(causal),
        *(st for x in (q, k, v, o) for st in x.stride()[:3]),
        _build.stream_handle(q.device))
    _build.check(lib, err, "flash attention")
    _build.count_launch("flash_attention")
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, kv_len: int | None = None,
                        causal: bool = False):
    """Flash backward over (B, T, H, dh) tensors (any strides, last axis
    contiguous): the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors. Returns contiguous (dq, dk, dv) shaped like q, k, v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, kv_len, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward: unsupported device {q.device}")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    _check_causal(tq, tk, causal)
    kv_len = tk if kv_len is None else kv_len
    _check_kernel_inputs("flash attention backward", dict(q=q, k=k, v=v, o=o, do=do),
                         kv_len, tk)
    if (k.shape != (b, tk, h, dh) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"flash attention backward shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, tq) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"flash attention backward: lse must be contiguous f32 {(b, h, tq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (q, k, v))
    dterm = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (_L * 24)(*(st for x in (q, k, v, o, do, dq, dk, dv) for st in x.stride()[:3]))
    lib = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.wcb_flash_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dterm.data_ptr(), b, h, tq, tk, kv_len, 1.0 / math.sqrt(dh), int(causal),
        ctypes.cast(strides, _P), _build.stream_handle(q.device))
    _build.check(lib, err, "flash attention backward")
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def kernel_info() -> list[dict]:
    """``_build.kernel_info_row`` of each flash kernel (forward, backward dq,
    backward dk/dv) in f32 and bf16."""
    fwd = _build.library("flash_attention", _FWD_SIGNATURES)
    bwd = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    return [_build.kernel_info_row(lib, fn, args, f"flash {kernel}", dtype)
            for dtype, code in _DTYPES.items()
            for kernel, lib, fn, args in (("fwd", fwd, fwd.wcb_flash_fwd_info, (code,)),
                                          ("bwd dq", bwd, bwd.wcb_flash_bwd_info, (code, 0)),
                                          ("bwd dk/dv", bwd, bwd.wcb_flash_bwd_info, (code, 1)))]


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient; saves
    q, k, v, the output and the logsumexp the forward writes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd's tensor, not a caller's: bring it to a layout the kernels take
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not _copy_aligned(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, n_heads: int, causal: bool = False):
    """Multi-head attention over merged-head (B, T, D) tensors, matching
    ``models.whisper.attention`` with no mask (``causal=False``) or the
    causal mask (``causal=True``, Tq == Tk). Differentiable through the
    backward kernels. Returns (B, Tq, D)."""
    b, tq, d = q.shape
    tk = k.shape[1]
    _check_causal(tq, tk, causal)
    dh = d // n_heads
    o = _FlashAttention.apply(q.view(b, tq, n_heads, dh), k.view(b, tk, n_heads, dh),
                              v.view(b, tk, n_heads, dh), causal)
    return o.reshape(b, tq, d)
