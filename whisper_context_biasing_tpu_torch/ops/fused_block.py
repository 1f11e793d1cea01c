"""Fused LayerNorm + matmul (+ bias + gelu): the CUDA kernel, its plain
torch version, and the autograd function around them.

The counterpart of the JAX package's ``ops/fused_block.py``
(``fused_ln_matmul``: ``_kernel`` under a ``custom_vjp`` with the
hand-derived ``_core_bwd``). It computes ``act(LN(x) @ W + b)`` in one pass
at two sites of every encoder block and every full-sequence decoder block
(``models/whisper.py``): the pre-attention LayerNorm with the QKV
projections (W = [Wq | Wk | Wv]) and the cross-attention query, and the
pre-MLP LayerNorm with the first MLP product and its gelu.

The numerics contract is ``fused_ln_matmul_plain`` (the JAX ``_reference``
written out): LayerNorm statistics in f32 (the variance as the mean of
squared deviations, ``rsqrt(var + 1e-5)``), ``y = xhat * g + beta`` in f32
rounded to W's dtype, the product accumulated in f32, ``+ b`` in f32, the
activation in f32, one cast to x's dtype. In bf16 this differs from the
unfused ``_proj``, which rounds the product before adding the bias, so the
fused and unfused configs are different functions there.

The forward kernels are in ``csrc/fused_ln_matmul.cu``. The bf16 one
normalizes a block's 128 rows (64 above d = 512) once into a shared-memory
tile and sweeps a group of 128-column tiles of W against it on the tensor
cores (``wgmma``);
``tiles_per_group`` picks the group so that the grid fills the card. It
needs d to be a multiple of 64 up to 1,280 and E a multiple of 8. The f32
one runs true f32 on the CUDA cores and needs d to be a multiple of 8. The
backward is
``_core_bwd`` written in torch: the saved tensors are exactly the inputs;
it recomputes ``xhat`` in f32 and re-runs the product only for an
activation site (gelu' needs the pre-activation). JAX computes that
backward with XLA ops outside any Pallas kernel, so there is no backward
kernel to port: its products are ``torch.mm`` in the compute dtype with
f32 output (``_mm_acc``: the JAX ``preferred_element_type=f32``
products), and it launches no kernel of the port.

The JAX call pads rows to a multiple of 256 and tiles W's columns to fit
VMEM; both exist for TPU tiling. The CUDA kernel masks its ragged edges
instead, so nothing is padded here.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .._device import acc_dtype
from . import _build

EPS = 1e-5
_ACTS = {None: 0, "gelu": 1, "gelu_tanh": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # dtype, x, g, beta, w, b, out, N, d, E, ldx, ldw, act, tiles_per_group, stream
    "wcb_fused_ln_matmul": [_I] + [_P] * 6 + [_I] * 3 + [_L, _L, _I, _I, _P],
    "wcb_fused_ln_matmul_info": [_I, _I, _P],  # dtype, d, int out[5]
}
# the bf16 kernel's shape (csrc/fused_ln_matmul.cu): 128-column tiles of W in
# 64-deep slabs through a ring; a block owns 64 rows per warpgroup
BF16_TILE_COLS = 128
BF16_MAX_D = 1280
SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM; 1 KB a block is reserved
LN_COST_TILES = 1.75        # a block's LayerNorm pass, in units of one tile's products


def _check_act(act) -> None:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")


def _apply_act(s: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return s
    return F.gelu(s, approximate="tanh" if act == "gelu_tanh" else "none")


def _normalize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xhat, rstd) of the last axis, in f32 (float64 for a float64 x)."""
    xf = x.to(acc_dtype(x))
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + EPS)
    return xc * rstd, rstd


def fused_ln_matmul_plain(x, g, beta, w, b=None, act=None):
    """Plain torch version of the kernel: ``act(LN(x) @ w + b)`` over
    x (..., d), w (d, E) -> x.shape[:-1] + (E,) in x's dtype, summed in f32
    (float64 for a float64 x)."""
    _check_act(act)
    xhat, _ = _normalize(x)
    ft = xhat.dtype
    y = xhat * g.to(ft) + beta.to(ft)
    s = y.to(w.dtype).to(ft) @ w.to(ft)
    if b is not None:
        s = s + b.to(ft)
    return _apply_act(s, act).to(x.dtype)


def _check_kernel_inputs(x2d, g, beta, w, b) -> None:
    n, d = x2d.shape
    if w.ndim != 2 or w.shape[0] != d or g.shape != (d,) or beta.shape != (d,) or (
            b is not None and b.shape != (w.shape[1],)):
        raise ValueError(f"fused_ln_matmul shapes: x {tuple(x2d.shape)}, g {tuple(g.shape)}, "
                         f"beta {tuple(beta.shape)}, w {tuple(w.shape)}"
                         f"{'' if b is None else f', b {tuple(b.shape)}'}")
    if x2d.dtype not in _DTYPES or w.dtype != x2d.dtype:
        raise ValueError(f"fused_ln_matmul kernel takes x and w of one dtype, f32 or bf16; "
                         f"got x {x2d.dtype}, w {w.dtype}")
    if any(t.device != x2d.device for t in (g, beta, w) + (() if b is None else (b,))):
        raise ValueError("fused_ln_matmul: tensors on different devices")
    if d % 8:
        raise ValueError(f"fused_ln_matmul kernel needs d % 8 == 0 (16-byte k-groups), got {d}")


def bf16_block_rows(d: int) -> int:
    """Rows of x a bf16 block owns: two warpgroups of 64 where the
    normalized tile leaves room for the ring, else one."""
    return 128 if d <= 512 else 64


def bf16_smem_bytes(d: int) -> int:
    """Dynamic shared memory of a bf16 block: the normalized (rows, d) tile,
    the ring of (128, 64) W slabs (4 stages, 3 above d = 1,024) and 16 x 72
    staging values per warp."""
    rows = bf16_block_rows(d)
    stages = 4 if d <= 1024 else 3
    return 2 * (rows * d + stages * BF16_TILE_COLS * 64 + rows // 16 * 16 * 72)


def tiles_per_group(n: int, d: int, e: int, n_sms: int) -> int:
    """How many 128-column tiles of W one bf16 block sweeps against its
    resident normalized tile. Fewer tiles a block means more blocks (the row
    blocks alone do not fill the card) but the LayerNorm redone once more
    for each group; the choice minimises waves x (tiles + the LayerNorm's
    cost) with the card's resident blocks as the wave."""
    slots = n_sms * max(1, SM_SMEM_BYTES // (bf16_smem_bytes(d) + 1024))
    row_blocks = -(-n // bf16_block_rows(d))
    n_tiles = -(-e // BF16_TILE_COLS)

    def cost(tpg: int) -> float:
        groups = -(-n_tiles // tpg)
        return math.ceil(row_blocks * groups / slots) * (tpg + LN_COST_TILES)

    # ties go to the larger group: the LayerNorm redone fewer times
    return min(range(n_tiles, 0, -1), key=cost)


def fused_ln_matmul_fwd(x2d, g, beta, w, b=None, act=None):
    """``act(LN(x2d) @ w + b)`` over x2d (N, d), w (d, E): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (N, E) in
    x2d's dtype."""
    _check_act(act)
    if x2d.device.type == "cpu":
        return fused_ln_matmul_plain(x2d, g, beta, w, b, act)
    if x2d.device.type != "cuda":
        raise ValueError(f"fused_ln_matmul: unsupported device {x2d.device}")
    _check_kernel_inputs(x2d, g, beta, w, b)
    if x2d.stride(-1) != 1:
        x2d = x2d.contiguous()
    # the kernel reads W^T (E, d) with k contiguous: a transposed view of an
    # nn.Linear weight is read in place; any other layout is copied once
    wt = w.t()
    if wt.stride(-1) != 1:
        wt = wt.contiguous()
    if (x2d.stride(0) % 8 or wt.stride(0) % 8 or x2d.data_ptr() % 16
            or wt.data_ptr() % 16):
        raise ValueError("fused_ln_matmul kernel needs row strides that are multiples of 8 "
                         "and 16-byte aligned x and w")
    n, d = x2d.shape
    e = wt.shape[0]
    g32, beta32 = g.float().contiguous(), beta.float().contiguous()
    b32 = None if b is None else b.float().contiguous()
    tpg = 0
    if x2d.dtype == torch.bfloat16:
        if d % 64 or d > BF16_MAX_D:
            raise ValueError(f"fused_ln_matmul bf16 kernel: x has d = {d}; it takes a multiple "
                             f"of 64 up to {BF16_MAX_D} (whole k-slabs of the normalized tile)")
        if e % 8:
            raise ValueError(f"fused_ln_matmul bf16 kernel: w has E = {e} columns; it takes a "
                             f"multiple of 8 (16-byte output stores)")
        if any(t.data_ptr() % 16 for t in (g32, beta32) + (() if b32 is None else (b32,))):
            raise ValueError("fused_ln_matmul bf16 kernel needs 16-byte aligned g, beta and b")
        tpg = tiles_per_group(
            n, d, e, torch.cuda.get_device_properties(x2d.device).multi_processor_count)
    out = torch.empty((n, e), dtype=x2d.dtype, device=x2d.device)
    lib = _build.library("fused_ln_matmul", _SIGNATURES)
    err = lib.wcb_fused_ln_matmul(
        _DTYPES[x2d.dtype], x2d.data_ptr(), g32.data_ptr(), beta32.data_ptr(), wt.data_ptr(),
        None if b32 is None else b32.data_ptr(), out.data_ptr(), n, d, e, x2d.stride(0),
        wt.stride(0), _ACTS[act], tpg, _build.stream_handle(x2d.device))
    _build.check(lib, err, "fused_ln_matmul")
    _build.count_launch("fused_ln_matmul")
    return out


def kernel_info(d: int) -> list[dict]:
    """``_build.kernel_info_row`` of the f32 kernel and of the bf16 kernel
    at width ``d`` (its erf gelu instance, the largest)."""
    lib = _build.library("fused_ln_matmul", _SIGNATURES)
    return [_build.kernel_info_row(lib, lib.wcb_fused_ln_matmul_info, (code, d),
                                   "fused LN+matmul", dtype) for dtype, code in _DTYPES.items()]


def _mm_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over 2-D operands of one dtype, summed and returned in f32,
    float64 for float64 operands (the JAX ``preferred_element_type=_acc``
    product): bf16 operands on the card stay bf16 (tensor-core products, f32
    output); elsewhere they are widened first. bf16 products are exact in
    f32, so the two differ only in the order of the sums."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    ft = acc_dtype(a)
    return a.to(ft) @ b.to(ft)


def fused_ln_matmul_bwd(x2d, g, beta, w, b, dout, act):
    """Gradients (dx, dg, dbeta, dw, db) of ``act(LN(x2d) @ w + b)`` for the
    output gradient ``dout``, each in its primal's dtype (db None without a
    bias): the JAX package's ``_core_bwd``."""
    xhat, rstd = _normalize(x2d)
    ft = xhat.dtype
    gf = g.to(ft)
    yc = (xhat * gf + beta.to(ft)).to(w.dtype)
    df = dout.to(ft)
    if act is not None:
        s = _mm_acc(yc, w)
        if b is not None:
            s = s + b.to(ft)
        ds = torch.ops.aten.gelu_backward(
            df, s, approximate="tanh" if act == "gelu_tanh" else "none")
    else:
        ds = df
    db = None if b is None else ds.sum(dim=0).to(b.dtype)
    dsc = ds.to(w.dtype)
    dw = _mm_acc(yc.t(), dsc).to(w.dtype)
    dy = _mm_acc(dsc, w.t())
    dg = (dy * xhat).sum(dim=0).to(g.dtype)
    dbeta = dy.sum(dim=0).to(beta.dtype)
    dxhat = dy * gf
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x2d.dtype), dg, dbeta, dw, db


class _FusedLnMatmul(torch.autograd.Function):
    """The forward kernel with the hand-derived backward; saves the inputs."""

    @staticmethod
    def forward(ctx, x2d, g, beta, w, b, act):
        ctx.act = act
        ctx.save_for_backward(x2d, g, beta, w, b)
        return fused_ln_matmul_fwd(x2d, g, beta, w, b, act)

    @staticmethod
    def backward(ctx, dout):
        return (*fused_ln_matmul_bwd(*ctx.saved_tensors, dout, ctx.act), None)


def fused_ln_matmul(x, g, beta, w, b=None, act=None):
    """``act(LayerNorm(x) @ w + b)`` over x (..., d) with LayerNorm scale
    ``g`` and bias ``beta`` (d,), w (d, E), b (E,) or None, act None,
    "gelu" or "gelu_tanh". Differentiable (the hand-derived backward).
    Returns x.shape[:-1] + (E,) in x's dtype."""
    _check_act(act)
    d = x.shape[-1]
    out = _FusedLnMatmul.apply(x.reshape(-1, d), g, beta, w, b, act)
    return out.reshape(*x.shape[:-1], w.shape[1])
