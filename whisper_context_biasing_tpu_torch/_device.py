"""Device selection shared by the entry points (the card by default, the CPU
only when the caller asks for it), and the accumulator dtype shared by the
model and the kernels' plain versions."""

from __future__ import annotations

import torch


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Accumulator dtype of a product, softmax or normalization over x: f32,
    or x's dtype when that is wider (the JAX package's ``models.whisper._acc``).
    f32 for bf16 and f32 alike, so only a float64 model widens."""
    return x.dtype if x.dtype.itemsize > 4 else torch.float32


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
