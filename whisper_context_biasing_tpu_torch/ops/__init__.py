"""Hand-written CUDA kernels (Hopper, ``sm_90a``), each beside its plain
torch version. A wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; kernels build at first use (``_build``)."""

from ._build import launches, reset_launch_counts
from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from .fused_block import (
    fused_ln_matmul,
    fused_ln_matmul_bwd,
    fused_ln_matmul_fwd,
    fused_ln_matmul_plain,
)
from .mel_kernel import log_mel_spectrogram_fused, mel_energies, mel_energies_plain
from .quant_cross_attention import (
    quant_cross_attention_plain,
    quant_cross_attention_step,
    quant_cross_attention_step_indexed,
    quant_cross_attention_step_indexed_plain,
)

__all__ = [
    "launches",
    "reset_launch_counts",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "fused_ln_matmul",
    "fused_ln_matmul_bwd",
    "fused_ln_matmul_fwd",
    "fused_ln_matmul_plain",
    "log_mel_spectrogram_fused",
    "mel_energies",
    "mel_energies_plain",
    "quant_cross_attention_plain",
    "quant_cross_attention_step",
    "quant_cross_attention_step_indexed",
    "quant_cross_attention_step_indexed_plain",
]
