"""Audio layer: host-side loading/resampling and the torch log-mel frontend."""

from .io import load_audio, pcm_to_float32, resample
from .mel import (
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    mel_filter_bank,
    pad_or_trim,
    select_mel_frontend,
)

__all__ = [
    "load_audio",
    "pcm_to_float32",
    "resample",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "mel_filter_bank",
    "pad_or_trim",
    "select_mel_frontend",
    "SAMPLE_RATE",
    "N_FFT",
    "N_FRAMES",
    "N_SAMPLES",
    "HOP_LENGTH",
]
