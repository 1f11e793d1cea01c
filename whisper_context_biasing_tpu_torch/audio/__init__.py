"""Audio layer: host-side loading/resampling and the torch log-mel frontend."""

from .io import EXTRA_DECODERS, load_audio, pcm_to_float32, resample
from .mp3 import decode_mp3

# the corpus audio is .mp3 (SURVEY.md §2.2); decode via libmpg123 when the
# library is present (errors lazily with a pointer to WCB_MPG123_PATH if not)
EXTRA_DECODERS.setdefault(".mp3", decode_mp3)
from .vad import has_speech, next_onset, resolve_vad, speech_segments
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
    "EXTRA_DECODERS",
    "decode_mp3",
    "load_audio",
    "pcm_to_float32",
    "resample",
    "speech_segments",
    "has_speech",
    "next_onset",
    "resolve_vad",
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
