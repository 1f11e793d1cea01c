"""Training step (train/step.py): the mean device ms of a microbatch's
``train.forward`` span (K1, the forward, the WeightCE loss) in the first traced
step."""

from core import spans

UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return spans.device_ms("train.step", "train.forward")
