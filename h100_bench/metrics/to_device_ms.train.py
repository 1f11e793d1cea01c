"""Training step (train/step.py): the device ms of the ``train.to_device`` span,
the step's batch copied to the card, in the first traced step."""

from core import spans

UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return spans.device_ms("train.step", "train.to_device")
