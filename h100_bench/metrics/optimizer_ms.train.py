"""Training step (train/step.py, train/optim.py): the device ms of the
``train.optimizer`` span (the global norm, the clip and AdamW's update) in the
first traced step."""

from core import spans

UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return spans.device_ms("train.step", "train.optimizer")
