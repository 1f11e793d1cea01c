"""Log-mel frontend: the device ms of the program's ``mel.stage`` span, the copy
of the stacked batch to the card inside ``Pipeline.mel``, in the first traced
batch."""

from core import spans

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.device_ms("mel", "mel.stage")
