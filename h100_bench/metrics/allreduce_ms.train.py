"""Gradient all-reduce (train/step.py:_sum_over_data, NCCL): the device ms of
the NCCL kernels on rank 0 in a traced step, the loss's count all-reduces
among them. A kernel starts when rank 0 reaches it and ends once every rank
has, so the time includes the wait for the slowest rank."""

from core import readings

UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    got = readings.allreduce(run)
    return None if got is None else 1e3 * got[1] / got[2]
