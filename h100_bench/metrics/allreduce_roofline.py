"""Gradient all-reduce (train/step.py:_sum_over_data, NCCL): the bound of the
step's all-reduce (``core/counts.py:allreduce_bound_s``: the gradients that
exist and the loss, in f32, sent once and received once at 450 GB/s a
direction) over the device time of rank 0's NCCL kernels, summed over the
traced steps."""

from core import readings

UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    got = readings.allreduce(run)
    return None if got is None else 100.0 * got[0] / got[1]
