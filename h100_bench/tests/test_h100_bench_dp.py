"""The cell across cards (``drivers/train_dp.py``, ``core/ranks.py``) at
the tiny size on two gloo ranks on the CPU: a run goes through the
warm-up, a short window, the traced steps and the check with the other
rank in lockstep, and comes out correct with the replicas equal; each
fault the cell can have comes out not correct, the exchange left out by
``rank_gap`` too; a rank that dies or stalls ends the run non-zero within
the timeout, and leaves no process behind."""

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest
import torch

from core import faults, runner
from tiny import tiny_spec

torch.set_num_threads(2)
HERE = pathlib.Path(__file__).resolve().parent
SEED = 2 ** 31 + 99
CELL = "train.large-v3.dp4"


def _spec(fault=None):
    spec = tiny_spec(CELL, rows_per_step=8, mesh=[2, 1])
    if fault:
        spec["fault"] = fault
    return spec


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_across_ranks_is_correct(trace):
    line = runner.run_cell(_spec(), SEED, 0.3, bool(trace), "cpu")
    assert line["correct"] and line["attempted"] > 0, line["checks"]
    assert line["checks"]["rank_gap"]["value"] == 0.0
    assert line["device"]["count"] == 2
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
        # no NCCL on the CPU: the all-reduce's readers find nothing
        assert {"device_idle.train", "mfu.train"} <= set(line["metrics"])
        assert not {"allreduce_ms.train", "allreduce_roofline"} & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}


def test_rate_counts_every_rank_and_mfu_is_per_card():
    from core import traffic
    from drivers import train, train_dp

    spec = runner.load_spec(CELL)
    assert spec["traffic"]["mesh"] == [4, 1] and spec["workload"]["chips"] == 4
    drv = train_dp.Driver.__new__(train_dp.Driver)
    drv.cards, drv.tr = 4, spec["traffic"]
    drv.shapes = traffic.train_shapes(drv.tr)
    assert drv.audio_s() == 4 * train.Driver.audio_s(drv)
    run = dict(stats=dict(flops=4e15, cards=4), wall=2.0)
    assert runner.reader("mfu.train").read(run) == pytest.approx(100 * 1e15 / (2 * 989e12))


@pytest.mark.parametrize("name", sorted({**faults.TRAIN, **faults.ACROSS}))
def test_fault_across_ranks_is_caught(name):
    line = runner.run_cell(_spec(name), SEED, 0.3, False, "cpu")
    assert not line["correct"], line["checks"]
    if name == "no_allreduce":
        assert line["checks"]["rank_gap"]["value"] > line["checks"]["rank_gap"]["limit"]


RUN = """
import sys
sys.path[:0] = {paths!r}
import torch
torch.set_num_threads(2)
from core import ranks, runner
from tiny import tiny_spec
ranks.TIMEOUT_S = {timeout}
spec = tiny_spec("{cell}", rows_per_step=8, mesh=[2, 1])
spec["fault"] = "{fault}"
print(runner.run_cell(spec, {seed}, 0.3, False, "cpu"))
"""


@pytest.mark.parametrize("fault", ["rank_dies", "rank_stalls"])
def test_a_rank_that_fails_ends_the_run(fault):
    timeout = 15
    code = RUN.format(paths=[str(HERE), str(HERE.parent), str(HERE.parents[1])], timeout=timeout,
                      cell=CELL, fault=fault, seed=SEED)
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240)
    took = time.monotonic() - t
    assert proc.returncode == 4 and proc.stdout == "", proc.stderr[-2000:]
    assert "ending the run" in proc.stderr
    assert took < 120 if fault == "rank_dies" else took < timeout + 120
    pids = [int(x) for x in re.search(r"started as pids ([\d ]+)", proc.stderr).group(1).split()]
    time.sleep(1.0)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_reference_split_over_devices_reads_as_one():
    """The reference's parts on two devices (one host thread each, their
    gradients added after) read as on one, to f32 rounding."""
    from drivers import train_dp

    spec = _spec()
    world = train_dp.start_world(spec, "cpu")
    try:
        drv = train_dp.Driver(spec, SEED, "cpu", world=world)
        drv.warm_up()
        drv.free()
        one = drv.reference_steps()
        drv.ref_devices = lambda: [torch.device("cpu")] * 2
        two = drv.reference_steps()
    finally:
        world.close()
    assert two["loss"] == pytest.approx(one["loss"], rel=1e-6)
    for key in ("grad1", "change"):
        assert all(two[key][n] == pytest.approx(v, rel=1e-5, abs=1e-12)
                   for n, v in one[key].items())
