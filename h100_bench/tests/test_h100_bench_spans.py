"""The readers of the program's own spans (``core/spans.py``) on the tiny
cells on the CPU: in a ``--trace 1`` run the host-clock readings and the
live-row share are finite numbers and the device-ms readings are absent
(the CPU has no CUDA events); with no traced segment every reader finds
nothing."""

import json
import math
import pathlib

import pytest

from core import runner
from tiny import tiny_spec

BENCH = json.loads((pathlib.Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
DEVICE_MS = {"mel_stage_ms.serve", "prefill_ms.serve", "to_device_ms.train", "forward_ms.train",
             "backward_ms.train", "optimizer_ms.train"}
HOST = {"decode_issue_ms_per_step", "decode_sync_ms_per_step", "bias_ms_per_step",
        "live_row_share.serve"}
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in DEVICE_MS | HOST}
SEED = 2 ** 31 + 29


@pytest.fixture
def no_spans():
    from whisper_context_biasing_tpu_torch.utils.profiling import reset_spans

    reset_spans()
    yield
    reset_spans()


@pytest.mark.parametrize("cell", ["serve.base.en.biased32", "train.base.en.weightce"])
def test_traced_run_reads_the_host_spans(tiny_port, no_spans, cell):
    line = runner.run_cell(tiny_spec(cell), SEED, 0.3, True, "cpu")
    mine = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    got = {n: line["metrics"][n]["value"] for n in mine if n in line["metrics"]}
    assert set(got) == mine & HOST
    assert all(math.isfinite(v) and v >= 0 for v in got.values())
    if "live_row_share.serve" in got:
        assert 0 < got["live_row_share.serve"] <= 100


@pytest.mark.parametrize("cell", ["serve.base.en.biased32", "train.base.en.weightce"])
def test_readers_find_nothing_without_a_traced_segment(tiny_port, no_spans, cell):
    runner.run_cell(tiny_spec(cell), SEED, 0.3, False, "cpu")
    view = dict(stats={}, wall=0.0, trace=None)
    assert {n: runner.reader(n).read(view) for n in SPAN_METRICS} == dict.fromkeys(SPAN_METRICS)


def test_every_span_reader_is_a_program_span_metric():
    assert set(SPAN_METRICS) == DEVICE_MS | HOST
    assert {m["source"] for m in SPAN_METRICS.values()} == {"program_span"}
