"""BENCHMARK.json and the files it names, the result line of a run, and
the run's refusals: no card, JAX loaded."""

import json
import math
import pathlib
import re
import subprocess
import sys

import pytest

from core import runner
from tiny import tiny_spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100_bench/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "h100_bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100_bench/workloads" / f"{w['name']}.json").is_file()
        mix = json.loads((ROOT / "h100_bench/traffic" / f"{w['traffic']}.json").read_text())
        assert math.prod(mix.get("mesh", [1])) == w["chips"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = runner.reader(metric)
    assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moved["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    spec = runner.load_spec(cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    assert set(spec["cell"]["limits"])


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(tiny_port, trace):
    line = runner.run_cell(tiny_spec("serve.base.en.biased32"), 2 ** 31 + 7, 0.5, bool(trace),
                           "cpu")
    assert list(line)[-1] == "checks"
    want = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line) == want | ({"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"serve_audio_s_per_s", "setup_s"}
    json.dumps(line)


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                           "serve.base.en.biased32", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.stdout == ""
