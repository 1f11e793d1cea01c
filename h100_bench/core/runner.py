"""One run of one cell: find its files and its driver by name, set up,
warm up, measure the window, optionally trace a few more batches or
steps, free the program's state, judge its outputs against the
reference, and assemble the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from .weights import geometry

HERE = pathlib.Path(__file__).resolve().parents[1]   # the benchmark's folder
ROOT = HERE.parent                                     # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_context_biasing_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is JAX, Flax or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_mix(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``; one that names another
    mix as ``rows_from`` takes that mix's parameters where it sets none."""
    mix = _json(HERE / "traffic" / f"{name}.json")
    if "rows_from" in mix:
        mix = {**load_mix(mix["rows_from"]), **mix}
    return mix


def load_spec(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and cell file, and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / cfg_entry["file"])
    return dict(name=name, workload=entry, config=config, g=geometry(config),
                traffic=load_mix(entry["traffic"]),
                cell=_json(HERE / "workloads" / f"{name}.json"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def reader(name: str):
    """The per-layer metric's reader module, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The driver module of a traffic ``kind``, ``drivers/<kind>.py``."""
    return importlib.import_module(f"drivers.{kind}")


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool, device="cuda",
             t0: float | None = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    drv = driver(spec["traffic"]["kind"]).Driver(spec, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drv.warm_up()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e2e = drv.window(seconds)
    e2e["setup_s"] = setup_s
    # a driver across cards reports the fullest card's peak
    peak = (drv.memory_peak() if hasattr(drv, "memory_peak")
            else torch.cuda.max_memory_allocated() if cuda else 0)
    traced = drv.traced() if trace_on else None
    attempted, failed = drv.attempted(), drv.failed()
    view = dict(stats=drv.stats, wall=drv.wall, trace=traced)
    print(window_summary(drv.stats), file=sys.stderr)
    drv.free()
    t = time.perf_counter()
    checks = drv.check()
    print(f"check: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    limits = spec["cell"]["limits"]
    correct = all(math.isfinite(v) and v <= limits[n] for n, v in checks)
    metrics = {}
    if trace_on:
        for m in spec["per_layer"]:
            value = reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=getattr(drv, "cards", 1), memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct) and failed == 0, attempted=attempted, failed=failed,
                metrics=metrics, device=dev)
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        line["breakdown"] = traced["breakdown"]
    line["checks"] = {n: dict(value=v, limit=limits[n]) for n, v in checks}
    return line


def window_summary(stats: dict) -> str:
    """The window's batches or steps and the spread of their walls."""
    ends = stats["walls"]
    each = sorted(b - a for a, b in zip([0.0] + ends, ends))
    if not each:
        return "window: nothing completed"
    return (f"window: {len(each)} done, wall each min {each[0]:.4f} s, median "
            f"{each[len(each) // 2]:.4f} s, max {each[-1]:.4f} s")
