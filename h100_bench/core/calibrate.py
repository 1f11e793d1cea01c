"""Readings that the limits of ``correct`` are set from, in one process:
the program's compared numbers over many seeds, and on a few seeds its
control (the reference one precision below the configuration's: float8,
and for serving also the port's own int8 decoder-weight path) and the
faults the check must catch. Not part of a benchmark run. A cell across
cards starts its ranks once and keeps them for every reading: each fault
is planted on every rank, and the control's reference runs over every
card as the check does. A server cell builds a fresh ``Engine`` of the
seed's weights for each reading, and judges the program's window and the
float8 control on the same served requests.

    python3 h100_bench/core/calibrate.py --workload <cell> --seeds 12 --control-seeds 3
    python3 h100_bench/core/calibrate.py --workload <server cell> --sweep 40,55,70 --seconds 51

prints one JSON line a reading and writes them all to ``--out``. The
second form, for a server cell, runs one ``Engine`` through windows at
each rate in turn and reports the latency and whether the backlog grew:
the requests still in flight when the window closed, and the median
latency of its last ten seconds' arrivals over its first ten's.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from core import faults, runner  # noqa: E402
from drivers import serve, server, train, train_dp  # noqa: E402


def _emit(out, **rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def serve_readings(spec, seed, seconds, variant, fault=None, dev="cuda"):
    orig = serve.port
    if fault:
        serve.port = lambda: faults.SERVE[fault](orig())
    try:
        drv = serve.Driver(spec, seed, dev)
    finally:
        serve.port = orig
    if variant == "int8":
        from whisper_context_biasing_tpu_torch.models.whisper import quantize_decoder_weights
        drv.model = drv.pipe.model = quantize_decoder_weights(drv.model)
    drv.warm_up()
    drv.window(seconds)
    drv.free()
    return dict(drv.check(lowp="fp8" if variant == "fp8" else None)), drv.checked


def server_readings(spec, seed, seconds, variant="program", fault=None, control=False,
                    dev="cuda"):
    """One window of a server cell: the program's compared numbers (with
    ``control`` also the float8 control's on the same requests), or those
    of the int8 path or of a fault; and the run's counts and tail."""
    drv = server_driver(spec, seed, fault, dev)
    if variant == "int8":
        from whisper_context_biasing_tpu_torch.models.whisper import quantize_decoder_weights

        drv.engine.model = quantize_decoder_weights(drv.engine.model)
    drv.warm_up()
    e2e = drv.window(seconds)
    drv.free()
    out = {f"fault:{fault}" if fault else variant: dict(drv.check())}
    checked = dict(drv.checked, failed=drv.failed(), attempted=drv.attempted(), **e2e)
    if control:
        out["fp8"] = dict(drv.check(lowp="fp8"))
    return out, checked


def server_driver(spec, seed, fault=None, dev="cuda"):
    orig = server.port
    if fault:
        plant = {**faults.SERVE, **faults.ENGINE}[fault]
        server.port = lambda: plant(orig())
    try:
        return server.Driver(spec, seed, dev)
    finally:
        server.port = orig


def backlog(reqs: list[dict], end: float, seconds: float) -> dict:
    """Whether a window's queue grew: requests in flight at its close, and
    the median latency of the last ten seconds' arrivals over the first
    ten's."""
    t0 = end - seconds

    def lat(rs):
        return float(np.median([r["done"] - r["due"] for r in rs if r["ok"]] or [np.nan]))

    first = [r for r in reqs if r["due"] < t0 + 10]
    last = [r for r in reqs if r["due"] >= end - 10]
    return dict(in_flight_at_close=sum(1 for r in reqs if r.get("done", np.inf) > end
                                       and r["due"] < end),
                last_over_first=lat(last) / lat(first))


def sweep(spec, seed, rates, seconds, out, dev="cuda"):
    """One Engine through a window at each rate in turn, each window's
    queue emptied before the next."""
    drv = server_driver(spec, seed, dev=dev)
    tr = drv.tr
    tr["rate_per_s"] = rates[0]
    drv.warm_up()
    for i, rate in enumerate(rates):
        tr["rate_per_s"] = rate
        eng = drv.engine
        b0, w0 = len(eng.batches), eng.rtf.wall_s
        try:
            got = drv.window(seconds, tag=f"sweep{i}")
        except RuntimeError as e:
            _emit(out, cell=spec["name"], rate=rate, error=str(e))
            break
        reqs = drv.window_reqs
        end = reqs[0]["due"] - reqs[0]["offset"] + seconds
        lat = drv.stats["latency_ms"]
        rows = list(eng.batches[b0:])
        _emit(out, cell=spec["name"], rate=rate, seconds=seconds, attempted=len(reqs),
              failed=drv.failed(), p50_ms=float(np.percentile(lat, 50)), **got,
              p99_ms=float(np.percentile(lat, 99)), max_ms=max(lat),
              lag_p99_ms=float(np.percentile(drv.stats["lag_ms"], 99)),
              batches=len(rows), batch_fill=100.0 * sum(rows) / (len(rows) * tr["engine"]["batch"]),
              batch_ms=1e3 * (eng.rtf.wall_s - w0) / len(rows), **backlog(reqs, end, seconds))
        drv._wait(f"sweep{i}", len(reqs), time.perf_counter() + 120.0)  # the queue empties
    drv.free()


def train_readings(spec, seed, control: bool, fault_names=(), dev="cuda", world=None):
    """The program's readings on ``seed``, and with ``control`` the float8
    reference's; each fault planted (``spec["fault"]``) in a driver of its
    own. A cell across cards runs on ``world``'s ranks."""
    def driver(fault=None):
        s = dict(spec, fault=fault) if fault else spec
        if world is not None:
            return train_dp.Driver(s, seed, dev, world=world)
        return train.Driver(s, seed, dev)

    drv = driver()
    drv.warm_up()
    drv.free()
    t = time.perf_counter()
    ref = drv.reference_steps()
    ref_s = time.perf_counter() - t
    out = {"program": dict(drv.compare(drv.prog, ref))}
    if control:
        out["fp8"] = dict(drv.compare(drv.reference_steps("fp8"), ref))
    for name in fault_names:
        bad = driver(name)
        bad.warm_up()
        bad.free()
        out[name] = dict(bad.compare(bad.prog, ref))
    return out, ref_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--sweep", default="", help="a server cell's rates a second, comma-separated")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    spec = runner.load_spec(args.workload)
    kind = spec["traffic"]["kind"]
    fault_names = [f for f in args.faults.split(",") if f]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sweep:
        sweep(spec, args.first_seed, [float(r) for r in args.sweep.split(",")], args.seconds,
              args.out)
        return
    world = train_dp.start_world(spec, "cuda") if kind == "train_dp" else None
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        control = i < args.control_seeds
        t = time.perf_counter()
        if kind == "serve":
            variants = ["program"] + (["fp8", "int8"] if control else [])
            for v in variants:
                got, checked = serve_readings(spec, seed, args.seconds, v)
                _emit(args.out, cell=args.workload, seed=seed, variant=v, readings=got,
                      **checked)
            for f in fault_names if control else ():
                got, checked = serve_readings(spec, seed, args.seconds, "program", f)
                _emit(args.out, cell=args.workload, seed=seed, variant=f"fault:{f}",
                      readings=got, **checked)
        elif kind == "server":
            runs = [dict(control=control)]
            if control:
                runs += [dict(variant="int8")] + [dict(fault=f) for f in fault_names]
            for kw in runs:
                got, checked = server_readings(spec, seed, args.seconds, **kw)
                for v, r in got.items():
                    _emit(args.out, cell=args.workload, seed=seed, variant=v, readings=r,
                          **checked)
        else:
            got, ref_s = train_readings(spec, seed, control, fault_names if control else (),
                                        world=world)
            for v, r in got.items():
                _emit(args.out, cell=args.workload, seed=seed, variant=v, readings=r,
                      reference_s=ref_s)
        print(f"# seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    if world is not None:
        world.close()


if __name__ == "__main__":
    main()
