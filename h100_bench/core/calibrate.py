"""Readings that the limits of ``correct`` are set from, in one process:
the program's compared numbers over many seeds, and on a few seeds its
control (the reference one precision below the configuration's: float8,
and for serving also the port's own int8 decoder-weight path) and the
faults the check must catch. Not part of a benchmark run. A cell across
cards starts its ranks once and keeps them for every reading: each fault
is planted on every rank, and the control's reference runs over every
card as the check does.

    python3 h100_bench/core/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

prints one JSON line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from core import faults, runner  # noqa: E402
from drivers import serve, train, train_dp  # noqa: E402


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
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    spec = runner.load_spec(args.workload)
    kind = spec["traffic"]["kind"]
    fault_names = [f for f in args.faults.split(",") if f]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
