"""The benchmark of whisper_context_biasing_tpu_torch on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
and prints one JSON line last on standard output: the end-to-end metrics
(``--trace 0``) or the per-layer metrics with a breakdown of the traced
segment (``--trace 1``), the device, and last the numbers compared with
the plain reference beside their limits (also the last lines on standard
error). It needs a CUDA card, and exits non-zero without one, and when
JAX or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import atexit  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from core.runner import forbidden_modules, load_spec, run_cell

    spec = load_spec(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit as e:   # argparse's, or a refusal with its reason
        if e.code is not None and not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception:
        traceback.print_exc()
        code = 1
    atexit._run_exitfuncs()   # ends any rank still running (core/ranks.py)
    sys.stdout.flush()
    sys.stderr.flush()
    # without the interpreter's teardown: a process that held NCCL's
    # communicators or several cards' contexts need not wait on them
    os._exit(code)
