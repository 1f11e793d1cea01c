"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, no ninja, a few seconds per source. All sources build in
parallel at the first use of any kernel, into ``.torch_ext_build/<hash>/``
at the root of the checkout (git-ignored), keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads.

The launch counters live here too: each kernel wrapper adds one to its
kernel's count where it launches, so a run can show which kernels the main
path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
KERNELS = ("mel", "flash_attention", "flash_attention_bwd", "quant_cross_attention",
           "fused_ln_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel name, counted by the wrappers
launches: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``; exact when several threads launch (a
    loader's workers running the mel kernel, the autograd engine's)."""
    with _count_lock:
        launches[name] += 1


def count_launches(counts: dict[str, int]) -> None:
    """Adds ``counts`` (launches by kernel name) at once: the launches a
    replayed CUDA graph holds, or, negative, what the wrappers counted while
    a capture recorded them without launching."""
    with _count_lock:
        launches.update(counts)


def reset_launch_counts() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> pathlib.Path:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all at once. Raises with the compiler's output on failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in KERNELS:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use),
    with ``signatures`` (launcher name -> argtypes) declared; every launcher
    returns a CUDA error code."""
    with _lock:
        if name not in _libs:
            out = build_all()
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            lib.wcb_error_string.argtypes = [ctypes.c_int]
            lib.wcb_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch)."""
    if err != 0:
        msg = lib.wcb_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def kernel_info_row(lib: ctypes.CDLL, info_fn, args: tuple, kernel: str, dtype) -> dict:
    """One kernel's registers per thread, shared memory per block (static +
    dynamic), local memory per thread (stack and spills), resident blocks
    per SM and threads per block on the current CUDA device, as the runtime
    reports them: ``info_fn(*args, int out[5])`` of the built library."""
    out = (ctypes.c_int * 5)()
    check(lib, info_fn(*args, out), f"{kernel} info")
    return dict(kernel=kernel, dtype=str(dtype).removeprefix("torch."), registers=out[0],
                smem_bytes=out[1], local_bytes=out[2], blocks_per_sm=out[3], threads=out[4])


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
