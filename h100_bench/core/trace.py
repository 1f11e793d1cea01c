"""The traced segment of a run: ``torch.profiler`` over CPU and CUDA, its
Chrome trace read back for the device's busy time, the time of each
kernel, and the host's activity during each idle gap of the device.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
# the benchmark's names for the hand-written kernels, and for NCCL's (the
# exchange between cards), by a part of the kernel's symbol
KERNELS = {"k1": ("mel_fft_kernel",), "k2": ("flash_fwd_bf16_kernel",),
           "k3": ("quant_cross_kernel",),
           "k4": ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkdv_bf16_kernel"),
           "nccl": ("nccl",)}


def kernel_group(name: str) -> str | None:
    for key, parts in KERNELS.items():
        if any(p in name for p in parts):
            return key
    return None


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _name_gaps(host: list[tuple[float, float, str, object]], gaps: list[tuple[float, float]]
               ) -> dict[str, float]:
    """Each idle gap's seconds under the innermost host span running at its
    start (the latest started of each thread's innermost), or "host idle".
    A sweep over the spans in start order with a stack a thread."""
    out: dict[str, float] = collections.Counter()
    stacks: dict[object, list] = collections.defaultdict(list)
    i = 0
    for at, sec in sorted(gaps):
        while i < len(host) and host[i][0] <= at:
            a, b, name, tid = host[i]
            st = stacks[tid]
            while st and st[-1][1] < a:
                st.pop()
            st.append((a, b, name))
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < at:
                st.pop()
            if st and (best is None or st[-1][0] >= best[0]):
                best = st[-1]
        out[best[2] if best else "host idle"] += sec
    return out


def read_trace(path: str, window_s: float) -> dict:
    """Busy seconds, kernel seconds by name and by group, launches by
    group, and the idle gaps named by the host's activity."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    by_name: dict[str, float] = collections.Counter()
    groups: dict[str, float] = collections.Counter()
    launches: dict[str, int] = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((a, a + d))
            name = e.get("name", "?")
            by_name[name[:120]] += d
            key = kernel_group(name)
            if key:
                groups[key] += d
                if "dkdv" not in name:  # K4's two kernels make one launch
                    launches[key] += 1
        elif cat in HOST_CATS:
            host.append((a, a + d, e.get("name", "?"), e.get("tid")))
    busy = _union(dev)
    host.sort(key=lambda h: (h[0], -h[1]))  # an outer span before the inner ones
    gaps = _name_gaps(host, [(end, nxt - end) for (_, end), (nxt, _) in zip(busy, busy[1:])
                             if nxt > end])
    busy_s = sum(b - a for a, b in busy)
    top = lambda c: [[k, v] for k, v in sorted(c.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_s, window_s=window_s, kernel_s=dict(groups),
                kernel_launches=dict(launches),
                breakdown=dict(device_ops=top(by_name), idle_gaps=top(gaps)))


def profile(fn, host: bool = False) -> dict:
    """Runs ``fn()`` under the profiler; returns ``read_trace``'s reading
    of it. Without ``host`` only the device is traced, which leaves the
    host's pace as it is untraced; with it the host's operations are
    traced too (each costs the host some microseconds), for naming the
    idle gaps. The trace file lives in the run's temporary directory and
    is removed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    sync()
    with torch_profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_trace(path, window)
    finally:
        os.remove(path)
