"""What the readers of the program's own spans read: the port's tracer
(``utils/profiling.py``), which records only while a ``torch.profiler``
session is active, so only in a run's traced segment. A reading comes from
the first root span of its kind that the process recorded: the first
traced batch or step, the device-only segment that ``device_idle`` and the
rooflines read (the host-traced batch or step after it is not read). Each
returns None where the program has no tracer or recorded no such root."""

from __future__ import annotations


def tree(root: str) -> list[dict] | None:
    """The first root span named ``root`` and the spans under it, root
    first; None without one."""
    try:
        from whisper_context_biasing_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without the tracer
        return None
    got = spans()
    top = next((s for s in got if s["parent"] is None and s["name"] == root), None)
    if top is None:
        return None
    return [s for s in got if s["root"] == top["id"]]


def device_ms(root: str, name: str) -> float | None:
    """The mean device ms of the spans ``name`` under the first ``root``."""
    t = tree(root)
    ms = [s["device_ms"] for s in t or () if s["name"] == name]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)


def decode_steps() -> dict | None:
    """The first ``decode`` root's steps: their count, their host ms summed
    (``decode.step``), the host ms of the spans inside them summed by name,
    and the root's counters."""
    t = tree("decode")
    steps = {s["id"]: s for s in t or () if s["name"] == "decode.step"}
    if not steps:
        return None
    out = {"n": len(steps), "decode.step": sum(s["host_ms"] for s in steps.values()),
           "counters": t[0]["counters"]}
    for s in t:
        if s["parent"] in steps:
            out[s["name"]] = out.get(s["name"], 0.0) + s["host_ms"]
    return out


def host_ms_per_step(name: str) -> float | None:
    """The host ms of the spans ``name`` inside the first decode's steps,
    over its steps."""
    d = decode_steps()
    return d.get(name, 0.0) / d["n"] if d else None


def issue_ms_per_step() -> float | None:
    """The host ms of the first decode's steps less their syncs', over its
    steps."""
    d = decode_steps()
    return (d["decode.step"] - d.get("decode.sync", 0.0)) / d["n"] if d else None


def live_row_share() -> float | None:
    """Percent of the first decode's row-steps spent on rows still running."""
    d = decode_steps()
    rows = d and d["counters"].get("decode.rows")
    return 100.0 * d["counters"].get("decode.live_rows", 0) / (d["n"] * rows) if rows else None
