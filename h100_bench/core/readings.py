"""What the per-layer readers (``metrics/<name>.py``) read from a run:
its window's statistics and, in a traced run, the traced segment. Each
returns None where the run holds nothing to read."""

from __future__ import annotations

from .counts import PEAK_BF16_FLOPS


def mean(run: dict, key: str) -> float | None:
    v = run["stats"].get(key)
    return sum(v) / len(v) if v else None


def roofline(run: dict, key: str) -> float | None:
    """Percent of kernel ``key``'s device time that its launches' bound
    takes: the sum of the bounds over the sum of the device times. Nothing
    where the segment has no such launch, or where the kernels the trace
    shows are not the launches the shapes were counted for."""
    tr = run.get("trace")
    if not tr or not tr["kernel_s"].get(key) or key not in tr["bounds"]:
        return None
    seen, want = tr["kernel_launches"].get(key, 0), tr["expected_launches"][key]
    if seen != want or tr["counted_launches"][key] != want:
        return None
    return 100.0 * tr["bounds"][key] / tr["kernel_s"][key]


def idle(run: dict) -> float | None:
    """Percent of the traced segment's wall in which no operation ran on
    the device."""
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(run: dict) -> float | None:
    """Percent of the bf16 peak a card: the window's matmul FLOPs over its
    wall times the cards that did them."""
    flops = run["stats"].get("flops")
    if not flops:
        return None
    return 100.0 * flops / (run["wall"] * run["stats"].get("cards", 1) * PEAK_BF16_FLOPS)


def allreduce(run: dict) -> tuple[float, float, int] | None:
    """(Σ bound, Σ device seconds) of the NCCL kernels in a traced segment,
    and its steps; nothing where the segment ran none."""
    tr = run.get("trace")
    if not tr or not tr["kernel_s"].get("nccl") or "nccl" not in tr["bounds"]:
        return None
    return tr["bounds"]["nccl"], tr["kernel_s"]["nccl"], tr["steps"]


def ratio(run: dict, num: str, den: str) -> float | None:
    n, d = run["stats"].get(num), run["stats"].get(den)
    return sum(n) / sum(d) if n and d and sum(d) else None
