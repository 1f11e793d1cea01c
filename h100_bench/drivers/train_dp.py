"""Training cells across cards: the WeightCE step of ``drivers/train.py``,
data-parallel over the mix's ``mesh`` (data, model), one process a card.

Rank 0, the runner's process, builds the port's kernels before any other
rank starts (so no two ranks build into one directory), then starts the
others (``core/ranks.py``). Every rank joins through the port's own
``parallel`` path: ``initialize_multihost`` (NCCL), ``make_mesh``, the
global step's rows through ``shard_batch``, and ``make_train_step(...,
mesh=mesh)``. Each rank builds the same training state from the seed as
``drivers/train.py`` does (the weights bit-identical on every card) and
runs a rank's ``batch`` x ``grad_accum`` rows a step; rank r's rows of
global step k are the weightce generator's step ``n k + r`` of ``n``
ranks. The other ranks follow rank 0's calls in lockstep: the checked
steps, each window step, the traced steps, then ``free``.

The window's rate counts the audio of every rank's rows. Only rank 0 is
read for the rooflines, the spans and the breakdown; each rank's traced
segment gives its busy seconds, and ``busy_s`` and ``window_s`` are the
ranks' means. ``memory_peak`` is the fullest card's.

The check: after the checked steps, ``rank_gap`` is the worst tensor's
gap between rank 0's parameters and another rank's (data parallelism
keeps the replicas equal). Once every other rank has ended, rank 0 runs
the plain reference over the global batch, each rank's rows on its own
card with no collective (``drivers/train.py:reference_steps``), and
compares it with its own state as the one-card cell does.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from core import counts, ranks, runner, trace
from drivers import train


class Driver(train.Driver):
    def __init__(self, spec: dict, seed: int, device, world: ranks.World | None = None):
        self.own_world = world is None
        if world is None:
            if torch.device(device).type == "cuda":
                train.port()["build"].build_all()
            world = ranks.World(spec["traffic"]["mesh"], torch.device(device).type)
        world.lead("driver", spec["traffic"]["kind"], spec, seed)
        self.world, self.rank, self.cards = world, world.rank, world.size
        self.mesh = world.mesh
        self.group = self.mesh.get_group("data")
        t = time.perf_counter()
        super().__init__(spec, seed, world.device)
        if self.rank == 0:
            print(f"rank 0's driver built in {time.perf_counter() - t:.1f} s", file=sys.stderr,
                  flush=True)

    def checks_here(self) -> bool:
        return self.rank == 0

    def step_options(self) -> dict:
        return dict(mesh=self.mesh)

    def make_batch(self, k: int) -> dict:
        """Global step ``k``: every rank's rows, microbatch by microbatch,
        through the port's collator, then this rank's share by
        ``shard_batch``."""
        from whisper_context_biasing_tpu_torch.parallel import shard_batch

        parts = self.ref_parts(k)
        rows = [r for a in range(self.a) for part in parts
                for r in part[a * self.b:(a + 1) * self.b]]
        axis = 1 if self.a > 1 else 0
        mine = shard_batch(self.collated(rows), self.mesh, extra_leading_axes=axis)
        return {key: np.ascontiguousarray(v) for key, v in mine.items()}

    def ref_parts(self, k: int) -> list[list[dict]]:
        return [self.rows(self.cards * k + r) for r in range(self.cards)]

    def ref_devices(self) -> list[torch.device]:
        if self.dev.type == "cuda":
            return [torch.device("cuda", r) for r in range(self.cards)]
        return [self.dev]

    def audio_s(self) -> float:
        return self.cards * super().audio_s()

    # ------------------------------------------------------------------
    # the calls every rank runs, rank 0 leading
    # ------------------------------------------------------------------

    def one_step(self, k: int) -> float:
        self.world.lead("one_step", k)
        return super().one_step(k)

    def warm_up(self) -> None:
        t = time.perf_counter()
        self.world.lead("warm_up")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        with self.world.quiet():
            if self.rank == 0:
                super().warm_up()
            else:
                for k in range(self.tr["checked_steps"]):
                    self.one_step(k)
        self.rank_gap = self.replica_gap()
        # the values the step's all-reduce sums: every gradient that exists, and the loss
        self.reduced_values = 1 + sum(p.grad.numel() for p in self.model.parameters()
                                      if p.grad is not None)
        if self.rank == 0:
            print(f"warm-up on every rank in {time.perf_counter() - t:.1f} s", file=sys.stderr,
                  flush=True)

    @torch.no_grad()
    def replica_gap(self) -> float | None:
        """On rank 0, the worst tensor's gap between rank 0's parameters and
        any other rank's, over the larger of that tensor's norm and the
        median tensor's. Rank 0 sends each tensor to the others over the
        mesh's data group."""
        gaps, norms = [], []
        for _, p in self.named():
            mine = p.detach().contiguous()
            theirs = mine if self.rank == 0 else torch.empty_like(mine)
            dist.broadcast(theirs, src=dist.get_global_rank(self.group, 0), group=self.group)
            norms.append(theirs.norm())
            gaps.append((mine - theirs).norm())
        norms, gaps = torch.stack(norms).cpu(), torch.stack(gaps).cpu()
        mine = float((gaps / torch.maximum(norms, norms.median())).max())
        got = self.world.gather(mine)
        return max(got) if self.rank == 0 else None

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        self.stats["flops"] *= self.cards
        self.stats["cards"] = self.cards
        return out

    def memory_peak(self) -> int | None:
        """The fullest card's peak since the warm-up began."""
        self.world.lead("memory_peak")
        mine = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        got = self.world.gather(mine)
        return max(got) if self.rank == 0 else None

    def traced(self) -> dict | None:
        """Rank 0 runs ``drivers/train.py``'s traced steps; the others run
        the same steps with their own device traced, for their busy
        seconds. The bound of the all-reduce: the values it sums, in f32,
        sent once and received once at NVLink's rate a direction."""
        self.world.lead("traced")
        n = self.cell.get("trace_steps", 1)
        with self.world.quiet():
            if self.rank == 0:
                got = super().traced()
            else:
                got = trace.profile(lambda: [self.one_step(10_000 + i) for i in range(n)])
                self.one_step(10_000 + n)
        seen = self.world.gather((got["busy_s"], got["window_s"]))
        if self.rank:
            return None
        got["busy_s"] = sum(b for b, _ in seen) / len(seen)
        got["window_s"] = sum(w for _, w in seen) / len(seen)
        got["bounds"]["nccl"] = n * counts.allreduce_bound_s(self.reduced_values)
        return got

    def free(self) -> None:
        """Every rank frees its state and reports what it loaded; rank 0
        then ends the other ranks when it started them, and refuses the
        run where one loaded JAX or the JAX package."""
        self.world.lead("free")
        super().free()
        found = self.world.gather(runner.forbidden_modules())
        if self.rank:
            return
        if self.own_world:
            self.world.close()
        loaded = sorted(set().union(*found[1:]))
        if loaded:
            raise SystemExit(f"a rank loaded JAX or the JAX package: {', '.join(loaded)}")

    def compare(self, prog: dict, ref: dict) -> list[tuple[str, float]]:
        return super().compare(prog, ref) + [("rank_gap", self.rank_gap)]


def start_world(spec: dict, device) -> ranks.World:
    """A world for several drivers in turn (calibration, tests): the
    kernels built, then every rank started and joined."""
    if torch.device(device).type == "cuda":
        train.port()["build"].build_all()
    return ranks.World(spec["traffic"]["mesh"], torch.device(device).type)
