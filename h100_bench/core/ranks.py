"""The ranks of a cell on several cards, one process a card.

Rank 0 is the runner's own process. ``World`` there starts ranks 1..n-1
(``python -m core.ranks``), each on its own card, and every rank joins
through the port's own ``parallel.initialize_multihost`` (NCCL on cards,
gloo on the CPU) and builds the mesh with ``parallel.make_mesh``. Rank 0
then leads: a driver method that every rank runs begins with
``World.lead(name, *args)``, which on rank 0 sends the name and the
arguments to the other ranks over a gloo group of the harness's own, and
each other rank runs the same method of its own driver in turn
(``follow``). ``gather`` brings one value a rank back to rank 0.

Failures end the run on rank 0 with a non-zero exit:

- start-up: every rank has ``TIMEOUT_S`` to join, or rank 0's
  ``initialize_multihost`` raises;
- a rank that exits before it is told to: a watchdog thread on rank 0
  ends the others and exits with code 4 within a second;
- a rank that stalls: once one of rank 0's calls has run ``TIMEOUT_S``
  (from ``lead`` to the ``gather`` that ends it), the watchdog ends every
  rank and exits with code 4; NCCL's own watchdog would end a collective
  only after torch's default of 10 minutes for the mesh's groups.

No rank outlives rank 0: each asks the kernel for SIGKILL when its parent
dies (``PR_SET_PDEATHSIG``), and rank 0 ends any still running when it
exits.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import datetime
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

HERE = pathlib.Path(__file__).resolve().parents[1]   # the benchmark's folder
ROOT = HERE.parent
TIMEOUT_S = 180          # start-up, and each of rank 0's calls
IDLE_S = 3600            # a rank waiting for rank 0's next call (rank 0 may run the check)
EXIT_WAIT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """The processes of one multi-card cell and their groups: the default
    group and the (data, model) ``mesh`` of the port, and ``ctrl``, the
    harness's gloo group for calls and replies."""

    def __init__(self, mesh: tuple[int, int], device_type: str, rank: int = 0,
                 addr: str | None = None, timeout_s: float | None = None):
        from whisper_context_biasing_tpu_torch.parallel import initialize_multihost, make_mesh

        self.size, self.rank, self.shape = mesh[0] * mesh[1], rank, tuple(mesh)
        self.device = (torch.device("cuda", rank) if device_type == "cuda"
                       else torch.device(device_type))
        self.timeout_s = TIMEOUT_S if timeout_s is None else timeout_s
        self.procs: list[subprocess.Popen] = []
        self._quiet, self._leaving, self._closing = 0, False, False
        self._since = None   # rank 0: when the call that runs began
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // self.size))
        if rank == 0:
            addr = f"localhost:{_free_port()}"
            atexit.register(self.kill)
            self.procs = [self._start(r, addr, device_type) for r in range(1, self.size)]
            print("ranks 1.. started as pids " + " ".join(str(p.pid) for p in self.procs),
                  file=sys.stderr, flush=True)
            threading.Thread(target=self._watch, daemon=True).start()
        t = time.perf_counter()
        initialize_multihost(addr, self.size, rank, device=self.device,
                             timeout=datetime.timedelta(seconds=self.timeout_s))
        self.ctrl = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=IDLE_S))
        self.mesh = make_mesh(model_parallelism=mesh[1])
        if rank == 0:
            print(f"ranks joined in {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)

    def _start(self, rank: int, addr: str, device_type: str):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(HERE), str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
        cmd = [sys.executable, "-m", "core.ranks", "--rank", str(rank), "--mesh",
               f"{self.shape[0]},{self.shape[1]}", "--addr", addr, "--device-type",
               device_type, "--timeout", str(self.timeout_s), "--parent", str(os.getpid())]
        # standard output is rank 0's result line alone: the others write to standard error
        return subprocess.Popen(cmd, env=env, cwd=ROOT, stdin=subprocess.DEVNULL, stdout=2)

    def _watch(self) -> None:
        while not self._closing:
            why = next((f"rank {r} ended with exit code {p.returncode} before it was told to"
                        for r, p in enumerate(self.procs, 1)
                        if p.poll() is not None and (p.returncode or not self._leaving)), None)
            since = self._since
            if why is None and since is not None and time.monotonic() - since > self.timeout_s:
                why = f"a call of rank 0 has waited over {self.timeout_s:g} s for the ranks"
            if why and not self._closing:
                print(f"{why}; ending the run", file=sys.stderr, flush=True)
                self.kill()
                os._exit(4)
            time.sleep(0.5)

    def kill(self) -> None:
        """Rank 0: ends every other rank that still runs, and waits for it."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def lead(self, name: str, *args) -> None:
        """On rank 0 (unless ``quiet``): every other rank runs ``name(*args)``
        of its driver next."""
        if self.rank == 0 and not self._quiet:
            self._since = time.monotonic()
            dist.broadcast_object_list([(name, args)], src=0, group=self.ctrl)

    def receive(self) -> tuple[str, tuple]:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    @contextlib.contextmanager
    def quiet(self):
        """Inside, ``lead`` sends nothing: every rank runs the same calls
        by itself."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def gather(self, value) -> list | None:
        """Every rank's ``value``, by rank, on rank 0; None elsewhere. It
        ends rank 0's call."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(value, out, dst=0, group=self.ctrl)
        self._since = None
        return out

    def close(self) -> None:
        """Rank 0: every rank leaves the groups at once (NCCL's teardown
        waits for all of a communicator's ranks), the others end, and rank
        0 waits for them; the watchdog still bounds the wait."""
        self._leaving = True
        self.lead("exit")
        dist.destroy_process_group()
        deadline = time.monotonic() + EXIT_WAIT_S
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._closing = True
        bad = [p.returncode for p in self.procs if p.returncode]
        if bad:
            raise RuntimeError(f"ranks ended with exit codes {bad}")


def _die_with_parent(parent: int) -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() != parent:      # the parent died before the request
        os._exit(5)


def follow(argv=None) -> None:
    """Ranks 1..n-1: join, then run rank 0's calls until it says ``exit``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--device-type", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    from core import runner

    mesh = tuple(int(x) for x in args.mesh.split(","))
    world = World(mesh, args.device_type, rank=args.rank, addr=args.addr,
                  timeout_s=args.timeout)
    drv = None
    while True:
        name, a = world.receive()
        if name == "exit":
            break
        if name == "driver":        # (kind, spec, seed): a new driver on this rank
            drv = None
            kind, spec, seed = a
            drv = runner.driver(kind).Driver(spec, seed, world.device, world=world)
        else:
            getattr(drv, name)(*a)
    dist.destroy_process_group()


if __name__ == "__main__":
    follow()
