"""Process-group initialization: the counterpart of the JAX package's
``parallel/multihost.py``.

JAX is single-controller: one process per host drives its chips and
``jax.distributed.initialize`` joins the hosts. PyTorch is SPMD: one process
per card, launched by ``torchrun`` (or anything that sets its variables), so
``initialize_multihost`` joins every card's process to the default process
group. Call it once per process before building a mesh; a single process
stays uninitialized and every entry point runs unchanged on one card.

Data loading: each rank loads the same global batch from the same seed and
keeps its own rows (``parallel.sharding.shard_batch``);
``host_local_batch_slice`` gives a rank's row range when it loads only its
own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Join this process to the default process group. Returns True when a
    group of more than one process is active, False for a single process.

    The address, process count and index come from the arguments, then
    ``WCB_COORDINATOR`` / ``WCB_NUM_PROCESSES`` / ``WCB_PROCESS_ID`` (the JAX
    package's variables), then torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
    ``RANK`` (its store, ``env://``). An address without a scheme is a TCP
    rendezvous (``host:port``). The backend follows ``device``: NCCL for a
    card, gloo for the CPU. A default group the caller has already
    initialized is used as it is."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get("WCB_COORDINATOR")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = "env://"  # launched by torchrun
    if num_processes is None:
        num_processes = int(env.get("WCB_NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("WCB_PROCESS_ID") or env.get("RANK") or 0)
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(f"{num_processes} processes need a coordinator address "
                             "(WCB_COORDINATOR or MASTER_ADDR)")
        return False
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    device = torch.device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(device if device.index is not None else local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, stop) rows of the global batch this process should load."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    i = process_index()
    return i * per, (i + 1) * per
