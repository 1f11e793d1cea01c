"""Host-side input pipeline: threaded batch preparation + double-buffered
device prefetch.

The counterpart of the JAX package's ``data/prefetch.py``. Batch
*preparation* (audio decode + mel + prompt assembly + collation) runs in a
thread pool (``BatchLoader``, a copy, with the same seeded shuffle and
``resume``), and finished batches are copied to the card ahead of
consumption (``prefetch_to_device``): each array is staged in pinned host
memory and copied with ``non_blocking=True`` on a side CUDA stream, and the
consumer's stream waits on that copy's event before it uses the batch, so
the step never waits on a host-to-device copy.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from .._device import resolve_device


def batched_indices(
    n: int, batch_size: int, *, shuffle: bool = False, seed: int = 0,
    drop_last: bool = False,
) -> Iterator[np.ndarray]:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, n, batch_size):
        chunk = idx[i : i + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        yield chunk


class BatchLoader:
    """Iterable over collated batches with parallel item preparation.

    ``dataset[i]`` calls (audio decode + feature extraction + tokenization)
    run on ``num_workers`` threads; collation happens as soon as a batch's
    items are ready, preserving batch order.
    """

    def __init__(
        self,
        dataset,
        collator: Callable[[Sequence[dict]], dict],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self._epoch = 0  # advanced per __iter__ so shuffles differ per epoch
        self.skip_first = 0  # resume: drop N leading chunks (ONE iteration)

    def resume(self, epoch: int, skip_batches: int) -> None:
        """Public resume API: continue the deterministic data order from a
        checkpoint. The next iteration uses ``epoch``'s shuffle permutation
        (per-epoch RNG is keyed on (seed, epoch)) and drops its first
        ``skip_batches`` index chunks BEFORE item preparation — skipping the
        already-trained batches of a partial epoch without decoding their
        audio."""
        self._epoch = epoch
        self.skip_first = skip_batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        if hasattr(self.dataset, "epoch_hint"):
            # per-epoch RNG keying for datasets with item-level randomness
            # (PromptWhisperDataset 5% perturbation / bias fills)
            self.dataset.epoch_hint = self._epoch
        chunks = list(
            batched_indices(
                len(self.dataset), self.batch_size,
                shuffle=self.shuffle, seed=self.seed + self._epoch,
                drop_last=self.drop_last,
            )
        )
        if self.skip_first:
            # resume fast-forward: the permutation is deterministic from
            # (seed, epoch), so dropping chunks here skips exactly the
            # already-trained batches without preparing them
            chunks = chunks[self.skip_first:]
            self.skip_first = 0
        self._epoch += 1
        with ThreadPoolExecutor(self.num_workers) as pool:
            # submit item fetches for a sliding window of batches
            window = collections.deque()
            ahead = 2  # batches prepared ahead of consumption

            def submit(chunk):
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in chunk]

            it = iter(chunks)
            for chunk in it:
                window.append(submit(chunk))
                if len(window) > ahead:
                    break
            for futs in iter_and_extend(window, it, submit):
                yield self.collator([f.result() for f in futs])


def iter_and_extend(window, source, submit):
    """Drain ``window`` while topping it up from ``source``."""
    while window:
        yield window.popleft()
        for chunk in source:
            window.append(submit(chunk))
            break


def prefetch_to_device(batches: Iterable[dict], size: int = 2,
                       device="cuda") -> Iterator[dict]:
    """Copy batches to ``device`` ``size`` batches ahead of the consumer
    (double buffering). Every numpy array or tensor of a batch is pinned
    and copied on a side stream by a producer thread; the batch is yielded
    once the consumer's current stream has been made to wait on the copy.
    On the CPU (only when the caller asks for it) the batches pass through
    unchanged."""
    device = resolve_device(device)
    if device.type != "cuda":
        yield from batches
        return
    side = torch.cuda.Stream(device)

    def put(batch: dict):
        with torch.cuda.stream(side):
            out = {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
                   if isinstance(v, (np.ndarray, torch.Tensor)) else v
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []

    def producer():
        try:
            for b in batches:
                q.put(put(b))
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        batch, ready = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                # allocated on the side stream, used and freed on the consumer's
                v.record_stream(consumer)
        yield batch
