"""Background-thread batch prefetcher — a copy of
`shallow_wavenet_tpu/data/prefetch.py`.

Overlaps host-side batch assembly and the host-to-device copy with the
device's train step. Checkpoint-exact resume: each queued batch carries the
sampler state snapshot taken after drawing it, so `state()` always describes
exactly the batches the training loop has consumed — not the ones sitting in
the queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

from shallow_wavenet_tpu_torch.utils.observability import span


class GroupSampler:
    """Wraps a batch sampler to yield K-stacked groups (leaf shape
    (K, B, ...)) for the trainer's multi-step dispatch. `state()` reflects
    the underlying sampler after the last FULL group drawn, so
    checkpoint-resume replays group-aligned — the trainer checkpoints only
    at group boundaries."""

    def __init__(self, sampler, k: int, total: int | None = None):
        self._sampler = sampler
        self._k = int(k)
        # draw no batch past `total`: the final group is tail-sized
        # (total % k) instead of a full group sliced by the consumer, so
        # state() stays exact for the checkpoint saved after the tail
        self._remaining = None if total is None else int(total)

    def __iter__(self):
        return self

    def __next__(self):
        import numpy as np

        k = self._k
        if self._remaining is not None:
            k = min(k, self._remaining)
            if k <= 0:
                raise StopIteration
            self._remaining -= k
        batches = [next(self._sampler) for _ in range(k)]
        return {key: np.stack([b[key] for b in batches])
                for key in batches[0]}

    def state(self):
        return (self._sampler.state()
                if hasattr(self._sampler, "state") else None)


class Prefetcher:
    def __init__(self, sampler: Iterator[dict], put_fn: Callable | None = None,
                 depth: int = 2):
        self._sampler = sampler
        self._put = put_fn or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._consumed_state = (sampler.state()
                                if hasattr(sampler, "state") else None)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = next(self._sampler)
                state = (self._sampler.state()
                         if hasattr(self._sampler, "state") else None)
                with span("swt.data.put"):
                    item = (self._put(batch), state)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface on the consumer side
            self._err = e

    def __iter__(self):
        return self

    def __next__(self):
        with span("swt.data.next"):
            while True:
                try:
                    batch, state = self._q.get(timeout=0.2)
                    self._consumed_state = state
                    return batch
                except queue.Empty:
                    # only surface worker errors once the good batches are
                    # drained
                    if self._err is not None:
                        raise self._err
                    continue

    def state(self):
        """Sampler state as of the last batch the consumer actually took."""
        return self._consumed_state

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
