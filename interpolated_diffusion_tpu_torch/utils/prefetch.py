"""Background-thread device prefetch for the train loops (own copy of the
JAX package's utils/prefetch.py).

`DevicePrefetcher` moves host batch assembly and the host-to-device copy onto
a daemon thread with a small queue of device-ready batches, overlapping the
transfer of batch N+1 with the computation of batch N. Same batches in the
same order. `pinned_put` is the put function the trainers use: it pins each
array and copies it with non_blocking=True.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

from .profiling import span

WAIT = "idt.data.wait"


class _Stop:
    pass


def pinned_put(device, keys=None) -> Callable[[Any], Any]:
    """put_fn for DevicePrefetcher: the batch's numpy arrays (those named in
    `keys`, or all of them) as tensors on `device`. For a CUDA device each is
    pinned first and copied with non_blocking=True, so that the copy overlaps
    the running step."""
    import numpy as np
    import torch

    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if (keys is not None and k not in keys) or not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    return put


class DevicePrefetcher:
    """Wraps a host batch iterator; yields device-ready batches.

    put_fn maps a host batch to device tensors (e.g. `pinned_put(device)`).
    depth bounds the number of in-flight device batches: 2 is enough to hide
    one transfer behind one step; more only adds device-memory pressure. Exceptions from the loader or put_fn re-raise at the consumer
    (sticky: every subsequent next() re-raises rather than blocking).
    close() stops the producer and drops queued device batches; it is also
    called automatically when the stream ends or errors.
    """

    def __init__(self, loader: Iterator[Any], put_fn: Callable[[Any], Any],
                 depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._loader = iter(loader)
        self._put_fn = put_fn
        self._stop = threading.Event()
        self._terminal: Any = None   # _Stop or BaseException once finished
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _enqueue(self, item: Any) -> bool:
        """Bounded put that gives up when close() is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for batch in self._loader:
                if not self._enqueue(self._put_fn(batch)):
                    return
        except BaseException as e:  # surface loader/transfer errors
            if isinstance(e, StopIteration):
                # would silently end the consumer's for-loop — make it loud
                e = RuntimeError("prefetch loader/put_fn raised StopIteration")
            self._enqueue(e)
            return
        self._enqueue(_Stop)

    def close(self) -> None:
        """Stop the producer and release queued device batches."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._terminal is not None:
            if self._terminal is _Stop:
                raise StopIteration
            raise self._terminal
        with span(WAIT):
            item = self._q.get()
        if item is _Stop:
            self._terminal = item
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self._terminal = item
            self.close()
            raise item
        return item
