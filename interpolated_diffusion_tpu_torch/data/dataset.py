"""The batch loader feeding the train steps (own copy of `BatchLoader` from
the JAX package's data/dataset.py; numpy only). The maze datasets come with
the maze trainers."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    """Seeded random-batch iterator with optional background prefetch.

    One host thread assembles dense numpy batches ahead of the train loop,
    so that the next batch is built while the device computes.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        start_batch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.start_batch = int(start_batch)
        self.batches_drawn = self.start_batch   # checkpointable position

    @property
    def state(self):
        """JSON-able resume marker; pass back as start_batch."""
        return {"batches": self.batches_drawn}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        n = len(self.dataset)
        # fast-forward: replay only the index draws, not the batch builds.
        # Each __iter__ restarts the rng from start_batch, so the position
        # marker must restart with it (a second iter() otherwise desyncs
        # .state from the actual stream position)
        self.batches_drawn = self.start_batch
        for _ in range(self.start_batch):
            rng.randint(0, n, size=self.batch_size)

        def gen():
            while True:
                idx = rng.randint(0, n, size=self.batch_size)
                self.batches_drawn += 1
                yield self.dataset.get_batch(idx)

        if self.prefetch <= 0:
            yield from gen()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for batch in gen():
                if stop.is_set():
                    return
                q.put(batch)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
