"""Scalar metric logging: JSONL always, TensorBoard when available (port of
utils/logging.py).

The primary sink is scalars.jsonl in the log directory (one
{"tag", "value", "step", "time"} object a line; greppable, no dependencies);
TensorBoard event files are written beside it when
`torch.utils.tensorboard` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricWriter:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._f = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is not None:
            self._f.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}
            ) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


def create_writer(log_dir: Optional[str]) -> MetricWriter:
    return MetricWriter(log_dir)
