"""Deterministic, resumable, host-sharded synthetic data pipeline (port of
`repro.data.pipeline`, numpy only; batches are bitwise the reference's).

Batches come from a counter-based RNG keyed by (seed, step, host_index):
a restart at step k reproduces batch k exactly (a checkpoint stores only
the step), a host materializes only its slice of the global batch, and a
recovery needs no data rewind.  `iterator` prefetches in a background
thread so host data work overlaps the device's.  Batches are numpy
arrays; the trainer moves them onto its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2


class Pipeline:
    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.model_cfg = model_cfg
        self.shape = shape
        self.cfg = data_cfg
        if shape.global_batch % data_cfg.host_count:
            raise ValueError("global batch not divisible by host count")
        self.local_batch = shape.global_batch // data_cfg.host_count

    def batch_at(self, step: int) -> dict:
        """This host's slice of global batch `step`: {"tokens", "labels"},
        [local_batch, seq_len] int32, a zipfian token stream."""
        m, s = self.model_cfg, self.shape
        if m.frontend is not None:
            raise NotImplementedError(
                f"{m.name}: stub frontends (vlm / encoder) are not ported yet")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_index]))
        B, S = self.local_batch, s.seq_len
        z = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(z - 1, m.vocab_size - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        """Batches start_step, start_step + 1, ... made ahead by a
        background thread (at most `prefetch` waiting); the thread stops
        when the generator is closed."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=5.0)
