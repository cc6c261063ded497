"""Host-side data loading: stacked worker batches with background prefetch.

A transcription of ``repro/data/loader.py``.  Wraps a seekable source
(``TokenStream``-style ``batch(worker, step)``) into the (M, b, ...)
stacked int64 tensors the trainer consumes, on the trainer's device,
assembled by a prefetch thread so the host's batch assembly overlaps the
device's work.

Determinism: batches are a pure function of (worker, step), so a resumed
run replays the identical stream.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


class StackedLoader:
    def __init__(self, source, n_workers: int, start_step: int = 0, prefetch: int = 2,
                 device=None):
        self.source = source
        self.M = n_workers
        self.step = start_step
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _assemble(self, step: int) -> dict:
        per = [self.source.batch(w, step) for w in range(self.M)]
        return {
            k: torch.from_numpy(np.stack([p[k] for p in per]).astype(np.int64))
            .to(self.device)
            for k in per[0]
        }

    def _produce(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._assemble(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
