"""Deterministic, restartable token pipeline (the port's numpy copy of the
JAX package's ``data/pipeline.py``: the same batches, bit for bit).

Fault-tolerance properties (DESIGN.md §4):

  * **Deterministic addressing** — batch contents are a pure function of
    (seed, step, host_id); a restarted / re-meshed job replays the exact
    stream from its checkpointed step with no data loss or duplication.
    This is also the straggler story for the input plane: any host can
    recompute any other host's shard, so a dead data worker never blocks.
  * **Prefetch** — a bounded background thread keeps `depth` batches
    ready (host-side; device transfer happens in the training loop).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        global_batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        assert global_batch % n_hosts == 0
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # pure function of (seed, step, host): the restart/straggler guarantee
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step, self.host_id))
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks ** 1.1
        topic = step % 8
        lo = (topic * self.vocab_size) // 8
        hi = ((topic + 1) * self.vocab_size) // 8
        p[lo:hi] *= 4.0
        p /= p.sum()
        toks = rng.choice(self.vocab_size, size=(self.local_batch, self.seq_len + 1), p=p)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            b = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
