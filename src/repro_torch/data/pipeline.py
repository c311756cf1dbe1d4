"""Deterministic synthetic token pipeline: the port's own copy of the
reference's ``repro.data.pipeline`` (numpy only; the same draws in the same
order, so batches are bit-identical for the same config).  Moving a batch
to the device is the trainer's job.

Production-shaped: per-host sharding (each host materializes only its slice
of the global batch), seed-split streams, background prefetch, and packing
of variable-length documents into fixed-length training sequences.  Tokens
are synthesized from a stationary n-gram-ish generator so losses decrease
measurably during the example runs (the model has structure to learn).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    mean_doc_len: int = 512
    prefetch: int = 2
    frontend_len: int = 0
    d_model: int = 0          # for frontend embedding synthesis


class _DocSource:
    """Markov-chain document generator: learnable bigram structure."""

    def __init__(self, cfg: DataConfig, stream: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, cfg.host_id, stream])
        )
        v = cfg.vocab
        # sparse row-stochastic transition structure: token t prefers a
        # small deterministic successor set
        self.n_succ = min(8, v)
        base = np.arange(v, dtype=np.int64)
        self.succ = (
            (base[:, None] * 2654435761 + np.arange(self.n_succ)[None, :] * 40503)
            % v
        ).astype(np.int32)

    def next_doc(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.cfg.mean_doc_len)))
        out = np.empty(n, np.int32)
        t = int(self.rng.integers(self.cfg.vocab))
        for i in range(n):
            out[i] = t
            if self.rng.random() < 0.1:  # 10% resets keep entropy > 0
                t = int(self.rng.integers(self.cfg.vocab))
            else:
                t = int(self.succ[t, self.rng.integers(self.n_succ)])
        return out


class TokenPipeline:
    """Packs documents into (host_batch, seq_len+1) windows; yields dicts of
    numpy arrays (tokens, labels [, extra_embeds]) ready for device put."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{cfg.n_hosts} hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        self._sources = [
            _DocSource(cfg, stream=i) for i in range(self.host_batch)
        ]
        self._buffers = [np.empty(0, np.int32) for _ in range(self.host_batch)]
        self._q: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(cfg.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _fill_row(self, i: int, need: int) -> np.ndarray:
        buf = self._buffers[i]
        while buf.size < need:
            buf = np.concatenate([buf, self._sources[i].next_doc()])
        self._buffers[i] = buf[need:]
        return buf[:need]

    def _make_batch(self) -> Dict[str, np.ndarray]:
        L = self.cfg.seq_len
        rows = np.stack([self._fill_row(i, L + 1) for i in range(self.host_batch)])
        out = {"tokens": rows[:, :L].copy(), "labels": rows[:, 1:].copy()}
        if self.cfg.frontend_len:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.cfg.seed, 7, self.cfg.host_id])
            )
            out["extra_embeds"] = rng.normal(
                0, 0.02, (self.host_batch, self.cfg.frontend_len, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
