"""Bounded labeled-traffic buffer for the online trainer (PyTorch port of
``lightgbm_tpu/online/buffer.py``, a copy of it).

Two windows over the same ingest stream:

- the **training buffer**: labeled rows accumulated since the last train
  cycle. Bounded by ``capacity_rows`` with drop-oldest semantics (a stale
  gradient signal is worth less than a fresh one, and an unbounded buffer
  under sustained overload is an OOM); ``take_training()`` drains it.
- the **shadow window**: a sliding window of the most recent labeled
  rows, NOT cleared by training — the promotion gate scores candidate
  vs. current model on it, so it must always reflect live traffic.

All methods are thread-safe (ingest arrives on HTTP handler threads, the
trainer drains from its worker thread).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Tuple

import numpy as np


class TrafficBuffer:
    """Bounded (X, y) chunk accumulator with a sliding shadow window."""

    def __init__(self, capacity_rows: int = 65536,
                 shadow_rows: int = 4096) -> None:
        if capacity_rows < 1:
            raise ValueError("capacity_rows must be >= 1")
        if shadow_rows < 1:
            raise ValueError("shadow_rows must be >= 1")
        self._lock = threading.Lock()
        self._cap = int(capacity_rows)
        self._shadow_cap = int(shadow_rows)
        self._chunks: deque = deque()        # pending training chunks
        self._rows = 0
        self._shadow: deque = deque()        # recent-traffic window
        self._shadow_held = 0
        self._dropped = 0
        self._total = 0

    # ------------------------------------------------------------- ingest
    def push(self, X, y, training: bool = True) -> int:
        """Append one labeled chunk; returns the buffered row count.
        Oldest training chunks are dropped once over capacity (a single
        chunk larger than the whole buffer is kept — it is the freshest
        data there is).

        ``training=False`` feeds ONLY the shadow window: rows the gate
        must judge promotions on but the trainer must not train on (the
        JAX package's fleet replay uses it for rows it trained on
        before a restart)."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2:
            raise ValueError("rows must be 2-D (rows, features), got "
                             "ndim=%d" % X.ndim)
        y = np.ascontiguousarray(np.asarray(y, np.float64).ravel())
        if len(y) != X.shape[0]:
            raise ValueError("labels length %d != rows %d"
                             % (len(y), X.shape[0]))
        if len(y) == 0:
            with self._lock:
                return self._rows
        with self._lock:
            if training:
                self._chunks.append((X, y))
                self._rows += len(y)
                while self._rows > self._cap and len(self._chunks) > 1:
                    _, oy = self._chunks.popleft()
                    self._rows -= len(oy)
                    self._dropped += len(oy)
            self._total += len(y)
            self._shadow.append((X, y))
            self._shadow_held += len(y)
            while self._shadow_held > self._shadow_cap \
                    and len(self._shadow) > 1:
                _, oy = self._shadow.popleft()
                self._shadow_held -= len(oy)
            return self._rows

    # -------------------------------------------------------------- drain
    def take_training(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Drain the training buffer as one concatenated (X, y) pair, or
        None when empty. The shadow window is untouched."""
        with self._lock:
            if not self._chunks:
                return None
            chunks = list(self._chunks)
            self._chunks.clear()
            self._rows = 0
        if len(chunks) == 1:
            return chunks[0]
        return (np.concatenate([c[0] for c in chunks], axis=0),
                np.concatenate([c[1] for c in chunks]))

    def shadow(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Copy of the sliding recent-traffic window (X, y), or None if
        nothing was ever ingested."""
        with self._lock:
            chunks = list(self._shadow)
        if not chunks:
            return None
        if len(chunks) == 1:
            return chunks[0]
        return (np.concatenate([c[0] for c in chunks], axis=0),
                np.concatenate([c[1] for c in chunks]))

    def reset(self) -> None:
        """Forget everything (both windows, the drop/total counters)."""
        with self._lock:
            self._chunks.clear()
            self._rows = 0
            self._shadow.clear()
            self._shadow_held = 0
            self._dropped = 0
            self._total = 0

    # --------------------------------------------------------------- state
    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def shadow_capacity(self) -> int:
        """The shadow window's row bound."""
        return self._shadow_cap

    @property
    def rows(self) -> int:
        """Rows currently buffered for the next train cycle."""
        with self._lock:
            return self._rows

    @property
    def shadow_rows(self) -> int:
        with self._lock:
            return self._shadow_held

    @property
    def dropped_rows(self) -> int:
        """Rows dropped (oldest-first) to stay under capacity."""
        with self._lock:
            return self._dropped

    @property
    def total_rows(self) -> int:
        """Rows ever ingested."""
        with self._lock:
            return self._total
