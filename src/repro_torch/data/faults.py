"""Scan-plane fault taxonomy, retry policy and deterministic fault injection
(counterpart of ``repro.data.faults``).

OLA-RAW queries raw files in place, so the scan plane sits on storage that
returns transient errors, truncated reads and corrupt bytes.  This module
gives every layer one typed vocabulary for those failures and the two tools
the rest of the stack builds on:

* :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter and a per-chunk read deadline, wrapped around every read of the
  :class:`~repro_torch.data.pipeline.SlabPrefetcher` (the background reader
  thread included).  A read that keeps failing becomes a
  :class:`ChunkLostError` carrying the chunk id, which the engine's
  residency layer turns into a quarantine instead of a stall.
* :class:`FaultInjector` — a :class:`~repro_torch.data.chunkstore.ChunkStore`
  wrapper that injects failures deterministically from a seed: per-chunk
  transient-fail-k-times (the retry path recovers bit-exactly), permanent
  loss (the quarantine path), bit-flip corruption (caught by the store's
  CRC via ``verify_chunk``) and latency spikes.

A retried transient fault leaves the estimate bit-exact and
``degraded=False``; an exhausted retry or a checksum mismatch quarantines
the chunk, shrinking the sampled population (the bi-level estimator's chunk
count and tuple total drop, CIs widen) and flagging every later answer
``degraded=True``.  Plain numpy and the standard library: the same seed
gives the same faults as the reference's injector.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np


class FaultError(Exception):
    """Base class for scan-plane faults; carries the offending chunk id."""

    def __init__(self, msg: str, chunk_id: Optional[int] = None):
        super().__init__(msg)
        self.chunk_id = chunk_id


class TransientReadError(FaultError):
    """A read failed but retrying may succeed (EIO, flaky NFS, ...)."""


class CorruptChunkError(FaultError):
    """Chunk bytes fail their manifest CRC32 — content cannot be trusted."""


class ChunkLostError(FaultError):
    """The chunk is gone for good: retries exhausted, deadline passed, or
    persistent corruption.  The residency layer quarantines it."""


def _unit_hash(*parts) -> float:
    """Deterministic hash of arbitrary parts -> [0, 1).  CRC32-based so it
    is stable across processes and python versions (unlike ``hash``)."""
    h = 0
    for p in parts:
        h = zlib.crc32(repr(p).encode(), h)
    return (h & 0xFFFFFFFF) / 2.0**32


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter and a
    per-chunk wall-clock deadline.

    ``call(fn, chunk_id)`` retries ``fn`` on :class:`TransientReadError`,
    :class:`CorruptChunkError` (a re-read may heal a transient bad read),
    and ``OSError``; any other exception — notably :class:`ChunkLostError`
    from a store that knows the chunk is gone — propagates immediately.
    When attempts or the deadline exhaust, raises :class:`ChunkLostError`
    chained to the last failure.  ``sleep`` is injectable for tests.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.1
    jitter: float = 0.5
    deadline_s: float = 5.0
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def delay_s(self, chunk_id: int, attempt: int) -> float:
        backoff = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        u = _unit_hash(self.seed, int(chunk_id), int(attempt))
        return backoff * (1.0 - self.jitter * u)

    def call(self, fn: Callable[[], "np.ndarray"], chunk_id: int):
        """-> (result, retries) — ``retries`` counts failed attempts."""
        t0 = time.monotonic()
        retries = 0
        last: Optional[BaseException] = None
        for attempt in range(max(int(self.max_attempts), 1)):
            try:
                return fn(), retries
            except (TransientReadError, CorruptChunkError, OSError) as e:
                last = e
                retries += 1
                if attempt + 1 >= self.max_attempts:
                    break
                d = self.delay_s(chunk_id, attempt)
                if time.monotonic() - t0 + d > self.deadline_s:
                    break
                self.sleep(d)
        err = ChunkLostError(
            f"chunk {chunk_id}: read failed after {retries} attempt(s) "
            f"({type(last).__name__}: {last})", chunk_id=int(chunk_id),
        )
        err.retries = retries
        raise err from last


@dataclasses.dataclass
class FaultConfig:
    """Which chunks fail, and how.  All decisions are pure functions of
    ``(seed, mode, chunk_id)`` so a given config is bit-reproducible."""

    seed: int = 0
    # transient: affected chunks fail their first ``transient_fails`` reads
    # with TransientReadError, then heal (the retry path recovers them)
    transient_rate: float = 0.0
    transient_fails: int = 2
    # permanent loss: ChunkLostError on every read
    loss_rate: float = 0.0
    lost_chunks: tuple = ()
    # bit-flip corruption of the returned bytes (caught by CRC downstream);
    # ``corrupt_once`` corrupts only the first read (heals under retry)
    corrupt_rate: float = 0.0
    corrupt_chunks: tuple = ()
    corrupt_once: bool = False
    # latency spike on the first read of affected chunks
    latency_rate: float = 0.0
    latency_s: float = 0.0


class FaultInjector:
    """Deterministic fault-injecting :class:`ChunkStore` wrapper.

    Delegates everything to the wrapped store (``__getattr__``), overriding
    only :meth:`chunk_bytes`.  With an all-zero :class:`FaultConfig` the
    wrapper is a transparent pass-through, bit-exact against the plain
    store.
    """

    def __init__(self, store, config: Optional[FaultConfig] = None, **kw):
        self._store = store
        self.config = config if config is not None else FaultConfig(**kw)
        self._flock = threading.Lock()
        self._attempts: dict[int, int] = {}
        self.injected = {"transient": 0, "lost": 0, "corrupt": 0,
                         "latency": 0}

    def __getattr__(self, name):
        return getattr(self._store, name)

    # ------------------------------------------------------ fault rolls ----
    def chunk_is_lost(self, j: int) -> bool:
        cfg = self.config
        return (j in cfg.lost_chunks
                or _unit_hash(cfg.seed, "lost", j) < cfg.loss_rate)

    def chunk_is_transient(self, j: int) -> bool:
        cfg = self.config
        return _unit_hash(cfg.seed, "transient", j) < cfg.transient_rate

    def chunk_is_corrupt(self, j: int) -> bool:
        cfg = self.config
        return (j in cfg.corrupt_chunks
                or _unit_hash(cfg.seed, "corrupt", j) < cfg.corrupt_rate)

    def chunk_has_latency(self, j: int) -> bool:
        cfg = self.config
        return _unit_hash(cfg.seed, "latency", j) < cfg.latency_rate

    # ------------------------------------------------------------ READ ----
    def chunk_bytes(self, j: int) -> np.ndarray:
        j = int(j)
        cfg = self.config
        if self.chunk_is_lost(j):
            with self._flock:
                self.injected["lost"] += 1
            raise ChunkLostError(f"chunk {j}: injected permanent loss",
                                 chunk_id=j)
        with self._flock:
            attempt = self._attempts.get(j, 0)
            self._attempts[j] = attempt + 1
        if attempt == 0 and cfg.latency_s > 0 and self.chunk_has_latency(j):
            with self._flock:
                self.injected["latency"] += 1
            time.sleep(cfg.latency_s)
        if attempt < cfg.transient_fails and self.chunk_is_transient(j):
            with self._flock:
                self.injected["transient"] += 1
            raise TransientReadError(
                f"chunk {j}: injected transient failure "
                f"(attempt {attempt + 1}/{cfg.transient_fails})", chunk_id=j)
        raw = self._store.chunk_bytes(j)
        if self.chunk_is_corrupt(j) and not (cfg.corrupt_once
                                             and attempt > 0):
            raw = np.array(raw, copy=True)
            flat = raw.reshape(-1)
            pos = int(_unit_hash(cfg.seed, "pos", j) * flat.size) % flat.size
            bit = int(_unit_hash(cfg.seed, "bit", j) * 8) % 8
            flat[pos] ^= np.uint8(1 << bit)
            with self._flock:
                self.injected["corrupt"] += 1
        return raw
