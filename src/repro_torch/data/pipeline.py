"""Streaming slab pipeline: bounded-memory chunk delivery from the store to
the engine's device (counterpart of ``repro.data.pipeline``).

Instead of holding the whole store on the device as one padded
``(N, M_max, rec)`` tensor (``EngineConfig.residency="packed"``), each round
receives a bounded ``(W, rows_max, rec)`` uint8 *slab* holding exactly the
chunks the round's workers extract from (``residency="stream"``):

1. the host predicts the round's CLAIM outcome with
   :meth:`~repro_torch.core.engine.EngineProgram.plan_claims` — a pure
   function of ``(cur, head, schedule)``, so the round's own CLAIM lands on
   the same chunks;
2. :meth:`SlabPrefetcher.assemble` builds the slab in a two-deep host ring
   (disk-backed chunks are read on the fly, straight into the ring when the
   store allows, and evicted from the store) and copies it to the engine's
   device;
3. the engine hints the next schedule positions via :meth:`prefetch`; a
   background reader thread pulls those chunks from disk while the device
   runs the current round.

The copy to the device is a plain synchronous ``Tensor.to(device)`` from
the ring buffer (pageable memory): it returns once the bytes are on the
device, so the host never refills a ring slot the card is still reading.

With ``decoded_cache_bytes > 0`` a :class:`DecodedChunkCache` keeps each
chunk's decoded ``(rows, C)`` float32 block after its first extraction
(host memory, within the budget), and later rounds feed the decoded-input
kernel instead of parsing again.  An ASCII chunk is decoded by
:func:`repro_torch.kernels.ops.extract_parse` on the engine's device — on
the card, the same parse the raw round kernels run, so a chunk's decoded
rounds see exactly the floats its raw rounds see.

Memory bounds: device residency is the round's slab (plus, transiently, the
previous round's); host residency is the ring, the LRU chunk cache
(``max_cached_chunks``, default ``2·W + lookahead`` chunks) and the decoded
cache's budget.
"""

from __future__ import annotations

import math
import queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.data.faults import RetryPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs.trace import NULL_TRACER


def device_resident_bytes(device) -> int:
    """Bytes of tensors the caching allocator holds live on a CUDA
    ``device`` (``torch.cuda.memory_allocated``): the raw slabs, decoded
    slabs, packed views and engine state together."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_resident_bytes reads a CUDA device's "
                         f"allocator, not {device}")
    return int(torch.cuda.memory_allocated(device))


def peak_host_rss_bytes() -> int:
    """Peak resident-set size of this process (Linux/macOS)."""
    import resource
    import sys

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux, bytes on macOS
    return int(ru) if sys.platform == "darwin" else int(ru) * 1024


class DecodedChunkCache:
    """Budgeted parse-once cache of decoded ``(rows, C)`` float32 blocks.

    The first time a chunk is extracted its decoded block is retained here
    (up to ``budget_bytes``); later rounds feed the decoded-input slot-eval
    kernel and skip tokenize/parse entirely.  Eviction is **cost-aware**:
    victims minimize ``extract_cost_per_tuple × touch-frequency / recency
    age``, so an ASCII chunk (≈3360 ns/tuple to re-extract) is worth ~25×
    more residency than a binary one (≈32 ns/tuple) at equal touch history.

    The cache pins the store's ``content_version``: :meth:`check_version`
    clears everything on a bump, so out-of-band re-ingests can never serve
    stale decodes.
    """

    def __init__(self, budget_bytes: int, cost_per_tuple: float = 1.0):
        self.budget_bytes = int(budget_bytes)
        self.cost_per_tuple = float(cost_per_tuple)
        self._blocks: dict[int, np.ndarray] = {}
        self._cost: dict[int, float] = {}
        self._hits: dict[int, int] = {}
        self._last: dict[int, int] = {}
        self._clock = 0
        self._version: Optional[int] = None
        self.bytes_cached = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, j: int) -> bool:
        return j in self._blocks

    @property
    def tuples_cached(self) -> int:
        return sum(b.shape[0] for b in self._blocks.values())

    def check_version(self, version: int) -> None:
        """Pin/verify the store content version; clear on mismatch."""
        if self._version is None:
            self._version = version
        elif version != self._version:
            self.clear()
            self._version = version

    def get(self, j: int) -> Optional[np.ndarray]:
        blk = self._blocks.get(j)
        if blk is not None:
            self._clock += 1
            self._hits[j] += 1
            self._last[j] = self._clock
        return blk

    def _score(self, j: int) -> float:
        age = self._clock - self._last[j] + 1
        return self._cost[j] * self._hits[j] / age

    def put(self, j: int, block: np.ndarray,
            cost_per_tuple: Optional[float] = None) -> bool:
        """Admit a decoded block, evicting lowest-score victims to fit."""
        nb = int(block.nbytes)
        if j in self._blocks or nb > self.budget_bytes:
            return False
        self._clock += 1
        while self.bytes_cached + nb > self.budget_bytes and self._blocks:
            victim = min(self._blocks, key=self._score)
            self.drop(victim)
            self.evictions += 1
        self._blocks[j] = block
        self._cost[j] = (self.cost_per_tuple if cost_per_tuple is None
                         else float(cost_per_tuple))
        self._hits[j] = 1
        self._last[j] = self._clock
        self.bytes_cached += nb
        return True

    def drop(self, j: int) -> bool:
        """Remove one chunk (quarantine / invalidation hook)."""
        blk = self._blocks.pop(j, None)
        if blk is None:
            return False
        self.bytes_cached -= int(blk.nbytes)
        self._cost.pop(j, None)
        self._hits.pop(j, None)
        self._last.pop(j, None)
        return True

    def clear(self) -> None:
        self._blocks.clear()
        self._cost.clear()
        self._hits.clear()
        self._last.clear()
        self.bytes_cached = 0


class SlabPrefetcher:
    """Assembles bounded per-round slabs from a :class:`ChunkStore`.

    One instance serves one engine: ``num_workers`` fixes the slab's leading
    dim, ``row_multiple`` pads ``rows_max`` up to a multiple of the
    engine's ``slab_row_tile`` so slab shapes stay stable, and ``device``
    is the engine's device, where every slab is copied (CUDA unless the
    caller names another).

    With ``decoded_cache_bytes > 0`` the prefetcher additionally maintains a
    :class:`DecodedChunkCache` and :meth:`assemble` returns a *mixed
    raw/decoded* slab triple ``(raw (W,R,rec) u8, dec (W,R,C) f32,
    is_decoded (W,) bool)``: cached workers get their decoded rows (no disk
    read, no parse), the rest get raw bytes as before.

    Counter lifecycle (``COUNTER_FIELDS``): the monitoring counters are
    cumulative over the prefetcher's *lifetime* — they survive ``close()``
    and reader-thread exit, and are zeroed only by an explicit
    :meth:`reset_counters` call.  :meth:`bind_metrics` exposes them on a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` as pull gauges (values
    read at snapshot time, zero hot-path writes).
    """

    #: Monotone counter attributes — the single source of truth for the
    #: counter block's lifecycle contract (see class docstring).
    COUNTER_FIELDS = (
        "chunk_reads", "cache_hits", "bytes_read", "slabs_built",
        "decoded_hits", "decoded_misses", "decoded_fills",
        "extract_tuples_avoided", "read_retries", "read_failures",
    )

    def __init__(self, store, num_workers: int, row_multiple: int = 1,
                 lookahead: int = 8, max_cached_chunks: Optional[int] = None,
                 device=None,
                 adaptive: bool = False,
                 max_lookahead: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 decoded_cache_bytes: int = 0):
        self.store = store
        self.retry = retry if retry is not None else RetryPolicy()
        self.num_workers = int(num_workers)
        rb = int(store.codec.record_bytes)
        rows = int(store.max_chunk_tuples)
        rm = max(int(row_multiple), 1)
        self.rows_max = int(math.ceil(rows / rm) * rm)
        self.slab_shape = (self.num_workers, self.rows_max, rb)
        self.slab_bytes = int(np.prod(self.slab_shape))
        self.lookahead = int(lookahead)
        # adaptive lookahead (measured READ/CPU ratio): ``lookahead`` floats
        # between the configured base and ``max_lookahead`` based on how
        # many rounds one chunk READ spans — a slow disk raises it so the
        # reader thread stays ahead of the scan, a fast one keeps the host
        # cache small.  The cache capacity is provisioned for the ceiling.
        self.adaptive = bool(adaptive)
        self.base_lookahead = self.lookahead
        self.max_lookahead = int(max_lookahead
                                 or max(4 * self.lookahead,
                                        2 * self.num_workers))
        cap_lookahead = self.max_lookahead if self.adaptive else self.lookahead
        self.capacity = int(max_cached_chunks
                            or (2 * self.num_workers + cap_lookahead))
        # READ/CPU rate probes (wall clock): cumulative seconds spent in
        # chunk reads, and an EMA of the inter-assemble gap (≈ one round's
        # compute+step time) and of the chunks consumed per round
        self.read_seconds = 0.0
        self._round_s: Optional[float] = None
        self._claims_per_round = 1.0
        self._last_assemble_t: Optional[float] = None
        self.device = resolve_device(device)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict[int, threading.Event] = {}
        self._hints: "queue.SimpleQueue[Optional[int]]" = queue.SimpleQueue()
        self._closed = False
        # ring of pre-allocated slab buffers (zero-copy assembly): disk
        # bytes readinto() the target slab slice directly.  The copy to the
        # device is synchronous, so a slot is free again once assemble()
        # returns; the second slot keeps the previous round's host slab
        # intact while the next one is built
        self._ring = [np.zeros(self.slab_shape, np.uint8) for _ in range(2)]
        self._ring_i = 0
        # the zero-copy readinto path must honor store *wrappers* (fault
        # injection, pacing proxies) that intercept chunk_bytes via
        # __getattr__ delegation — so it is taken only when the store's own
        # class implements read_chunk_into
        self._direct_readinto = any(
            "read_chunk_into" in k.__dict__ for k in type(store).__mro__)
        # parse-once decoded-chunk cache (budget 0 = off, the parity default)
        self._num_cols = int(store.codec.num_cols)
        if int(decoded_cache_bytes) > 0:
            self.decoded: Optional[DecodedChunkCache] = DecodedChunkCache(
                int(decoded_cache_bytes),
                cost_per_tuple=float(store.codec.extract_cost_per_tuple()))
            self._dec_ring = [
                np.zeros((self.num_workers, self.rows_max, self._num_cols),
                         np.float32) for _ in range(2)]
        else:
            self.decoded = None
            self._dec_ring = None
        self._empty_slab_dev = None  # lazy (W, 0, rec) raw leaf, all-dec rounds
        self._is_ascii = getattr(store.codec, "name", "") == "ascii"
        self._last_assembled: dict[int, int] = {}
        # span tracer (host-side; NULL_TRACER = one method call when off)
        self.tracer = NULL_TRACER
        # counters (monitoring / tests) — cumulative for the prefetcher's
        # lifetime; see COUNTER_FIELDS for the lifecycle contract.  The
        # fault slice covers retried reads, reads that exhausted their
        # retries, and the per-chunk error slot the reader thread stashes
        # into (re-raised — after one more synchronous retried attempt —
        # at assemble() time instead of being silently swallowed)
        for _f in self.COUNTER_FIELDS:
            setattr(self, _f, 0)
        self.read_errors: dict[int, Exception] = {}
        # the reader holds only a weakref: an engine dropped without close()
        # lets the prefetcher be GC'd, upon which the thread exits on its
        # next poll instead of pinning the cache for the process lifetime
        self._reader = threading.Thread(target=_reader_main,
                                        args=(weakref.ref(self), self._hints),
                                        daemon=True, name="slab-prefetcher")
        self._reader.start()

    # ------------------------------------------------------------- reads ----
    def _read_chunk(self, j: int) -> np.ndarray:
        """READ one chunk; hits the host cache, else disk (+ store eviction
        so a disk-backed store never accumulates resident raw chunks)."""
        while True:
            with self._lock:
                raw = self._cache.get(j)
                if raw is not None:
                    self._cache.move_to_end(j)
                    self.cache_hits += 1
                    return raw
                ev = self._inflight.get(j)
                if ev is None:
                    ev = self._inflight[j] = threading.Event()
                    mine = True
                else:
                    mine = False
            if not mine:
                ev.wait()
                continue  # re-check the cache (entry may have been trimmed)
            try:
                t0 = time.perf_counter()

                def _verified_read():
                    raw = self.store.chunk_bytes(j)
                    # end-to-end integrity: verify against the manifest CRC
                    # even when the bytes came through a wrapper (the store
                    # itself only checks its own disk boundary)
                    verify = getattr(self.store, "verify_chunk", None)
                    if verify is not None:
                        verify(j, raw)
                    return raw

                with self.tracer.span("READ", chunk=j):
                    raw, retries = self.retry.call(_verified_read, j)
                self.store.evict(j)  # host residency stays O(slab)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.chunk_reads += 1
                    self.read_retries += retries
                    self.read_errors.pop(j, None)
                    self.bytes_read += raw.nbytes
                    self.read_seconds += dt
                    self._cache[j] = raw
                    self._cache.move_to_end(j)
                    while len(self._cache) > self.capacity:
                        self._cache.popitem(last=False)
                return raw
            except Exception as e:
                with self._lock:
                    self.read_retries += int(getattr(e, "retries", 0))
                raise
            finally:
                with self._lock:
                    self._inflight.pop(j, None)
                ev.set()

    # ------------------------------------------------------------ public ----
    def prefetch(self, chunk_ids: Iterable[int]) -> None:
        """Hint upcoming chunks: the reader thread pulls them off disk while
        the device computes the current round (READ/compute overlap)."""
        if self._closed:
            return
        n = 0
        for j in chunk_ids:
            self._hints.put(int(j))
            n += 1
        if n and self.tracer.enabled:
            self.tracer.event("prefetch_hint", n=n)

    def _fill_raw(self, j: int, out_rows: np.ndarray) -> np.ndarray:
        """Fill ``out_rows[:rows]`` with chunk ``j``'s bytes in place.

        Host-cache (or in-flight) chunks copy out of the cache; cold
        disk-backed chunks ``readinto()`` the file directly into the slab
        slice — the zero-copy path (retry + end-to-end CRC included, the
        read happens inside :meth:`ChunkStore.read_chunk_into`).
        """
        with self._lock:
            raw = self._cache.get(j)
            if raw is not None:
                self._cache.move_to_end(j)
                self.cache_hits += 1
            inflight = j in self._inflight
        if raw is None and not inflight and self._direct_readinto:
            t0 = time.perf_counter()
            with self.tracer.span("READ", chunk=j, zero_copy=1):
                view, retries = self.retry.call(
                    lambda: self.store.read_chunk_into(j, out_rows), j)
            dt = time.perf_counter() - t0
            with self._lock:
                self.chunk_reads += 1
                self.read_retries += retries
                self.read_errors.pop(j, None)
                self.bytes_read += view.nbytes
                self.read_seconds += dt
            return view
        if raw is None:
            raw = self._read_chunk(j)
        out_rows[: raw.shape[0]] = raw
        return out_rows[: raw.shape[0]]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of ``arr`` on the engine's device; synchronous, so ``arr``
        may be refilled as soon as this returns."""
        return torch.from_numpy(arr).to(self.device, copy=True)

    def _maybe_fill_decoded(self, j: int, raw: np.ndarray) -> None:
        """Parse-once: retain chunk ``j``'s decoded block on first extract.
        ASCII decodes through :func:`~repro_torch.kernels.ops.extract_parse`
        on the engine's device (the CUDA parse kernel on the card, the plain
        parse on the CPU); other codecs through their plain decode."""
        if self.decoded is None or j in self.decoded or raw.shape[0] == 0:
            return
        if raw.shape[0] * self._num_cols * 4 > self.decoded.budget_bytes:
            return
        raw_t = torch.from_numpy(np.ascontiguousarray(raw))
        if self._is_ascii:
            dec = kernel_ops.extract_parse(raw_t.to(self.device),
                                           self._num_cols)
        else:
            dec = self.store.codec.decode_ref(raw_t)
        blk = dec.cpu().numpy().astype(np.float32, copy=False)
        if self.decoded.put(j, blk):
            self.decoded_fills += 1

    def decoded_fraction(self) -> float:
        """Fraction of the store's tuples whose decoded blocks are cached —
        the ``decoded_fraction`` term
        :func:`repro_torch.sched.admission.eq4_cost_terms` discounts the
        Eq. (4) CPU cost by."""
        if self.decoded is None:
            return 0.0
        total = int(self.store.num_tuples)
        return min(1.0, self.decoded.tuples_cached / max(total, 1))

    def drop_decoded(self, chunk_ids: Iterable[int]) -> int:
        """Drop chunks from the decoded cache (quarantine hook); returns the
        number actually dropped."""
        if self.decoded is None:
            return 0
        return sum(self.decoded.drop(int(j)) for j in chunk_ids)

    def assemble(self, chunk_ids: np.ndarray, active: np.ndarray):
        """Build the round's slab(s) on the engine's device.

        ``chunk_ids[w]`` is worker w's chunk (from ``plan_claims``); inactive
        workers get zero rows (the round masks them by ``b_eff == 0``).
        Buffers come from a two-deep pre-allocated host ring, disk bytes
        ``readinto()`` the target slab slice with no staging copy, and the
        slab is copied to the device before this returns.

        Returns the device slab (decoded cache off), or a
        ``(raw, dec, is_decoded, all_decoded)`` 4-tuple (decoded cache on):
        the first three are device tensors — cached workers get zero raw
        rows + their decoded block, feeding the decoded-input kernel — and
        ``all_decoded`` is a host bool (every *active* worker decoded) the
        engine uses to pick the all-decoded round variant, which skips
        tokenize/parse entirely.  All-decoded rounds never touch the raw
        ring: the raw leaf is a cached zero-row ``(W, 0, rec)`` slab (the
        ``"all"`` round variant never reads it), so a hot re-scan pays
        neither the slab zero-fill nor the host→device raw transfer.
        """
        if self.adaptive:
            self._observe_round(int(np.sum(np.asarray(active, bool))))
        i = self._ring_i
        self._ring_i = (i + 1) % len(self._ring)
        buf = self._ring[i]
        if self.decoded is None:
            buf.fill(0)
            for w in range(self.num_workers):
                if bool(active[w]):
                    self._fill_raw(int(chunk_ids[w]), buf[w])
            self.slabs_built += 1
            if self.adaptive:
                # stamp *after* the synchronous reads: the next round's gap
                # then measures compute/step time only, not READ time
                self._last_assemble_t = time.perf_counter()
            return self._to_device(buf)
        self.decoded.check_version(self.store.content_version)
        dbuf = self._dec_ring[i]
        is_dec = np.zeros(self.num_workers, bool)
        # probe before filling: an all-decoded round skips the raw ring
        # entirely (no zero-fill, no transfer)
        all_dec = all(int(chunk_ids[w]) in self.decoded
                      for w in range(self.num_workers) if bool(active[w]))
        if not all_dec:
            buf.fill(0)
        for w in range(self.num_workers):
            if not bool(active[w]):
                dbuf[w].fill(0)
                continue
            j = int(chunk_ids[w])
            blk = self.decoded.get(j)
            if blk is not None:
                dbuf[w, : blk.shape[0]] = blk
                dbuf[w, blk.shape[0]:].fill(0)
                is_dec[w] = True
                self.decoded_hits += 1
                if self._last_assembled.get(w) != j:
                    # full-chunk granularity: a freshly claimed cached
                    # chunk's rows never hit the tokenizer again
                    self.extract_tuples_avoided += int(blk.shape[0])
                self._last_assembled[w] = j
                continue
            self.decoded_misses += 1
            dbuf[w].fill(0)
            raw = self._fill_raw(j, buf[w])
            self._maybe_fill_decoded(j, raw)
            self._last_assembled[w] = j
        self.slabs_built += 1
        if self.adaptive:
            # stamp *after* the synchronous reads: the next round's gap then
            # measures compute/step time only, not READ time
            self._last_assemble_t = time.perf_counter()
        if all_dec:
            if self._empty_slab_dev is None:
                self._empty_slab_dev = self._to_device(
                    np.zeros((self.num_workers, 0, self.slab_shape[2]),
                             np.uint8))
            raw_dev = self._empty_slab_dev
        else:
            raw_dev = self._to_device(buf)
        return (raw_dev, self._to_device(dbuf), self._to_device(is_dec),
                all_dec)

    def _observe_round(self, n_claims: int) -> None:
        """Adaptive lookahead from the measured READ/CPU rate ratio.

        One chunk READ takes ``read_seconds / chunk_reads`` wall seconds;
        one round (the gap between ``assemble`` calls ≈ device compute +
        host step) takes ``_round_s``.  The reader must run
        ``ceil(t_read / t_round)`` rounds ahead — times the chunks the scan
        consumes per round — for READ to stay hidden under compute.  A slow
        store therefore *raises* the lookahead (up to ``max_lookahead``,
        which the cache is provisioned for); a fast one relaxes it back to
        the configured base.
        """
        now = time.perf_counter()
        if self._last_assemble_t is not None:
            # gap since the previous assemble *finished* (see the end-of-
            # assemble stamp): device compute + host step, READ excluded
            dt = now - self._last_assemble_t
            self._round_s = (dt if self._round_s is None
                             else 0.7 * self._round_s + 0.3 * dt)
            self._claims_per_round = (0.7 * self._claims_per_round
                                      + 0.3 * max(n_claims, 0))
        if self._round_s is None or self.chunk_reads == 0:
            return
        t_read = self.read_seconds / self.chunk_reads
        rounds_spanned = t_read / max(self._round_s, 1e-9)
        need = math.ceil(rounds_spanned * max(self._claims_per_round, 1.0))
        self.lookahead = int(np.clip(need, self.base_lookahead,
                                     self.max_lookahead))

    # ---------------------------------------------------------- counters ----
    def counters(self) -> dict:
        """Point-in-time snapshot of the monotone counters (decoded-cache
        totals included when that tier is on)."""
        with self._lock:
            out = {f: int(getattr(self, f)) for f in self.COUNTER_FIELDS}
            out["read_errors_pending"] = len(self.read_errors)
        if self.decoded is not None:
            out["decoded_evictions"] = int(self.decoded.evictions)
            out["decoded_bytes_cached"] = int(self.decoded.bytes_cached)
            out["decoded_tuples_cached"] = int(self.decoded.tuples_cached)
        return out

    def reset_counters(self) -> None:
        """Zero every ``COUNTER_FIELDS`` counter, the READ-time probe, and
        the per-chunk error slots.  This is the *only* reset path: neither
        ``close()`` nor reader-thread exit touches the counters, so totals
        stay cumulative over the prefetcher's lifetime unless the owner
        explicitly asks for a fresh window."""
        with self._lock:
            for f in self.COUNTER_FIELDS:
                setattr(self, f, 0)
            self.read_errors.clear()
            self.read_seconds = 0.0

    def bind_metrics(self, registry, prefix: str = "prefetch") -> None:
        """Expose the counter block on a
        :class:`~repro_torch.obs.metrics.MetricsRegistry` as pull gauges — read
        at snapshot time, zero writes on any hot path.  Idempotent; safe to
        call again after :meth:`reset_counters` (gauges re-read the live
        attributes)."""
        for f in self.COUNTER_FIELDS:
            registry.gauge(f"{prefix}_{f}",
                           help=f"SlabPrefetcher.{f} (cumulative)",
                           fn=(lambda f=f: getattr(self, f)))
        registry.gauge(f"{prefix}_read_seconds",
                       help="cumulative wall seconds spent in chunk READs",
                       fn=lambda: self.read_seconds)
        if self.decoded is not None:
            dec = self.decoded
            registry.gauge(f"{prefix}_decoded_evictions",
                           help="DecodedChunkCache evictions",
                           fn=lambda: dec.evictions)
            registry.gauge(f"{prefix}_decoded_bytes_cached",
                           help="DecodedChunkCache resident bytes",
                           fn=lambda: dec.bytes_cached)

    def close(self) -> None:
        # counters deliberately NOT reset here — see reset_counters()
        self._closed = True
        self._hints.put(None)
        # join the reader so interpreter shutdown can't race a half-read
        # chunk (daemon threads die mid-read otherwise); bounded so a stuck
        # disk cannot hang close()
        reader = getattr(self, "_reader", None)
        if (reader is not None and reader.is_alive()
                and reader is not threading.current_thread()):
            reader.join(timeout=5.0)


def _reader_main(ref: "weakref.ref[SlabPrefetcher]",
                 hints: "queue.SimpleQueue") -> None:
    """Background READ loop.  Module-level on purpose: the thread must not
    keep the prefetcher alive, so it polls a weakref and exits once the
    owner is closed or collected."""
    while True:
        try:
            j = hints.get(timeout=1.0)
        except queue.Empty:
            if ref() is None:
                return
            continue
        pf = ref()
        if pf is None or j is None or pf._closed:
            return
        try:
            with pf._lock:
                hit = j in pf._cache
            if not hit:
                pf._read_chunk(int(j))
        except Exception as e:
            # the reader must never die — but a failure must not vanish
            # either: count it and stash the exception per chunk id so
            # assemble() can retry synchronously and re-raise if the chunk
            # really is gone (the old bare ``pass`` silently under-delivered
            # the round)
            with pf._lock:
                pf.read_failures += 1
                pf.read_errors[int(j)] = e
        del pf  # drop the strong ref before blocking on the next hint
