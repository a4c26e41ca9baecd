"""Chunked raw-byte store (counterpart of ``repro.data.chunkstore``).

A :class:`ChunkStore` is a sequence of raw chunks (records in their on-disk
byte format) plus the per-chunk metadata the estimators need (``M_j``).
Chunks live in memory as numpy uint8 arrays, or on disk as
``<name>.chunkNNNNN.bin`` files with a JSON manifest recording each chunk's
tuple count, byte count, path and CRC32 — the same manifest the reference
writes, so a store written by either package opens in the other.

Two device-facing residencies (``EngineConfig.residency``):

* ``"packed"`` — :meth:`packed_device_view`: the whole store on the engine's
  device as one padded ``(N, M_max, record_bytes)`` uint8 tensor;
* ``"stream"`` — the engine pulls bounded per-round ``(W, rows_max, rec)``
  slabs through :class:`repro_torch.data.pipeline.SlabPrefetcher`: chunks
  are read (and, when disk-backed, evicted) on the fly, so host and device
  residency are O(slab), not O(dataset).
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.data.faults import CorruptChunkError
from repro_torch.data.formats import AsciiFixedFormat, BinaryBigEndianFormat


@dataclasses.dataclass
class ChunkMeta:
    num_tuples: int
    num_bytes: int
    path: Optional[str] = None  # set iff disk-backed
    # CRC32 of the chunk's raw bytes, recorded at ingest and checked on
    # every disk re-read; None for manifests written without checksums
    crc32: Optional[int] = None


class ChunkStore:
    def __init__(self, name: str, codec, directory: Optional[str] = None):
        self.name = name
        self.codec = codec
        self.directory = directory
        self.meta: list[ChunkMeta] = []
        self._chunks: list[Optional[np.ndarray]] = []
        self._finalized = False
        self._content_version = 0

    # ------------------------------------------------------------- create --
    @classmethod
    def create(cls, name: str, codec,
               directory: Optional[str] = None) -> "ChunkStore":
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
        return cls(name=name, codec=codec, directory=directory)

    def append_chunk(self, raw: np.ndarray, num_tuples: int) -> None:
        assert not self._finalized
        raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(num_tuples, -1)
        assert raw.shape[1] == self.codec.record_bytes, (
            raw.shape, self.codec.record_bytes)
        j = len(self.meta)
        crc = zlib.crc32(raw.tobytes()) & 0xFFFFFFFF
        if self.directory is not None:
            path = os.path.join(self.directory, f"{self.name}.chunk{j:05d}.bin")
            raw.tofile(path)
            self.meta.append(ChunkMeta(num_tuples, raw.nbytes, path, crc))
            self._chunks.append(None)  # not resident
        else:
            self.meta.append(ChunkMeta(num_tuples, raw.nbytes, None, crc))
            self._chunks.append(raw)
        self._content_version += 1

    def finalize(self) -> None:
        self._finalized = True
        if self.directory is not None:
            manifest = {
                "name": self.name,
                "codec": type(self.codec).__name__,
                "num_cols": self.codec.num_cols,
                "chunks": [dataclasses.asdict(m) for m in self.meta],
            }
            path = os.path.join(self.directory, f"{self.name}.manifest.json")
            with open(path, "w") as f:
                json.dump(manifest, f)

    @classmethod
    def open(cls, directory: str, name: str) -> "ChunkStore":
        """Re-open a disk-backed store from its manifest."""
        with open(os.path.join(directory, f"{name}.manifest.json")) as f:
            manifest = json.load(f)
        codec_cls = {"AsciiFixedFormat": AsciiFixedFormat,
                     "BinaryBigEndianFormat": BinaryBigEndianFormat
                     }[manifest["codec"]]
        store = cls(name=name, codec=codec_cls(manifest["num_cols"]),
                    directory=directory)
        for m in manifest["chunks"]:
            store.meta.append(ChunkMeta(**m))
            store._chunks.append(None)
        store._finalized = True
        return store

    # -------------------------------------------------------------- access --
    @property
    def content_version(self) -> int:
        """Monotone counter over the store's raw content: bumped per
        ingested chunk and by :meth:`mark_content_changed`.  Caches derived
        from the bytes (the prefetcher's decoded-chunk cache) pin the
        version they were built over and clear on a mismatch."""
        return self._content_version

    def mark_content_changed(self) -> None:
        """Signal an out-of-band change of the raw bytes (a re-ingest, an
        external writer): bumps :attr:`content_version`."""
        self._content_version += 1

    @property
    def num_chunks(self) -> int:
        return len(self.meta)

    @property
    def num_tuples(self) -> int:
        return sum(m.num_tuples for m in self.meta)

    @property
    def chunk_sizes(self) -> np.ndarray:
        """The M_j vector (Table 1)."""
        return np.asarray([m.num_tuples for m in self.meta], np.int32)

    @property
    def max_chunk_tuples(self) -> int:
        return int(self.chunk_sizes.max())

    def chunk_bytes(self, j: int) -> np.ndarray:
        """READ one chunk: the resident copy or a CRC-verified disk read."""
        raw = self._chunks[j]
        if raw is None:
            m = self.meta[j]
            data = np.fromfile(m.path, dtype=np.uint8)
            if data.size != m.num_tuples * self.codec.record_bytes:
                raise CorruptChunkError(
                    f"chunk {j}: short read ({data.size} bytes, expected "
                    f"{m.num_tuples * self.codec.record_bytes})", chunk_id=j)
            raw = data.reshape(m.num_tuples, self.codec.record_bytes)
            self.verify_chunk(j, raw)
        return raw

    def read_chunk_into(self, j: int, out: np.ndarray) -> np.ndarray:
        """READ one chunk into ``out`` (C-contiguous uint8, at least
        ``(num_tuples, record_bytes)``); returns the filled view
        ``out[:num_tuples]``.  A disk-backed chunk is ``readinto()`` the
        buffer directly, with no staging copy, then CRC-checked; short
        reads and mismatches raise :class:`CorruptChunkError` as in
        :meth:`chunk_bytes`.  Store wrappers (``FaultInjector``) intercept
        :meth:`chunk_bytes` only, so the prefetcher takes this path only
        when the store's own class provides it."""
        m = self.meta[j]
        view = out[: m.num_tuples]
        raw = self._chunks[j]
        if raw is not None:
            np.copyto(view, raw)
            return view
        nbytes = m.num_tuples * self.codec.record_bytes
        with open(m.path, "rb") as f:
            got = f.readinto(memoryview(view.reshape(-1)[:nbytes]))
        if got != nbytes:
            raise CorruptChunkError(
                f"chunk {j}: short read ({got} bytes, expected {nbytes})",
                chunk_id=j)
        self.verify_chunk(j, view)
        return view

    def verify_chunk(self, j: int, raw: np.ndarray) -> None:
        """Check ``raw`` against chunk ``j``'s manifest CRC32 (no-op for
        manifests without checksums)."""
        crc = self.meta[j].crc32
        if crc is None:
            return
        got = zlib.crc32(np.ascontiguousarray(raw).tobytes()) & 0xFFFFFFFF
        if got != crc:
            raise CorruptChunkError(
                f"chunk {j}: CRC32 mismatch (manifest {crc:#010x}, "
                f"read {got:#010x})", chunk_id=j)

    def evict(self, j: int) -> None:
        """Drop a resident chunk (meaningful for disk-backed stores only)."""
        if self.directory is not None:
            self._chunks[j] = None

    def cache(self, j: int) -> None:
        """Keep chunk ``j`` resident (a disk-backed store reads it once)."""
        if self._chunks[j] is None:
            self._chunks[j] = self.chunk_bytes(j)

    def packed_device_view(self, device) -> tuple[torch.Tensor, np.ndarray]:
        """Padded ``(N, M_max, record_bytes)`` uint8 tensor on ``device`` +
        the ``(N,)`` sizes.  Padding rows are zero; the engine masks by
        ``M_j`` so they are never sampled."""
        n, mx, rb = self.num_chunks, self.max_chunk_tuples, self.codec.record_bytes
        out = torch.zeros((n, mx, rb), dtype=torch.uint8, device=device)
        for j in range(n):
            raw = self.chunk_bytes(j)
            out[j, : raw.shape[0]] = torch.from_numpy(raw).to(device)
            # a disk-backed store must not end up resident twice
            self.evict(j)
        return out, self.chunk_sizes

    def decode_all(self) -> np.ndarray:
        """Ground-truth full EXTRACT (tests and checks only): (T, C) f32."""
        parts = [self.codec.decode_ref(torch.from_numpy(self.chunk_bytes(j))
                                       ).numpy()
                 for j in range(self.num_chunks)]
        return np.concatenate(parts, axis=0)
