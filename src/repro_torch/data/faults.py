"""Scan-plane fault taxonomy (counterpart of ``repro.data.faults``).

Only the error types the chunk store raises live here; retry policies and
fault injection belong to the streaming residency, which this package does
not have yet.
"""

from __future__ import annotations

from typing import Optional


class FaultError(Exception):
    """Base class for scan-plane faults; carries the offending chunk id."""

    def __init__(self, msg: str, chunk_id: Optional[int] = None):
        super().__init__(msg)
        self.chunk_id = chunk_id


class CorruptChunkError(FaultError):
    """Chunk bytes fail their manifest CRC32 — content cannot be trusted."""
