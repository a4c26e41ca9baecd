"""Synthetic dataset generators (counterpart of ``repro.data.generator``).

:func:`make_synthetic_zipf` is the paper's §7.1 "synthetic" dataset: 16
columns, column k Zipf with parameter ``0.25·k``; :func:`make_ptf_like`
is the PTF-shaped transient catalog of the verification workflow;
:func:`make_wiki_like` is the wiki-traffic table the GROUP BY workloads
group by language;
:func:`store_dataset` encodes values into a
:class:`~repro_torch.data.chunkstore.ChunkStore`.  All draw from numpy ``Generator``s exactly as the reference does, so the
same seed gives the same table in either package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.chunkstore import ChunkStore
from repro_torch.data.formats import AsciiFixedFormat, BinaryBigEndianFormat


def bounded_zipf(rng: np.random.Generator, s: float, size: int,
                 support: int = 100_000, vmax: float = 1e8 - 1) -> np.ndarray:
    """Zipf(s) over a finite support, scaled to [0, vmax] (inverse-CDF
    sampling, valid for any s >= 0; s = 0 is uniform)."""
    ranks = np.arange(1, support + 1, dtype=np.float64)
    w = ranks ** -s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(size)
    idx = np.searchsorted(cdf, u)
    return idx.astype(np.float64) * (vmax / support)


def make_synthetic_zipf(num_tuples: int = 131_072, num_cols: int = 16,
                        seed: int = 0) -> np.ndarray:
    """The paper's synthetic dataset at configurable scale."""
    rng = np.random.default_rng(seed)
    cols = [bounded_zipf(rng, 0.25 * k, num_tuples) for k in range(num_cols)]
    return np.stack(cols, axis=1)


def make_ptf_like(num_tuples: int = 131_072, num_chunks_hint: int = 128,
                  seed: int = 0) -> np.ndarray:
    """PTF-shaped data: time-sorted, position-clumped transient detections.

    Columns: [0] ra, [1] dec, [2] time, [3] mag, [4] mag_err, [5] flux,
    [6] field_id, [7] ccd_id.  Tuples are sorted by time; each "night"
    produces a handful of clumps near the telescope's pointing, emitted
    clump by clump in contiguous runs of one to two and a half chunks, so a
    chunk is (mostly) one clump: internally homogeneous, very different
    from its neighbours (the paper's Figure 8 regime for the PTF catalog).
    """
    rng = np.random.default_rng(seed)
    chunk_tuples = max(num_tuples // num_chunks_hint, 1)
    rows = []
    t0 = 0.0
    made = 0
    night = 0
    while made < num_tuples:
        n_clumps = int(rng.integers(2, 6))
        centers_ra = rng.normal(180.0 + 40.0 * np.sin(night / 6.0), 15.0,
                                n_clumps) % 360
        centers_dec = rng.normal(33.0, 8.0, n_clumps)
        base_mag = rng.uniform(14, 21, n_clumps)
        for c in range(n_clumps):
            if made >= num_tuples:
                break
            n = min(int(chunk_tuples * rng.uniform(1.0, 2.5)),
                    num_tuples - made)
            ra = (centers_ra[c] + rng.normal(0, 0.4, n)) % 360
            dec = np.clip(centers_dec[c] + rng.normal(0, 0.4, n), -90, 90)
            time = t0 + np.sort(rng.random(n)) * 0.4
            mag = np.clip(base_mag[c] + rng.normal(0, 0.3, n), 10, 25)
            mag_err = np.abs(rng.normal(0.02, 0.01, n)) + 1e-3
            flux = 10 ** (-0.4 * (mag - 25.0))
            field_id = np.full(n, float(night % 97))
            ccd_id = rng.integers(0, 12, n).astype(np.float64)
            rows.append(np.stack([ra, dec, time, mag, mag_err, flux,
                                  field_id, ccd_id], 1))
            made += n
            t0 += 0.4
        night += 1
    return np.concatenate(rows, axis=0)[:num_tuples]


def store_dataset(values: np.ndarray, num_chunks: int, fmt: str = "ascii",
                  name: str = "dataset", directory: str | None = None,
                  uneven: bool = False, seed: int = 0,
                  uneven_spread: float = 0.25, encode_map=map) -> ChunkStore:
    """Encode ``values`` into a chunked raw store.

    ``uneven=True`` draws chunk sizes from a ±``uneven_spread`` jitter around
    the mean.  ``encode_map`` maps the codec's ``encode`` over the chunks'
    value blocks (pass a thread pool's ``map`` to encode chunks in
    parallel; numpy releases the interpreter lock)."""
    t, c = values.shape
    num_chunks = max(min(num_chunks, t // 2), 1)  # no empty chunks
    codec = (AsciiFixedFormat(c) if fmt == "ascii" else BinaryBigEndianFormat(c))
    if uneven:
        rng = np.random.default_rng(seed + 1)
        w = rng.uniform(1.0 - uneven_spread, 1.0 + uneven_spread, num_chunks)
        sizes = np.maximum((w / w.sum() * t).astype(np.int64), 2)
        while sizes.sum() > t:
            sizes[np.argmax(sizes)] -= 1
        while sizes.sum() < t:
            sizes[np.argmin(sizes)] += 1
    else:
        base = t // num_chunks
        sizes = np.full(num_chunks, base, np.int64)
        sizes[: t - base * num_chunks] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    blocks = [values[bounds[j]:bounds[j + 1]] for j in range(num_chunks)]
    store = ChunkStore.create(name=name, codec=codec, directory=directory)
    for j, raw in enumerate(encode_map(codec.encode, blocks)):
        store.append_chunk(raw, num_tuples=int(sizes[j]))
    store.finalize()
    return store


def make_wiki_like(num_tuples: int = 262_144, num_languages: int = 40,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Wiki-traffic-shaped data: [0] language_id, [1] hits, [2] bytes,
    [3] hour.  Language frequencies are Zipf(1.1) (the first language
    dominates); hits are lognormal, bytes proportional to hits.  Returns
    ``(values, language_ids)``."""
    rng = np.random.default_rng(seed)
    lang_w = (np.arange(1, num_languages + 1, dtype=np.float64)) ** -1.1
    lang_w /= lang_w.sum()
    lang = rng.choice(num_languages, size=num_tuples, p=lang_w)
    hits = np.floor(np.exp(rng.normal(2.0, 1.5, num_tuples)))
    nbytes = hits * np.abs(rng.normal(8_000, 3_000, num_tuples))
    nbytes = np.minimum(nbytes, 1e8 - 1)
    hour = rng.integers(0, 24 * 31, num_tuples).astype(np.float64)
    vals = np.stack([lang.astype(np.float64), hits, nbytes, hour], 1)
    return vals, np.arange(num_languages)
