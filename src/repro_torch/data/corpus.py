"""Training corpus with a raw metadata plane for OLA verification
(counterpart of ``repro.data.corpus``; same bytes for the same seed).

A :class:`SyntheticCorpus` is organised in *segments* (the ingest unit);
each segment carries

* a token payload — (num_docs, doc_len) int32 synthetic token sequences,
  and
* a **raw metadata table** — one row per document in fixed-width ASCII
  (columns: doc_len, quality, lang_id, dup_score, tok_entropy, src_id),
  the kind of per-record raw file the paper's engine samples.

The ingest gate (``ola_ml/verify.py``) runs the PTF-style verification
sequence over each segment's metadata ChunkStore before its tokens are
used.  Quality statistics vary by segment, so some segments fail
verification (``poison=True``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.chunkstore import ChunkStore
from repro_torch.data.generator import store_dataset


@dataclasses.dataclass
class Segment:
    index: int
    tokens: np.ndarray         # (docs, doc_len) int32
    meta_store: ChunkStore     # raw metadata table
    poison: bool


class SyntheticCorpus:
    def __init__(self, vocab: int, num_segments: int = 8,
                 docs_per_segment: int = 512, doc_len: int = 256,
                 meta_chunks: int = 16, poison_every: int = 3,
                 seed: int = 0):
        self.vocab = vocab
        self.doc_len = doc_len
        self.segments: list[Segment] = []
        rng = np.random.default_rng(seed)
        for si in range(num_segments):
            poison = poison_every > 0 and (si % poison_every
                                           == poison_every - 1)
            toks = self._sample_tokens(rng, docs_per_segment, doc_len, vocab)
            meta = self._sample_meta(rng, docs_per_segment, poison)
            store = store_dataset(meta, meta_chunks, "ascii",
                                  name=f"seg{si}", seed=seed + si)
            self.segments.append(Segment(si, toks, store, poison))

    @staticmethod
    def _sample_tokens(rng, docs, doc_len, vocab):
        # cheap order-0 zipfian token stream — enough for loss curves
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -1.1
        p /= p.sum()
        return rng.choice(vocab, size=(docs, doc_len), p=p).astype(np.int32)

    @staticmethod
    def _sample_meta(rng, docs, poison):
        doc_len = rng.integers(16, 2048, docs).astype(np.float64)
        quality = rng.beta(8, 2 if not poison else 6, docs) * 100.0
        lang_id = rng.integers(0, 30, docs).astype(np.float64)
        dup = rng.beta(1, 20 if not poison else 3, docs) * 100.0
        ent = rng.normal(7.0 if not poison else 4.5, 0.8, docs)
        src = rng.integers(0, 12, docs).astype(np.float64)
        return np.stack([doc_len, quality, lang_id, dup, ent, src], axis=1)

    def batches(self, segment: Segment, batch: int, seq_len: int, steps: int,
                seed: int = 0):
        """Yield {tokens, labels} batches from a verified segment."""
        rng = np.random.default_rng(seed + segment.index)
        docs, dl = segment.tokens.shape
        # as the reference writes it: the ceil applies before the division
        reps = max(1, int(np.ceil(seq_len + 1) / dl))
        for _ in range(steps):
            rows = rng.integers(0, docs, size=(batch, reps + 1))
            flat = segment.tokens[rows].reshape(batch, -1)
            out = flat[:, : seq_len + 1]
            yield {"tokens": out[:, :-1].astype(np.int32),
                   "labels": out[:, 1:].astype(np.int32)}


# Verification battery (the PTF analogy, Section 1): each query must pass
# for the segment to be admitted.  Columns: 0 len, 1 quality, 2 lang, 3 dup,
# 4 entropy, 5 src.
def standard_ingest_queries(epsilon: float = 0.05):
    from repro_torch.core.queries import TRUE, Column, Having, Query

    return [
        # mean quality high enough
        Query(agg="avg", expr=Column(1), pred=TRUE,
              having=Having(">", 75.0), epsilon=epsilon, name="avg_quality"),
        # near-duplicate mass below threshold
        Query(agg="avg", expr=Column(3), pred=TRUE,
              having=Having("<", 10.0), epsilon=epsilon, name="avg_dup"),
        # token entropy sane
        Query(agg="avg", expr=Column(4), pred=TRUE,
              having=Having(">", 6.0), epsilon=epsilon, name="avg_entropy"),
    ]
