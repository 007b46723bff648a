"""Deterministic synthetic LM data pipeline (host-sharded, prefetching): a
copy of the reference's ``data/pipeline.py``, NumPy only.

Token streams are generated from a seeded Markov-ish process (so a model
*can* learn structure and the loss curve is meaningful), sharded by host
(`host_id/num_hosts`), resumable at an exact step (state = (seed, step)).
``batch_at(step)`` gives the reference's batch bit for bit.  The
reference's prefetch thread waits with the rest of its data package
(ROADMAP: the rest of the LM scaffold).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class SyntheticLM:
    """Order-1 Markov token source with per-source transition sharpness —
    different 'sources' have different entropies so mixture weights matter."""

    def __init__(self, vocab: int, seed: int = 0, sharpness: float = 2.0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # low-rank transition logits keep memory O(vocab * rank)
        rank = min(64, vocab)
        self._u = rng.normal(size=(vocab, rank)) * sharpness / np.sqrt(rank)
        self._v = rng.normal(size=(rank, vocab))

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            logits = self._u[toks[:, t]] @ self._v
            logits -= logits.max(-1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(-1, keepdims=True)
            # vectorized categorical draw
            cum = np.cumsum(p, axis=-1)
            u = rng.random((batch, 1))
            toks[:, t + 1] = (u > cum).sum(-1)
        return toks


class DataPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, *,
                 sources: int = 3, mixture: Optional[Sequence[float]] = None,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        if batch % num_hosts:
            raise ValueError(f"batch {batch} does not split over "
                             f"{num_hosts} hosts")
        self.vocab = vocab
        self.local_batch = batch // num_hosts
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.sources = [SyntheticLM(vocab, seed=1000 + i, sharpness=1.0 + i)
                        for i in range(sources)]
        self.mixture = np.asarray(mixture if mixture is not None
                                  else np.ones(sources) / sources)
        self.mixture = self.mixture / self.mixture.sum()

    # -- deterministic batch addressing (resume == skip-to-step) -------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.host_id, step, 0xBA7C4))
        src_ids = rng.choice(len(self.sources), size=self.local_batch,
                             p=self.mixture)
        toks = np.empty((self.local_batch, self.seq + 1), np.int32)
        for i, s in enumerate(src_ids):
            toks[i] = self.sources[s].sample(rng, 1, self.seq)[0]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
