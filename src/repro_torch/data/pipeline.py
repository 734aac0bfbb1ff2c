"""Deterministic, seekable, shard-aware synthetic data pipeline.

A numpy copy of repro/data/pipeline.py: `batch(step)` is a pure function
of (seed, step, shard), so a restarted run resumes bit-exactly from a
checkpointed step; Zipf unigrams with Markov locality, so models learn;
fixed (seq_len + 1) windows give (tokens, labels) pairs. Its batches equal
the reference's exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3           # unigram skew
    locality: float = 0.7         # P(next token ~ local bigram state)


class SyntheticCorpus:
    """Infinite deterministic corpus; `batch(step, shard, num_shards)` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        V = cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        # fixed unigram distribution (Zipf) + a sparse "bigram" successor map
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()
        self.successor = rng.integers(0, V, size=V, dtype=np.int64)

    def _window(self, idx: int) -> np.ndarray:
        """Sample window `idx` of length seq_len + 1 (pure function of idx)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 0xDA7A, idx))
        n = cfg.seq_len + 1
        draws = rng.choice(cfg.vocab_size, size=n, p=self.unigram)
        use_local = rng.random(n) < cfg.locality
        out = np.empty(n, np.int64)
        out[0] = draws[0]
        for i in range(1, n):
            out[i] = self.successor[out[i - 1]] if use_local[i] else draws[i]
        return out

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Global batch for `step`, sliced for `shard` of `num_shards`."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        per = cfg.global_batch // num_shards
        base = step * cfg.global_batch + shard * per
        rows = np.stack([self._window(base + i) for i in range(per)])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


def make_batch_iterator(cfg: DataConfig, start_step: int = 0,
                        shard: int = 0, num_shards: int = 1):
    """Resumable iterator: (step, batch) pairs from `start_step`."""
    corpus = SyntheticCorpus(cfg)
    step = start_step
    while True:
        yield step, corpus.batch(step, shard, num_shards)
        step += 1
