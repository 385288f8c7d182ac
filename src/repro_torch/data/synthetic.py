"""Deterministic synthetic data pipelines — a copy of
``repro/data/synthetic.py`` (NumPy only), so the port's batches equal
the reference's bit for bit.

Batches are a pure function of (seed, step) — this is the substrate for
the fault-tolerance story: a restarted or re-placed host regenerates
exactly its own shard for any step (no replay log needed), and elastic
re-sharding is just re-slicing the same deterministic stream
(DESIGN.md §6).

The token stream is a structured Markov-ish source (not uniform noise)
so language-model training loss has signal to descend — integration
tests assert loss decreases.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """Global batch for ``step``, or the ``shard``-th of n_shards."""
        assert self.global_batch % n_shards == 0
        per = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard])
        )
        b = per
        # structured stream: piecewise-linear token walks => predictable
        start = rng.integers(0, self.vocab_size, (b, 1))
        stride = rng.integers(1, 8, (b, 1))
        idx = np.arange(self.seq_len + 1)[None, :]
        toks = (start + stride * idx) % self.vocab_size
        noise = rng.random((b, self.seq_len + 1)) < 0.05
        toks = np.where(noise,
                        rng.integers(0, self.vocab_size, toks.shape), toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass(frozen=True)
class EmbedPipeline:
    """Frontend-stub pipeline: precomputed frame/patch embeddings
    (audio/vision archs per the assignment)."""

    d_model: int
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        per = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, 7])
        )
        emb = rng.standard_normal(
            (per, self.seq_len, self.d_model), dtype=np.float32)
        labels = rng.integers(0, self.vocab_size,
                              (per, self.seq_len)).astype(np.int32)
        return {"embeds": emb, "labels": labels}
