"""Deterministic, resumable synthetic LM token pipeline (numpy only), the
reference's ``src/repro/data/tokens.py``: its batches bit for bit.

Every batch is a pure function of (seed, step), so checkpoint/restart
reproduces the exact stream with no stored state. Tokens are
Zipf-distributed with injected bigram structure so losses actually
decrease. :class:`FrameStream` feeds the encoder family (HuBERT).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-ish marginal
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks
        p /= p.sum()
        toks = rng.choice(self.vocab, size=(self.batch, self.seq), p=p)
        # deterministic bigram structure: token t follows (t*7+1) % vocab
        # 30% of the time, making next-token prediction learnable
        follow = rng.random((self.batch, self.seq)) < 0.3
        for j in range(1, self.seq):
            toks[:, j] = np.where(follow[:, j],
                                  (toks[:, j - 1] * 7 + 1) % self.vocab,
                                  toks[:, j])
        return {"tokens": toks.astype(np.int32)}


@dataclass(frozen=True)
class FrameStream:
    """Synthetic audio-frame stream for the hubert encoder."""

    dim: int
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    mask_prob: float = 0.08

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 1]))
        frames = rng.standard_normal((self.batch, self.seq, self.dim))
        targets = rng.integers(0, self.vocab, (self.batch, self.seq))
        # spans of masked frames (wav2vec-style)
        mask = np.zeros((self.batch, self.seq), bool)
        n_spans = max(1, int(self.seq * self.mask_prob / 10))
        for b in range(self.batch):
            starts = rng.integers(0, max(1, self.seq - 10), n_spans)
            for s in starts:
                mask[b, s:s + 10] = True
        return {"frames": frames.astype(np.float32),
                "mask": mask, "targets": targets.astype(np.int32)}
