"""Deterministic synthetic token stream for the LM substrate; counterpart of
`repro.data.tokens`, the same numpy draws in the same order, so both
packages' batches are equal bit for bit for a seed.

Zipf-distributed tokens with a planted bigram structure so perplexity has
headroom to improve during training (pure uniform tokens would pin loss at
log(vocab)). Batches are generated on host in numpy and moved to the device by the
caller, the pattern a real input pipeline follows.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        # Zipf-ish unigram distribution over a capped alphabet for speed.
        self.alphabet = min(vocab_size, 4096)
        ranks = np.arange(1, self.alphabet + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # Planted bigram: each token deterministically biases its successor.
        self.succ = self.rng.integers(0, self.alphabet, size=self.alphabet)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, targets), both (batch, seq) int32; targets are
        tokens shifted left (next-token prediction)."""
        draws = self.rng.choice(
            self.alphabet, size=(self.batch, self.seq + 1), p=self.probs
        )
        # 50% of positions follow the planted bigram of their (final)
        # predecessor — chained sequentially so the bigram statistics hold.
        follow = self.rng.random((self.batch, self.seq)) < 0.5
        toks = draws.copy()
        for t in range(self.seq):
            toks[:, t + 1] = np.where(
                follow[:, t], self.succ[toks[:, t]], draws[:, t + 1]
            )
        return (
            toks[:, :-1].astype(np.int32),
            toks[:, 1:].astype(np.int32),
        )
