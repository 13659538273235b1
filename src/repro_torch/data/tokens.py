"""Synthetic token streams for the LM architectures (a numpy-only copy of
``repro.data.tokens``).

A fixed-transition Markov text source gives learnable (non-uniform-entropy)
sequences for the assigned-architecture training examples/smoke tests.
"""

from __future__ import annotations

import numpy as np


def markov_token_batch(rng: np.random.Generator, batch: int, seq_len: int,
                       vocab: int, order_states: int = 64) -> np.ndarray:
    """(batch, seq_len) int32 tokens from a random sparse Markov source."""
    states = min(order_states, vocab)
    # each state strongly prefers a handful of successor tokens
    prefs = rng.integers(0, vocab, size=(states, 4))
    toks = np.empty((batch, seq_len), np.int32)
    s = rng.integers(0, states, size=batch)
    for t in range(seq_len):
        explore = rng.random(batch) < 0.15
        pick = prefs[s, rng.integers(0, prefs.shape[1], size=batch)]
        rand = rng.integers(0, vocab, size=batch)
        toks[:, t] = np.where(explore, rand, pick)
        s = toks[:, t] % states
    return toks


def lm_batch(seed: int, batch: int, seq_len: int, vocab: int):
    """Returns (tokens, labels) where labels are next-token targets."""
    rng = np.random.default_rng(seed)
    toks = markov_token_batch(rng, batch, seq_len + 1, vocab)
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
