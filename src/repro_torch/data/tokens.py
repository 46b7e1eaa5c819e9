"""Deterministic synthetic LM data: a Zipfian token stream with local n-gram
structure (so the loss actually decreases).

A copy of ``repro/data/tokens.py::SyntheticTokenStream`` with its imports
rewritten (numpy only), so that a seed gives the reference's batches bit
for bit. The reference's ``lm_input_specs`` (``jax.ShapeDtypeStruct``
stand-ins for its dry run) is left out here: its counterpart is the port's
dry run's ``launch/specs.py::input_specs`` (``meta`` tensor stand-ins).
"""
from __future__ import annotations

import numpy as np

__all__ = ["SyntheticTokenStream"]


class SyntheticTokenStream:
    """Zipf-distributed tokens with a first-order Markov skeleton: token t+1
    is (a·t + b) mod V with prob q, else a fresh Zipf draw — learnable
    structure for convergence tests."""

    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq_len: int,
        seed: int = 0,
        zipf_a: float = 1.2,
        markov_q: float = 0.7,
    ):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        self.q = markov_q
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        self.a = 31
        self.b = 17

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """(inputs [B, S], targets [B, S]) with targets = inputs shifted."""
        b, s, v = self.batch, self.seq, self.vocab
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = self.rng.choice(v, size=b, p=self.p)
        fresh = self.rng.choice(v, size=(b, s), p=self.p)
        follow = self.rng.random((b, s)) < self.q
        for t in range(s):
            nxt = (self.a * toks[:, t] + self.b) % v
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return toks[:, :-1], toks[:, 1:]
