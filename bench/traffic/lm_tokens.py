"""Token batches for the LM cells, from the run's seed.

Frozen copy of the program's ``repro_torch.data.tokens.
zipf_bigram_stream`` (the generator behind ``federated_lm_data``): a
topic-dependent bigram chain with Zipf restarts, the LM analogue of the
paper's label skew. :func:`batches` cuts one stream into ``count``
batches of ``batch`` sequences, every row different.
"""
from __future__ import annotations

import numpy as np


def zipf_bigram_stream(rng, vocab_size: int, length: int, *,
                       topic: int = 0):
    """Token stream from a topic-dependent bigram chain."""
    base = np.random.default_rng(123 + topic)
    succ = base.integers(0, vocab_size, size=(vocab_size, 4))
    probs = np.array([0.5, 0.25, 0.15, 0.1])
    out = np.empty(length, np.int32)
    tok = int(rng.integers(0, vocab_size))
    for i in range(length):
        out[i] = tok
        if rng.random() < 0.1:        # restart with zipf marginal
            tok = min(vocab_size - 1, int(rng.zipf(1.3)) - 1)
        else:
            tok = int(succ[tok, rng.choice(4, p=probs)])
    return out


def batches(seed: int, vocab_size: int, *, batch: int, seq_len: int,
            count: int, topic: int) -> tuple:
    """(tokens, targets): int64 numpy arrays (count, batch, seq_len),
    targets the tokens shifted by one, from one stream seeded with
    ``seed``."""
    rows = count * batch
    stream = zipf_bigram_stream(np.random.default_rng(seed), vocab_size,
                                rows * (seq_len + 1), topic=topic)
    toks = stream.reshape(count, batch, seq_len + 1).astype(np.int64)
    return toks[..., :-1], toks[..., 1:]
