"""Synthetic token streams for LM training (a bit-equal copy of the
reference's numpy code, ``repro/data/tokens.py``).

A fixed-seed Zipfian n-gram process: structured enough that a model's loss
decreases during the example training runs, cheap enough to generate on the
fly. Also provides the federated variant: per-device token streams with
device-specific topic mixtures (the LM analogue of label skew). Arrays are
numpy int32; the trainers take them as tensors on their device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["federated_lm_data", "lm_batches", "zipf_bigram_stream"]


def zipf_bigram_stream(rng: np.random.Generator, vocab_size: int,
                       length: int, *, topic: int = 0, n_topics: int = 8):
    """Token stream from a topic-dependent bigram chain."""
    # deterministic per-(vocab,topic) transition structure
    base = np.random.default_rng(123 + topic)
    # each token maps to a small successor set; topic shifts the mapping
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


def lm_batches(rng: np.random.Generator, vocab_size: int, *, batch: int,
               seq_len: int, steps: int, topic: int = 0):
    """Yields {"tokens", "targets"} batches."""
    stream = zipf_bigram_stream(rng, vocab_size,
                                batch * (seq_len + 1) * steps + 1,
                                topic=topic)
    for s in range(steps):
        off = s * batch * (seq_len + 1)
        chunk = stream[off:off + batch * (seq_len + 1) + 1]
        tok = np.stack([chunk[i * (seq_len + 1):(i + 1) * (seq_len + 1)]
                        for i in range(batch)])
        yield {"tokens": tok[:, :-1].astype(np.int32),
               "targets": tok[:, 1:].astype(np.int32)}


def federated_lm_data(rng: np.random.Generator, vocab_size: int, *,
                      m_teams: int, n_devices: int, seq_len: int,
                      seqs_per_device: int):
    """Stacked (M, N, S, seq) token tensors; team i uses topic i."""
    toks = np.zeros((m_teams, n_devices, seqs_per_device, seq_len + 1),
                    np.int32)
    for i in range(m_teams):
        for j in range(n_devices):
            stream = zipf_bigram_stream(
                rng, vocab_size, seqs_per_device * (seq_len + 1) + 1,
                topic=i)
            toks[i, j] = stream[:seqs_per_device * (seq_len + 1)].reshape(
                seqs_per_device, seq_len + 1)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
