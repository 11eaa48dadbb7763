"""Deterministic synthetic LM data (port of ``src/repro/data/synthetic.py``).

Numpy inside, exactly as the reference, so both packages see the same tokens
for the same seed; the batches come out as torch tensors on ``device``.
Tokens and labels are int64, the index type PyTorch's gathers take.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["lm_batches", "make_batch_for"]


def _lm_arrays(vocab: int, batch: int, seq: int, seed: int, step: int,
               next_tok: np.ndarray, structure: float) -> tuple[np.ndarray, np.ndarray]:
    r = np.random.default_rng((seed, step))
    toks = np.empty((batch, seq), dtype=np.int64)
    toks[:, 0] = r.integers(0, vocab, size=batch)
    for t in range(1, seq):
        follow = r.random(batch) < structure
        toks[:, t] = np.where(follow, next_tok[toks[:, t - 1]], r.integers(0, vocab, size=batch))
    labels = np.concatenate([toks[:, 1:], -np.ones((batch, 1), np.int64)], axis=1)
    return toks, labels


def _to(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to the card through pinned memory
    with a non-blocking copy, so loading a batch never waits for the device."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def lm_batches(
    vocab: int, batch: int, seq: int, *, seed: int = 0, structure: float = 0.8,
    device: str | torch.device = "cpu",
) -> Iterator[dict]:
    """Endless stream of {tokens, labels}; a planted bigram table makes
    ``structure`` of the transitions deterministic (a learnable signal)."""
    rng = np.random.default_rng(seed)
    next_tok = rng.integers(0, vocab, size=vocab)
    step = 0
    while True:
        toks, labels = _lm_arrays(vocab, batch, seq, seed, step, next_tok, structure)
        yield {"tokens": _to(toks, device), "labels": _to(labels, device)}
        step += 1


def make_batch_for(cfg, *, batch: int, seq: int, seed: int = 0,
                   device: str | torch.device = "cpu") -> dict:
    """One concrete batch for a decoder-only text config."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, size=(batch, seq))
    labels = np.concatenate([toks[:, 1:], -np.ones((batch, 1), np.int64)], axis=1)
    return {"tokens": _to(toks, device), "labels": _to(labels, device)}
