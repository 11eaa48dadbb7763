"""Deterministic synthetic data (port of ``src/repro/data/synthetic.py``).

Numpy inside, exactly as the reference, so both packages see the same arrays
for the same seed; the batches come out as torch tensors on ``device``.
Tokens and labels are int64, the index type PyTorch's gathers take.

* ``lm_batches``             — token streams with a planted bigram structure;
* ``classification_batches`` — Gaussian-blob classification;
* ``cifar_like_batches``     — 32x32x3 images with class-dependent means, the
  CIFAR-10 stand-in of the paper's Fig. 3 protocol.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["lm_batches", "classification_batches", "cifar_like_batches", "make_batch_for"]


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


def classification_batches(
    d: int, num_classes: int, batch: int, *, seed: int = 0, scale: float = 2.0,
    device: str | torch.device = "cpu",
) -> Iterator[dict]:
    """Gaussian blobs: class c has mean ``scale * mu_c`` (a fixed random unit
    vector); ``x`` is f32, ``labels`` int64."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(num_classes, d))
    mus = scale * mus / np.linalg.norm(mus, axis=1, keepdims=True)
    step = 0
    while True:
        r = np.random.default_rng((seed, 1, step))
        y = r.integers(0, num_classes, size=batch)
        x = mus[y] + r.normal(size=(batch, d))
        yield {"x": _to(x.astype(np.float32), device), "labels": _to(y, device)}
        step += 1


def cifar_like_batches(
    batch: int, *, image: int = 32, num_classes: int = 10, seed: int = 0, scale: float = 1.5,
    device: str | torch.device = "cpu",
) -> Iterator[dict]:
    """NHWC ``(batch, image, image, 3)`` f32 images whose per-class mean
    patterns are fixed random blobs, and int64 labels."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(num_classes, image, image, 3)).astype(np.float32)
    step = 0
    while True:
        r = np.random.default_rng((seed, 2, step))
        y = r.integers(0, num_classes, size=batch)
        x = scale * protos[y] + r.normal(size=(batch, image, image, 3)).astype(np.float32)
        yield {"images": _to(x.astype(np.float32), device), "labels": _to(y, device)}
        step += 1


def make_batch_for(cfg, *, batch: int, seq: int, seed: int = 0,
                   device: str | torch.device = "cpu") -> dict:
    """One concrete batch for a decoder-only text config."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, size=(batch, seq))
    labels = np.concatenate([toks[:, 1:], -np.ones((batch, 1), np.int64)], axis=1)
    return {"tokens": _to(toks, device), "labels": _to(labels, device)}
