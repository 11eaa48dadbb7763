"""What the experiments share: the heterogeneous event-driven commit order,
the Fig.-3 MLP problem and iterations-to-threshold."""

# reprolint: disable-file=RL001
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.async_engine import EventSimConfig, simulate_staleness_trace
from repro_torch.models.cnn import init_mlp_classifier
from repro_torch.tree import tree_map

__all__ = ["event_order", "mlp_problem", "iters_to", "to_device"]


def event_order(m: int, T: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(taus, order)`` of ``T`` commits by ``m`` workers of heterogeneous
    speed (heavy-tailed tau): the realistic regime of the paper's Fig. 3."""
    cfg = EventSimConfig(m=m, compute_mean=1.0, compute_shape=0.7, apply_mean=0.3 / m,
                         heterogeneity=0.9)
    return simulate_staleness_trace(cfg, T, seed=seed, return_workers=True)


def to_device(tree: Any, device) -> Any:
    """A tree of numpy arrays or tensors as tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def mlp_problem(T: int, bsz: int, seed: int, *, device="cuda",
                params: Callable[[int], Any] | None = None) -> tuple[dict, dict]:
    """Gaussian blobs in 32 dims, 10 classes, one minibatch per commit (the
    reference's ``_make_problem``: numpy draws, so the batches are the
    same), and a 32-64-10 MLP: ``params(seed)`` if given, else torch's
    draws from ``seed``."""
    rng = np.random.default_rng(seed)
    d_in, classes = 32, 10
    mus = rng.normal(size=(classes, d_in))
    mus = 3.0 * mus / np.linalg.norm(mus, axis=1, keepdims=True)
    ys = rng.integers(0, classes, size=(T, bsz))
    xs = mus[ys] + rng.normal(size=(T, bsz, d_in))
    batches = {"x": torch.from_numpy(xs.astype(np.float32)).to(device),
               "labels": torch.from_numpy(ys).to(device)}
    if params is not None:
        p0 = to_device(params(seed), device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        p0 = init_mlp_classifier(gen, d_in=d_in, d_hidden=64, num_classes=classes, device=device)
    return p0, batches


def iters_to(losses, thresh: float, win: int = 25) -> int:
    """Commits until the ``win``-commit moving average falls below
    ``thresh`` (``len + 1`` when it never does)."""
    losses = np.asarray(losses)
    sm = np.convolve(losses, np.ones(win) / win, mode="valid")
    idx = np.nonzero(sm < thresh)[0]
    return int(idx[0]) + win if idx.size else len(losses) + 1
