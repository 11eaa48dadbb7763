"""Exact shared-memory AsyncPSGD simulator — bit-exact staleness semantics
(port of ``src/repro/async_engine/exact.py``).

This is the faithful executable model of the paper's Algorithm 1: ``m``
workers repeatedly (i) read the shared ``x``, (ii) compute a stochastic
gradient on their (possibly stale) view, (iii) send it to the parameter
server which applies ``x <- x - alpha(tau) g``.

The simulation linearizes on *commit events*: a commit order (which worker
applies the ``t``-th update) comes either from the event-driven timing model
(:mod:`repro_torch.async_engine.events`) or a uniform fair scheduler.  The
staleness of commit ``t`` by worker ``w`` is exactly ``tau_t = t -
read_step[w]``, the number of intermediate updates (eq. 4), where
``read_step[w]`` is the commit count at ``w``'s last read.

The reference runs the whole loop as one ``lax.scan``.  Here tau and alpha
are pure functions of the commit order, so they are computed on the host
with numpy before the loop (:func:`commit_staleness`); the loop on the
device only takes the gradient on the committing worker's stale view,
applies ``x - alpha g`` and writes ``x`` into that worker's view.  Nothing in
it waits for the device: the losses are stacked once at the end.

This simulator is the engine for the paper's Fig. 3 experiments
(statistical efficiency of MindTheStep vs constant-alpha AsyncPSGD).
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AsyncTrace", "simulate_async_sgd", "uniform_commit_order", "commit_staleness"]


@dataclasses.dataclass
class AsyncTrace:
    """Outputs of an exact-simulation run (tensors on ``x0``'s device)."""

    params: Any  # final x
    taus: torch.Tensor  # (T,) int32 staleness of each commit
    losses: torch.Tensor  # (T,) loss on the committing worker's view and batch
    alphas: torch.Tensor  # (T,) f32 step size actually applied


def uniform_commit_order(T: int, m: int, seed: int = 0) -> np.ndarray:
    """The uniform fair stochastic scheduler of the paper's tau_S analysis."""
    return np.random.default_rng(seed).integers(0, m, size=T).astype(np.int32)


def commit_staleness(commit_order: np.ndarray, m: int) -> np.ndarray:
    """``tau_t = t - read_step[w_t]`` for every commit, int32: each worker
    reads the fresh state right after its own commit."""
    order = np.asarray(commit_order, np.int64)
    read_step = np.zeros(m, np.int64)
    taus = np.empty(order.shape[0], np.int32)
    for t, w in enumerate(order.tolist()):
        taus[t] = t - read_step[w]
        read_step[w] = t + 1
    return taus


def simulate_async_sgd(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    x0: Any,
    batches: Any,  # tensor or dict of tensors with leading axis T (one minibatch per commit)
    commit_order: np.ndarray,  # (T,) worker ids
    alpha_table: Any,  # (tau_max+1,) alpha(tau) lookup, stored as f32
    m: int,
) -> AsyncTrace:
    """Run T commits of exact AsyncPSGD and return the trace.

    ``loss_fn(params, batch) -> scalar``; gradients are taken on each
    committing worker's *stale view* — statistically exact AsyncPSGD.
    ``x0`` is a tensor or a dict of tensors; the run stays on its device.
    """
    order = np.asarray(commit_order, np.int64)
    table = np.asarray(torch.as_tensor(alpha_table).cpu(), np.float32)
    taus = commit_staleness(order, m)
    alphas = table[np.clip(taus, 0, table.shape[0] - 1)]
    dev = tree_leaves(x0)[0].device
    alphas_dev = torch.from_numpy(alphas).to(dev)
    grad_fn = torch.func.grad_and_value(loss_fn)

    x = x0
    views = tree_map(lambda p: p.unsqueeze(0).repeat((m,) + (1,) * p.dim()), x0)
    losses = []
    for t, w in enumerate(order.tolist()):
        g, loss = grad_fn(tree_map(lambda v: v[w], views), tree_map(lambda b: b[t], batches))
        alpha = alphas_dev[t]
        x = tree_map(lambda p, gg: p - alpha * gg.to(p.dtype), x, g)
        # the worker immediately reads the fresh state for its next gradient
        tree_map(lambda v, p: v[w].copy_(p), views, x)
        losses.append(loss.detach())
    return AsyncTrace(
        params=x,
        taus=torch.from_numpy(taus).to(dev),
        losses=torch.stack(losses) if losses else torch.zeros((0,), device=dev),
        alphas=alphas_dev,
    )
