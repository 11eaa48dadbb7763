"""Async-as-delay: the delayed-gradient ring (port of
``src/repro/async_engine/delayed.py``, flat and per-leaf rings only).

A ring holds the last ``K`` gradients; each tick pushes the fresh gradient
into slot ``step % K`` and applies the ``W`` gradients delivered by the
simulated workers, worker ``w``'s from ``taus[w]`` steps ago, weighted by
``alpha(tau_w)``.  That preserves every equation of the paper while the whole
tick stays on one device (the reference's design note applies unchanged).

The functions here are the plain versions: functional like the reference
(they return a new ring), exact compositions of push, gather and a weighted
sum taken worker by worker in worker order.  The sum is written as a loop of
elementwise ops rather than a ``tensordot`` so that it is bitwise the same on
a flat ``(K, N)`` ring and on per-leaf rings — that is what keeps the fused
tick bitwise equal to the unfused one inside the port.  The hot path on the
card runs the hand-written tick kernel instead
(:mod:`repro_torch.kernels.adaptive_update.cuda`), which updates the ring in
place.

The sharded ``WorkerRing`` is not ported yet (ROADMAP, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "DelayedGradients",
    "init_delayed",
    "init_flat_delayed",
    "flat_size",
    "ring_dtype_for",
    "staleness_cdf",
    "delayed_combine",
    "slot_live",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class DelayedGradients:
    """Ring buffer of in-flight gradients.

    ring: ``(K, N)`` tensor (flat) or nested dict of ``(K, ...)`` tensors —
          slot ``t % K`` holds the gradient of step t.
    step: int32 0-d tensor on the ring's device — gradients pushed so far.
    """

    ring: Any
    step: torch.Tensor


def ring_dtype_for(params: Any, dtype=None) -> torch.dtype:
    """An explicit ``dtype`` (torch dtype or its name) wins; otherwise all-f32
    trees get f32 rings and anything else the bf16 compression."""
    if dtype is not None:
        return _DTYPES[dtype] if isinstance(dtype, str) else dtype
    leaves = tree_leaves(params)
    if leaves and all(leaf.dtype == torch.float32 for leaf in leaves):
        return torch.float32
    return torch.bfloat16


def flat_size(params: Any) -> int:
    """Total element count of a tree (or of a flat buffer)."""
    return sum(leaf.numel() for leaf in tree_leaves(params))


def _device_of(params: Any) -> torch.device:
    return tree_leaves(params)[0].device


def init_delayed(params: Any, K: int, dtype=None) -> DelayedGradients:
    dtype = ring_dtype_for(params, dtype)
    ring = tree_map(lambda p: torch.zeros((K,) + tuple(p.shape), dtype=dtype, device=p.device), params)
    return DelayedGradients(ring=ring, step=torch.zeros((), dtype=torch.int32, device=_device_of(params)))


def init_flat_delayed(params: Any, K: int, dtype=None) -> DelayedGradients:
    """Flat-resident ring: ONE ``(K, N)`` buffer for the whole gradient tree."""
    dtype = ring_dtype_for(params, dtype)
    device = _device_of(params)
    ring = torch.zeros((K, flat_size(params)), dtype=dtype, device=device)
    return DelayedGradients(ring=ring, step=torch.zeros((), dtype=torch.int32, device=device))


def staleness_cdf(pmf: np.ndarray) -> torch.Tensor:
    """Inverse-CDF sampling table (f32), built in float64 as the reference."""
    p = np.asarray(pmf, dtype=np.float64)
    p = p / p.sum()
    return torch.from_numpy(np.cumsum(p).astype(np.float32))


def slot_live(step: torch.Tensor, taus: torch.Tensor, K: int):
    """``(src_slot, live)`` for one tick: worker ``w`` reads slot
    ``(step - tau_w) mod K`` and is live iff ``step - tau_w >= 0`` and
    ``tau_w < K`` (the paper's drop rule at the ring's depth)."""
    src_step = step - taus
    src_slot = torch.remainder(src_step, K)
    live = ((src_step >= 0) & (taus < K)).to(torch.float32)
    return src_slot, live


def _push(ring: torch.Tensor, g: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    K = ring.shape[0]
    slot = torch.remainder(step, K).reshape(1).long()
    return ring.index_copy(0, slot, g.to(ring.dtype).unsqueeze(0))


def _weighted_sum(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_w w[w] * rows[w]`` in f32, worker by worker."""
    acc = w[0] * rows[0].to(torch.float32)
    for i in range(1, rows.shape[0]):
        acc = acc + w[i] * rows[i].to(torch.float32)
    return acc


def delayed_combine(
    state: DelayedGradients,
    new_grad: Any,
    taus: torch.Tensor,  # (W,) int32
    weights: torch.Tensor,  # (W,) f32 — e.g. alpha(tau_w) / (alpha_c * W)
) -> tuple[Any, torch.Tensor, DelayedGradients]:
    """Push + batched pop + weighted combine: returns the f32 gradient tree

        g = sum_w weights[w] * live[w] * g_{t - taus[w]}

    with ``live``, the (W,) drop mask, and the new ring state (step + 1)."""
    K = tree_leaves(state.ring)[0].shape[0]
    src_slot, live = slot_live(state.step, taus, K)
    w = weights.to(torch.float32) * live
    idx = src_slot.long()
    ring = tree_map(lambda r, g: _push(r, g, state.step), state.ring, new_grad)
    combined = tree_map(lambda r: _weighted_sum(r.index_select(0, idx), w), ring)
    return combined, live, DelayedGradients(ring=ring, step=state.step + 1)
