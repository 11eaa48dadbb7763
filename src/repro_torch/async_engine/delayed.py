"""Async-as-delay: the delayed-gradient rings (port of
``src/repro/async_engine/delayed.py``).

A ring holds the last ``K`` gradients; each tick pushes the fresh gradient
into slot ``step % K`` and applies the ``W`` gradients delivered by the
simulated workers, worker ``w``'s from ``taus[w]`` steps ago, weighted by
``alpha(tau_w)``.  That preserves every equation of the paper while the whole
tick stays on one device (the reference's design note applies unchanged).

The functions here are the plain versions: exact compositions of push,
gather and a weighted sum taken worker by worker in worker order.  The sum is
written as a loop of elementwise ops rather than a ``tensordot`` so that it
is bitwise the same on a flat ``(K, N)`` ring and on per-leaf rings — that is
what keeps the fused tick bitwise equal to the unfused one inside the port.
The push writes into the ring IN PLACE (a full-width ring does not fit twice
on one card), and each worker's row is read by its own index (a device
tensor: no host sync) and multiplied in f32, without a gathered ``(W, N)``
copy or an f32 copy of the row.  The hot path on the card runs the
hand-written tick kernel instead
(:mod:`repro_torch.kernels.adaptive_update.cuda`).

:class:`WorkerRing` is the sharded engine's form: one ring per simulated
worker, ``(W_local, K, ...)``, every worker's slot ``step % K`` receiving the
same push; :func:`worker_ring_combine` reads worker ``w``'s own row and, with
a process group, sums the partial combines of all ranks (``all_reduce``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "DelayedGradients",
    "WorkerRing",
    "init_delayed",
    "init_flat_delayed",
    "init_worker_ring",
    "init_flat_worker_ring",
    "flat_size",
    "ring_dtype_for",
    "staleness_cdf",
    "sample_tau",
    "delayed_apply",
    "delayed_apply_batch",
    "delayed_combine",
    "worker_ring_combine",
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


def sample_tau(u: torch.Tensor | torch.Generator, cdf: torch.Tensor) -> torch.Tensor:
    """Draw one tau ~ the fitted staleness model by inverse CDF (int32 0-d).
    ``u`` is the uniform itself (a test hands in the reference's draw) or a
    generator to draw it from on ``cdf``'s device."""
    if isinstance(u, torch.Generator):
        u = torch.rand((), generator=u, device=cdf.device)
    return torch.searchsorted(cdf, torch.as_tensor(u, device=cdf.device).to(cdf.dtype).reshape(1),
                              out_int32=True)[0]


def delayed_apply(state: DelayedGradients, new_grad: Any, tau: torch.Tensor):
    """Push ``new_grad``; pop the gradient from ``tau`` steps ago.

    Returns ``(delayed_grad, live, new_state)``: ``live`` is 0.0 while the
    requested slot predates the run or ``tau`` reaches the ring's depth (the
    caller scales the step by it), and ``new_state`` holds the same ring
    tensors, pushed in place, and ``step + 1``."""
    delayed, live, new_state = delayed_apply_batch(state, new_grad, torch.as_tensor(tau).reshape(1))
    return tree_map(lambda d: d[0], delayed), live[0], new_state


def delayed_apply_batch(state: DelayedGradients, new_grad: Any, taus: torch.Tensor):
    """Push ``new_grad``; pop the ``W`` gradients from ``taus`` steps ago.

    The vectorized :func:`delayed_apply`: every leaf of ``delayed`` carries a
    leading ``(W,)`` axis (a gather over ring slots, in the ring's dtype) and
    ``live`` is the ``(W,)`` drop mask."""
    K = tree_leaves(state.ring)[0].shape[0]
    src_slot, live = slot_live(state.step, taus, K)
    ring = tree_map(lambda r, g: _push(r, g, state.step), state.ring, new_grad)
    idx = src_slot.long()
    delayed = tree_map(lambda r: r.index_select(0, idx), ring)
    return delayed, live, DelayedGradients(ring=ring, step=state.step + 1)


def slot_live(step: torch.Tensor, taus: torch.Tensor, K: int):
    """``(src_slot, live)`` for one tick: worker ``w`` reads slot
    ``(step - tau_w) mod K`` and is live iff ``step - tau_w >= 0`` and
    ``tau_w < K`` (the paper's drop rule at the ring's depth)."""
    src_step = step - taus
    src_slot = torch.remainder(src_step, K)
    live = ((src_step >= 0) & (taus < K)).to(torch.float32)
    return src_slot, live


def _push(ring: torch.Tensor, g: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Write ``g`` into slot ``step % K`` of ``ring`` (in place; returns it)."""
    K = ring.shape[0]
    slot = torch.remainder(step, K).reshape(1).long()
    return ring.index_copy_(0, slot, g.to(ring.dtype).unsqueeze(0))


def _weighted_sum(row: Callable[[int], torch.Tensor], w: torch.Tensor, count: int) -> torch.Tensor:
    """``sum_i w[i] * row(i)`` in f32, worker by worker.  ``row(i)`` is worker
    ``i``'s ring row read by index (shape ``(1, ...)``, the ring's dtype);
    ``w[i:i + 1]`` is a 1-element f32 tensor, so each product is taken in
    f32 with the bf16 row widened inside the multiply."""
    acc = w[0:1] * row(0)
    for i in range(1, count):
        acc += w[i:i + 1] * row(i)
    return acc.squeeze(0)


def delayed_combine(
    state: DelayedGradients,
    new_grad: Any,
    taus: torch.Tensor,  # (W,) int32
    weights: torch.Tensor,  # (W,) f32 — e.g. alpha(tau_w) / (alpha_c * W)
) -> tuple[Any, torch.Tensor, DelayedGradients]:
    """Push + batched pop + weighted combine: returns the f32 gradient tree

        g = sum_w weights[w] * live[w] * g_{t - taus[w]}

    with ``live``, the (W,) drop mask, and the ring state (the same ring
    tensors, pushed in place, and step + 1)."""
    K = tree_leaves(state.ring)[0].shape[0]
    src_slot, live = slot_live(state.step, taus, K)
    w = weights.to(torch.float32) * live
    idx = src_slot.long()
    W = taus.shape[0]
    ring = tree_map(lambda r, g: _push(r, g, state.step), state.ring, new_grad)
    combined = tree_map(lambda r: _weighted_sum(lambda i: r.index_select(0, idx[i:i + 1]), w, W),
                        ring)
    return combined, live, DelayedGradients(ring=ring, step=state.step + 1)


# ---------------------------------------------------------------------------
# Per-worker rings: the sharded engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerRing:
    """Per-worker delayed-gradient rings (sharded async engine).

    ring: ``(W_local, K, N)`` tensor (flat) or nested dict of
          ``(W_local, K, ...)`` tensors — this rank's workers only; worker
          ``w``'s slot ``t % K`` holds the gradient of step ``t``.
    step: int32 0-d tensor, the same on every rank — one push per tick.
    """

    ring: Any
    step: torch.Tensor


def init_worker_ring(params: Any, K: int, W: int, dtype=None) -> WorkerRing:
    """Per-leaf rings of ``W`` workers (``W`` is this rank's worker count)."""
    dtype = ring_dtype_for(params, dtype)
    ring = tree_map(
        lambda p: torch.zeros((W, K) + tuple(p.shape), dtype=dtype, device=p.device), params)
    return WorkerRing(ring=ring, step=torch.zeros((), dtype=torch.int32, device=_device_of(params)))


def init_flat_worker_ring(params: Any, K: int, W: int, dtype=None) -> WorkerRing:
    """The ``W`` workers' rings as ONE ``(W, K, N)`` buffer."""
    dtype = ring_dtype_for(params, dtype)
    device = _device_of(params)
    ring = torch.zeros((W, K, flat_size(params)), dtype=dtype, device=device)
    return WorkerRing(ring=ring, step=torch.zeros((), dtype=torch.int32, device=device))


def worker_ring_combine(
    ring: Any,  # (W_local, K, ...) tensor or tree of them
    step: torch.Tensor,
    new_grad: Any,
    taus: torch.Tensor,  # (W_local,) int32
    weights: torch.Tensor,  # (W_local,) f32
    *,
    group=None,
) -> tuple[Any, torch.Tensor, Any]:
    """One tick over this rank's worker rings: push ``new_grad`` into every
    local worker's slot ``step % K`` (in place), pop worker ``w``'s gradient
    from ``taus[w]`` steps ago and return the f32 weighted sum

        g = sum_w weights[w] * live[w] * g_{t - taus[w]}

    summed over the ranks of ``group`` (``all_reduce``) when one is given, so
    every rank leaves with the same ``g``.  Returns ``(g, live, ring)``.  On
    one process this is bitwise :func:`delayed_combine` with the same taus:
    every worker's ring holds the same pushes, and the sum runs in the same
    order with the same ops."""
    K = tree_leaves(ring)[0].shape[1]
    src_slot, live = slot_live(step, taus, K)
    w = weights.to(torch.float32) * live
    idx = src_slot.long()
    Wl = taus.shape[0]
    slot = torch.remainder(step, K).reshape(1).long()

    def push(r, g):
        r.index_copy_(1, slot, g.to(r.dtype).unsqueeze(0).unsqueeze(0).expand(
            (Wl, 1) + tuple(g.shape)))
        return r

    def combine(r):
        partial = _weighted_sum(lambda i: r[i].index_select(0, idx[i:i + 1]), w, Wl)
        if group is not None:
            torch.distributed.all_reduce(partial, group=group)
        return partial

    ring = tree_map(push, ring, new_grad)
    return tree_map(combine, ring), live, ring
