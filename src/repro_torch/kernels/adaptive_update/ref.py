"""Plain PyTorch versions of the adaptive_update family (port of
``src/repro/kernels/adaptive_update/ref.py``).

They are the CPU path of every wrapper in :mod:`.cuda` and the oracle the
Hopper kernels are held to on the card.  Op ORDER replicates the link-by-link
pipeline exactly — scalar factors applied one at a time in link order, f32
arithmetic, one final cast — so in f32 the fused step is bit-identical to the
unfused chain inside the port.  All functions are functional: they return new
tensors and leave their inputs alone.
"""

from __future__ import annotations

import torch

from repro_torch.async_engine.delayed import DelayedGradients, delayed_combine

__all__ = [
    "adaptive_update_ref",
    "fused_chain_ref",
    "fused_combine_ref",
    "fused_tick_ref",
    "SCALAR_ORDER",
]

f32 = torch.float32

# Scalar bundle keys per family, in kernel-operand order (as the reference).
SCALAR_ORDER = {
    "sgd": ("f_stale", "f_keep", "f_clip", "m_scale"),
    "momentum": ("f_stale", "f_keep", "f_clip", "m_scale", "mu"),
    "adam": ("f_stale", "f_keep", "f_clip", "m_scale", "b1", "omb1", "b2", "omb2",
             "eps", "c1", "c2"),
}


def adaptive_update_ref(p, g, v, alpha, mu):
    """v' = mu v - alpha g;  p' = p + v'  (elementwise, f32)."""
    v_new = mu * v.to(f32) - alpha * g.to(f32)
    p_new = p.to(f32) + v_new
    return p_new.to(p.dtype), v_new.to(v.dtype)


def fused_chain_ref(kind: str, p, g, bufs, s):
    """One-pass step of a fused chain on flat f32 buffers.

    ``s`` holds the prefix factors ``f_stale``/``f_keep``/``f_clip`` (1.0 when
    the link is absent: multiplying by 1.0 is exact) and the family
    constants; ``bufs`` is ``()`` for sgd, the velocity for momentum and
    ``{"m", "v"}`` for adam.  Returns ``(p_new, bufs_new)``.
    """
    u = g.to(f32)
    u = s["f_stale"] * u
    u = u * s["f_keep"]
    u = u * s["f_clip"]
    if kind == "sgd":
        u = s["m_scale"] * u
        return (p.to(f32) + u).to(p.dtype), bufs
    if kind == "momentum":
        u = s["m_scale"] * u
        v = s["mu"] * bufs + u
        return (p.to(f32) + v).to(p.dtype), v
    if kind == "adam":
        m = s["b1"] * bufs["m"] + s["omb1"] * u
        v = s["b2"] * bufs["v"] + s["omb2"] * torch.square(u)
        out = (m * s["c1"]) / (torch.sqrt(v * s["c2"]) + s["eps"])
        u2 = s["m_scale"] * out
        return (p.to(f32) + u2).to(p.dtype), {"m": m, "v": v}
    raise ValueError(f"unknown fused-chain kind {kind!r}")


def fused_combine_ref(g, ring, step, taus, weights):
    """Ring push + weighted combine on a bare ``(K, N)`` ring:
    ``(g_eff, live, new_ring)``."""
    g_eff, live, new = delayed_combine(DelayedGradients(ring=ring, step=step), g, taus, weights)
    return g_eff, live, new.ring


def fused_tick_ref(kind: str, p, g, bufs, s, ring, step, taus, weights):
    """One whole async tick: the exact composition of the unfused ring ops
    (:func:`~repro_torch.async_engine.delayed.delayed_combine`) and
    :func:`fused_chain_ref`.  Returns ``(p_new, bufs_new, new_ring, live)``."""
    g_eff, live, new_ring = fused_combine_ref(g, ring, step, taus, weights)
    p_new, new_bufs = fused_chain_ref(kind, p, g_eff, bufs, s)
    return p_new, new_bufs, new_ring, live
