"""Plain PyTorch selective scan (port of
``src/repro/kernels/selective_scan/ref.py::selective_scan_ref``, plus the
final state): a loop over time, as the reference's ``lax.scan``.

Each step forms ``exp(delta_t A)`` for that step alone, so the (B, S, D, N)
tensors the reference's oracle builds are never materialised; at full width
they would take 8.6 GB each.
"""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref"]

f32 = torch.float32


def selective_scan_ref(u, delta, A, Bm, Cm, dtype=f32):
    """u/delta: (B, S, D); A: (D, N); Bm/Cm: (B, S, N), from h_0 = 0.

    Returns ``y`` (B, S, D) (no d_skip, as the kernel) and the final state
    ``hT`` (B, D, N), computed in ``dtype``: f32, as the kernel, or f64 for
    a witness of the f32 rounding.
    """
    u, delta, A, Bm, Cm = (t.to(dtype) for t in (u, delta, A, Bm, Cm))
    B, S, D = u.shape
    h = torch.zeros((B, D, A.shape[1]), dtype=dtype, device=u.device)
    y = torch.empty((B, S, D), dtype=dtype, device=u.device)
    for t in range(S):
        dt = delta[:, t, :, None]
        h = torch.exp(dt * A) * h + dt * Bm[:, t, None, :] * u[:, t, :, None]
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cm[:, t])
    return y, h
