"""Plain PyTorch RG-LRU recurrence (port of
``src/repro/kernels/rg_lru/ref.py::rg_lru_ref``): a loop over time, as the
reference's ``lax.scan``."""

from __future__ import annotations

import torch

__all__ = ["rg_lru_ref"]

f32 = torch.float32


def rg_lru_ref(log_a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + x_t, h_0 = 0.  (B, S, W) -> (B, S, W) f32."""
    log_a, x_in = log_a.to(f32), x_in.to(f32)
    h = torch.zeros((log_a.shape[0], log_a.shape[2]), dtype=f32, device=log_a.device)
    ys = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + x_in[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)
