"""Plain PyTorch flash attention (port of
``src/repro/kernels/flash_attention/ref.py::attention_ref``).

The full-matrix oracle: it materializes the ``(S, T)`` score matrix of every
head, so it is for the CPU path and for holding the kernel to on the card,
not for long sequences.  Same semantics as the kernel: contiguous positions,
causal / window / softcap masking, GQA by head grouping, f32 softmax, the
output in ``v``'s dtype.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]

f32 = torch.float32


def attention_ref(
    q: torch.Tensor,  # (B, S, Nq, H)
    k: torch.Tensor,  # (B, T, Nkv, H)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    B, S, Nq, H = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    scale = H**-0.5 if scale is None else scale

    qg = q.reshape(B, S, Nkv, G, H).to(f32) * scale
    s = torch.einsum("bsngh,btnh->bngst", qg, k.to(f32))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    valid = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & ((qpos - kpos) < window)
    s = torch.where(valid, s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bngst,btnh->bsngh", p / l, v.to(f32))
    return out.reshape(B, S, Nq, H).to(v.dtype)
