"""Attention, global path (port of ``src/repro/models/attention.py``).

:func:`blockwise_attention` follows the reference's online-softmax math
block for block: a loop over query blocks (``lax.map`` there), an inner loop
over KV blocks (``lax.scan``) carrying the running max, sum and accumulator,
and the same guards for fully masked rows.  It is plain PyTorch on purpose —
not ``scaled_dot_product_attention`` — so its numbers stay comparable with
the reference's.  The sliding-window (banded) path, decode against a KV cache
and the Pallas flash kernel (``use_pallas``) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import LayerIO, Params, apply_rope, truncated_normal

NEG_INF = -2.0e38
f32 = torch.float32


def init_attention(gen, cfg, device) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {
        "wq": truncated_normal(gen, (d, hq, hd), s, device),
        "wk": truncated_normal(gen, (d, hkv, hd), s, device),
        "wv": truncated_normal(gen, (d, hkv, hd), s, device),
        "wo": truncated_normal(gen, (hq, hd, d), 1.0 / np.sqrt(hq * hd), device),
    }


def _block_attend(q, k, qpos, kpos, *, causal, window, softcap):
    """Scores of one query block against one KV block, masked.

    q: (B, Qb, Nkv, G, H); k: (B, Kb, Nkv, H) -> scores (B, Nkv, G, Qb, Kb).
    """
    scores = torch.einsum("bqngh,bknh->bngqk", q.to(f32), k.to(f32))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    dpos = qpos[:, None, None, :, None] - kpos[:, None, None, None, :]
    valid = kpos[:, None, None, None, :] >= 0
    if causal:
        valid = valid & (dpos >= 0)
    if window is not None:
        valid = valid & (dpos < window)
    return torch.where(valid, scores, NEG_INF)


def _online_softmax_step(carry, scores, v):
    m_prev, l_prev, acc_prev = carry
    m_cur = torch.amax(scores, dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(scores <= NEG_INF / 2, 0.0, p)
    corr = torch.exp(torch.where(m_prev <= NEG_INF / 2, NEG_INF, m_prev) - m_safe)
    corr = torch.where(m_prev <= NEG_INF / 2, 0.0, corr)
    l_new = l_prev * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bngqk,bknh->bqngh", p, v.to(f32))
    acc_new = acc_prev * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def blockwise_attention(
    q: torch.Tensor,  # (B, S, Nq, H)
    k: torch.Tensor,  # (B, T, Nkv, H)
    v: torch.Tensor,
    qpos: torch.Tensor,  # (B, S)
    kpos: torch.Tensor,  # (B, T)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    if window is not None:
        raise NotImplementedError("the banded sliding-window path is not ported yet")
    B, S, Nq, H = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    q = q.reshape(B, S, Nkv, G, H)
    bq, bk = min(block_q, S), min(block_k, T)
    pad_q, pad_k = (-S) % bq, (-T) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        qpos = torch.nn.functional.pad(qpos, (0, pad_q), value=-(10**9))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = torch.nn.functional.pad(kpos, (0, pad_k), value=-1)
    outs = []
    for qs in range(0, S + pad_q, bq):
        qblk, qposblk = q[:, qs:qs + bq], qpos[:, qs:qs + bq]
        carry = (
            torch.full((B, Nkv, G, bq), NEG_INF, dtype=f32, device=q.device),
            torch.zeros((B, Nkv, G, bq), dtype=f32, device=q.device),
            torch.zeros((B, bq, Nkv, G, H), dtype=f32, device=q.device),
        )
        for ks in range(0, T + pad_k, bk):
            scores = _block_attend(qblk, k[:, ks:ks + bk], qposblk, kpos[:, ks:ks + bk],
                                   causal=causal, window=window, softcap=softcap)
            carry = _online_softmax_step(carry, scores, v[:, ks:ks + bk])
        _, l, acc = carry
        l = torch.clamp(l, min=1e-30)
        outs.append(acc / l.permute(0, 3, 1, 2)[..., None])
    out = torch.cat(outs, dim=1)[:, :S].reshape(B, S, Nq, H)
    return out.to(v.dtype)


def attention_layer(p: Params, x: torch.Tensor, io: LayerIO, cfg, *, window: int | None,
                    use_rope: bool = True) -> torch.Tensor:
    """Projections + rope + blockwise attention + output projection."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas: the flash-attention kernel is not ported yet (ROADMAP, Queue 2)"
        )
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("btd,dnh->btnh", x, p["wk"].to(dt))
    v = torch.einsum("btd,dnh->btnh", x, p["wv"].to(dt))
    if use_rope:
        q = apply_rope(q, io.positions, cfg.rope_theta)
        k = apply_rope(k, io.positions, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim**-0.5
    q = q * torch.tensor(scale, dtype=dt)
    out = blockwise_attention(
        q, k, v, io.positions, io.positions,
        causal=io.causal, window=window, softcap=cfg.attn_logit_softcap,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
    )
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(dt))
