"""Mixture-of-Experts layer, qwen2-moe / qwen3-moe style (port of
``src/repro/models/moe.py``, its single-device path).

* **Routing**: an f32 router, padded experts pushed to -1e30, softmax, top-k
  renormalised and cast to the activation dtype; a Switch-style
  load-balance loss.
* **Slot assignment**: capacity ``C = capacity_for(...)`` per expert; each
  (token, choice) gets its position in its expert's queue from a stable sort
  over expert ids, earlier (token-major) entries first.  Entries past ``C``
  are dropped.
* **Dispatch / combine**: K scatters of the tokens into an ``(E·C + 1, D)``
  buffer whose last row takes every dropped entry (a trash row), the expert
  FFN as batched products over the ``(E, C, D)`` view, and K gathers back,
  weighted.  Every size is a Python int, so nothing here waits for the
  device: no boolean-mask indexing, no ``nonzero``, no 0-d tensor index.
* **Shared expert** (qwen2-moe): a gated MLP on every token, scaled by a
  sigmoid gate, added to the routed output.

The reference's ``shard_map`` branches (experts over a ``model`` mesh axis,
and its weights-stationary variant) are not ported: they need a mesh of
several devices, and the port runs on one card.  The expert products are
plain matrix products in the reference too (outside any Pallas kernel), so
``torch.bmm`` is their counterpart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.layers import Params, _act, truncated_normal

__all__ = ["init_moe", "capacity_for", "route", "apply_moe"]

f32 = torch.float32


def init_moe(gen, cfg, device) -> Params:
    d, e, fe = cfg.d_model, cfg.experts_padded, cfg.d_ff_expert
    s = 1.0 / np.sqrt(d)
    p: Params = {
        "router": truncated_normal(gen, (d, e), s, device),
        "w_gate_e": truncated_normal(gen, (e, d, fe), s, device),
        "w_up_e": truncated_normal(gen, (e, d, fe), s, device),
        "w_down_e": truncated_normal(gen, (e, fe, d), 1.0 / np.sqrt(fe), device),
    }
    if cfg.shared_expert_ff:
        fs = cfg.shared_expert_ff
        p["shared"] = {
            "w_gate": truncated_normal(gen, (d, fs), s, device),
            "w_up": truncated_normal(gen, (d, fs), s, device),
            "w_down": truncated_normal(gen, (fs, d), 1.0 / np.sqrt(fs), device),
            "gate_proj": truncated_normal(gen, (d, 1), s, device),
        }
    return p


def capacity_for(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: ``ceil(top_k·tokens·cf / E)`` rounded up to a
    multiple of 4, at least 4 (the reference's float expression, so the same
    int)."""
    cap = math.ceil(top_k * tokens * capacity_factor / num_experts)
    return max(-(-cap // 4) * 4, 4)


def _slot_assignment(topk_idx: torch.Tensor, num_experts: int):
    """Position of each (token, choice) within its expert's queue.

    topk_idx: (T, K) int -> (pos (T, K), counts (E,)).  Earlier (token-major)
    entries win slots, the usual Switch priority rule.
    """
    T, K = topk_idx.shape
    flat = topk_idx.reshape(T * K)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(T * K, device=flat.device) - starts[sorted_e]
    pos = torch.empty_like(ranks).scatter_(0, order, ranks)
    return pos.reshape(T, K), counts


def route(xt: torch.Tensor, p: Params, cfg):
    """The f32 router: xt (T, D) -> (probs (T, E) f32, top-k probabilities
    (T, K) renormalised in f32 and cast to xt's dtype, top-k expert ids
    (T, K))."""
    E, n = cfg.experts_padded, cfg.num_experts
    logits = xt.to(f32) @ p["router"].to(f32)
    if E != n:
        ids = torch.arange(E, device=xt.device)
        logits = logits + torch.where(ids >= n, -1e30, 0.0).to(f32)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    topk_p = (topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)).to(xt.dtype)
    return probs, topk_p, topk_idx


def _expert_ffn(xin: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    """xin: (E, C, D) -> (E, C, D) through the (E, D, F) / (E, F, D) stacks,
    cast to xin's dtype."""
    dt = xin.dtype
    gate = torch.bmm(xin, p["w_gate_e"].to(dt))
    up = torch.bmm(xin, p["w_up_e"].to(dt))
    return torch.bmm(_act(act, gate) * up, p["w_down_e"].to(dt))


def _routed_local(xt: torch.Tensor, p: Params, cfg, C: int):
    """Dispatch -> expert FFN -> weighted combine over all E experts.
    xt: (T, D) -> (out (T, D), aux f32 scalar)."""
    dt = xt.dtype
    T, D = xt.shape
    E, K, n = cfg.experts_padded, cfg.top_k, cfg.num_experts

    probs, topk_p, topk_idx = route(xt, p, cfg)
    pos, counts = _slot_assignment(topk_idx, E)
    keep = pos < C
    dest = torch.where(keep, topk_idx * C + pos, E * C)  # dropped -> the trash row

    buf = torch.zeros((E * C + 1, D), dtype=dt, device=xt.device)
    for kk in range(K):  # K scatters, each to distinct rows but the trash row
        buf = buf.index_copy(0, dest[:, kk], xt)
    eout = _expert_ffn(buf[:E * C].reshape(E, C, D), p, cfg.act).reshape(E * C, D)
    eout = torch.cat([eout, torch.zeros((1, D), dtype=dt, device=xt.device)], dim=0)

    out = torch.zeros((T, D), dtype=dt, device=xt.device)
    for kk in range(K):
        w = torch.where(keep[:, kk], topk_p[:, kk], 0.0)[:, None]
        out = out + w * eout.index_select(0, dest[:, kk])

    # Switch-style load-balance loss: fraction routed x mean router prob
    me = counts[:n].to(f32) / (T * K)
    pe = torch.mean(probs, dim=0)[:n]
    aux = (n * n * torch.sum(me * pe) / K).to(f32)
    return out, aux


def apply_moe(p: Params, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    C = capacity_for(B * S, cfg.experts_padded, cfg.top_k, cfg.capacity_factor)
    out, aux = _routed_local(x.reshape(B * S, D), p, cfg, C)
    out = out.reshape(B, S, D)
    if "shared" in p:
        dt = x.dtype
        sp = p["shared"]
        g = _act(cfg.act, x @ sp["w_gate"].to(dt))
        u = x @ sp["w_up"].to(dt)
        sh = (g * u) @ sp["w_down"].to(dt)
        sgate = torch.sigmoid(x @ sp["gate_proj"].to(dt))
        out = out + sgate * sh
    return out, aux
