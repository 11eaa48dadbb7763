"""Attention: blockwise prefill/train path, cached decode, KV caches (port
of ``src/repro/models/attention.py``).

:func:`blockwise_attention` follows the reference's online-softmax math
block for block: a loop over query blocks (``lax.map`` there), an inner loop
over KV blocks (``lax.scan``) carrying the running max, sum and accumulator,
and the same guards for fully masked rows.  With a window and
``T > window + block_q`` it takes the banded path, where each query block
gathers only a KV band of ``window + block_q`` positions.  It is plain
PyTorch on purpose — not ``scaled_dot_product_attention`` — so its numbers
stay comparable with the reference's.  :func:`decode_attention` attends one
token against a full or ring KV cache.

Under ``cfg.use_pallas`` the attention of a self-attention layer runs the
hand-written flash kernel (:mod:`repro_torch.kernels.flash_attention`; the
plain version on a CPU tensor), as the reference runs its Pallas kernel.
Cross-attention (``kv_source``: whisper's decoder attending to the encoder
memory) takes no RoPE, key positions ``0..T-1`` and no causal mask, and runs
the plain path, as in the reference.

The cache writers update the cache IN PLACE (the reference returns a new
one): a full-width decode would otherwise copy every layer's cache each step.

Under a running ``model`` axis an attention layer whose params are this
rank's head blocks runs Megatron-style (:func:`attention_layer_kv`): the
rank's ``Nq / model`` query heads and the kv heads they use
(:func:`local_kv_heads`), one all-reduce after ``wo``; its decode cache
holds those kv heads only.  Cross-attention (plain MHA) takes the rank's
heads of ``wk`` / ``wv`` too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.flash_attention.cuda import flash_attention
from repro_torch.models.layers import LayerIO, Params, apply_rope, truncated_normal
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import SPEC_OPTIONS, capacity_split

NEG_INF = -2.0e38
f32 = torch.float32


def init_attention(gen, cfg, device, *, cross: bool = False) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cross:
        hkv = hq  # whisper's cross-attention (and encoder) is plain MHA
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
    B, S, Nq, H = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    q = q.reshape(B, S, Nkv, G, H)
    bq, bk = min(block_q, S), min(block_k, T)
    pad_q, pad_k = (-S) % bq, (-T) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        qpos = torch.nn.functional.pad(qpos, (0, pad_q), value=-(10**9))
    if window is not None and T > window + bq:
        out = _banded_attention(q, k, v, qpos, kpos, bq, window, softcap, causal)
        return out[:, :S].reshape(B, S, Nq, H).to(v.dtype)
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


def _softmax_pv(scores, v):
    """One-shot masked softmax of ``scores`` (B, Nkv, G, Qb, Kb) against
    ``v`` (B, Kb, Nkv, H), with the reference's guards -> (B, Qb, Nkv, G, H)."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m)
    p = torch.where(scores <= NEG_INF / 2, 0.0, p)
    l = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    pv = torch.einsum("bngqk,bknh->bqngh", p, v.to(f32))
    return pv / l.permute(0, 3, 1, 2)[..., None]


def _banded_attention(q, k, v, qpos, kpos, bq, window, softcap, causal):
    """Sliding-window path: each query block gathers a KV band of width
    ``window + bq`` — O(S·W) instead of O(S·T).  q: (B, Spad, Nkv, G, H)."""
    B, Spad, Nkv, G, H = q.shape
    T = k.shape[1]
    band = window + bq
    width = min(band, T)
    outs = []
    for qs in range(0, Spad, bq):
        start = min(max(qs + bq - band, 0), max(T - band, 0))
        scores = _block_attend(q[:, qs:qs + bq], k[:, start:start + width], qpos[:, qs:qs + bq],
                               kpos[:, start:start + width],
                               causal=causal, window=window, softcap=softcap)
        outs.append(_softmax_pv(scores, v[:, start:start + width]))
    return torch.cat(outs, dim=1).reshape(B, Spad, Nkv * G, H)


# ---------------------------------------------------------------------------
# A rank's block of a cache's slots (SPEC_OPTIONS["seq_shard_cache"])
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotBlock:
    """A rank's block of a KV cache's capacity: the slots ``[start, start +
    size)`` of the one-process cache's ``whole``, split over the layout's
    ``axes`` (``("model",)``: the kv heads do not split over ``model``, so
    the rank holds every kv head; or the batch axes: a batch of one row,
    the same on every data rank, with the rank's kv heads), as
    :func:`~repro_torch.sharding.specs.capacity_split` lays the leaf out.
    ``mesh`` is the running layout whose groups combine the ranks'
    partial softmaxes."""

    whole: int
    start: int
    size: int
    axes: tuple[str, ...]
    mesh: Any

    @property
    def every_kv_head(self) -> bool:
        """The capacity is split over ``model`` (the reference's branch for
        kv heads that do not split): the rank's cache holds every kv head,
        and a decode step attends with every query head."""
        return self.axes == ("model",)


def cache_block(capacity: int | None, nkv: int, hd: int, *, window: int | None = None,
                memory: bool = False) -> SlotBlock | None:
    """This rank's block of the slots of a ``k`` / ``v`` cache of
    ``capacity`` slots (``min(window, capacity)`` with a ``window``: a
    local layer's ring) over ``nkv`` kv heads of ``hd`` (the whole counts,
    as the one-process leaf has them), or None where the rank holds every
    slot.  ``capacity`` None (a decode step) reads the cache's positions
    from the :func:`~repro_torch.sharding.collectives.serving` shape (or
    with ``memory`` the encoder frames of whisper's cross K/V).  The
    layout is the reference's ``cache_spec_for`` of the whole leaf
    (:func:`~repro_torch.sharding.specs.capacity_split`), which reads the
    global batch of the serving shape; without a running sharded mesh, or
    with ``seq_shard_cache`` off, every slot is the rank's."""
    mesh = C.sharded_mesh()
    if mesh is None:
        return None
    shape = C.serve_shape()
    if shape is None:
        if SPEC_OPTIONS["seq_shard_cache"]:
            raise ValueError("a decode cache under seq_shard_cache and a running sharded mesh is "
                             "laid out by the global batch and the capacity: build and step it "
                             "inside collectives.serving(batch, capacity) (launch.serve.serve "
                             "does)")
        return None
    if capacity is None:
        capacity = shape.memory if memory else shape.capacity
    if window is not None:
        capacity = min(window, capacity)
    split = capacity_split((shape.batch, capacity, nkv, hd), mesh, shape.batch)
    if split is None:
        return None
    axes, index, n = split
    size = capacity // n
    return SlotBlock(capacity, index * size, size, axes, mesh)


def _slots(capacity: int, device, block: SlotBlock | None) -> torch.Tensor:
    """The one-process slot numbers the cache holds: every slot, or the
    rank's block."""
    if block is None:
        return torch.arange(capacity, device=device)
    return torch.arange(block.start, block.start + block.size, device=device)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,  # (B, 1, Nq, H)
    k_cache: torch.Tensor,  # (B, C, Nkv, H)
    v_cache: torch.Tensor,
    cache_positions: torch.Tensor,  # (B, C) absolute positions; -1 = empty slot
    qpos: torch.Tensor,  # (B, 1)
    *,
    window: int | None = None,
    softcap: float | None = None,
    block: SlotBlock | None = None,
) -> torch.Tensor:
    """One token against a cache.  With ``block`` the cache is the rank's
    block of the slots, and the softmax is combined over ``block.axes``
    (:func:`_combined_softmax_pv`)."""
    B, _, Nq, H = q.shape
    Nkv = k_cache.shape[2]
    qg = q.reshape(B, 1, Nkv, Nq // Nkv, H)
    scores = _block_attend(qg, k_cache, qpos, cache_positions,
                           causal=True, window=window, softcap=softcap)
    out = _softmax_pv(scores, v_cache) if block is None else \
        _combined_softmax_pv(scores, v_cache, block)
    return out.reshape(B, 1, Nq, H).to(v_cache.dtype)


def _combined_softmax_pv(scores, v, block: SlotBlock):
    """:func:`_softmax_pv` over the slots of every rank of ``block.axes``,
    each holding ``scores`` (B, Nkv, G, 1, Kb) of its own slots.  The row
    maximum is max-reduced over the axes first, so every rank's
    exponentials are one process's ``exp(s - m)``, with the same guards (a
    rank whose slots are all empty or outside the band contributes zeros);
    then each rank's row sum and weighted values, in f32, are summed over
    the axes in one all-reduce and divided once, with the same clamp."""
    m = C.max_over(torch.amax(scores, dim=-1, keepdim=True), block.mesh, block.axes,
                   "kv_combine")
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m)
    p = torch.where(scores <= NEG_INF / 2, 0.0, p)
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bngqk,bknh->bqngh", p, v.to(f32))
    both = C.sum_over(torch.cat([pv, l.permute(0, 3, 1, 2)[..., None]], dim=-1), block.mesh,
                      block.axes, "kv_combine")
    return both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)


def decode_heads(q, k_cache, v_cache, cache_positions, qpos, *, window, softcap,
                 block: SlotBlock | None, mesh) -> torch.Tensor:
    """:func:`decode_attention` of the rank's query heads ``q`` (B, 1, Nq_r,
    H).  Where the rank's cache holds every kv head for its block of the
    slots (:attr:`SlotBlock.every_kv_head`) and the query heads are split
    over ``model`` (``mesh``, :func:`head_mesh`), every rank attends with
    every query head under the whole GQA grouping (query head j to kv head
    j // (Nq / Nkv)): the heads are gathered over ``model`` first
    (``kv_gather``), and after the combine the rank keeps its own."""
    gather = block is not None and block.every_kv_head and mesh is not None
    if gather:
        q = C.gather_over_model(q, mesh, "kv_gather", dim=-2)
    out = decode_attention(q, k_cache, v_cache, cache_positions, qpos, window=window,
                           softcap=softcap, block=block)
    if gather:
        n = out.shape[2] // mesh.shape["model"]
        out = out.narrow(2, mesh.index("model") * n, n)
    return out


# ---------------------------------------------------------------------------
# KV cache helpers (full + ring)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, capacity: int, nkv: int, hd: int, dtype, device) -> Params:
    return {
        "k": torch.zeros((batch, capacity, nkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, nkv, hd), dtype=dtype, device=device),
    }


def cache_positions_full(capacity: int, length: torch.Tensor, batch: int,
                         block: SlotBlock | None = None) -> torch.Tensor:
    """Positions of slots [0..capacity) when ``length`` tokens are stored
    (with ``block``, of the rank's slots)."""
    slots = _slots(capacity, length.device, block)
    pos = torch.where(slots < length, slots, -1)
    return pos[None, :].expand(batch, slots.shape[0])


def cache_positions_ring(capacity: int, length: torch.Tensor, batch: int,
                         block: SlotBlock | None = None) -> torch.Tensor:
    """Ring buffer: slot j holds absolute position p ≡ j (mod capacity),
    the largest such p < length; empty slots report -1 (with ``block``,
    of the rank's slots)."""
    slots = _slots(capacity, length.device, block)
    p = length - 1 - torch.remainder(length - 1 - slots, capacity)
    pos = torch.where((p >= 0) & (length > 0), p, -1)
    return pos[None, :].expand(batch, slots.shape[0])


def update_cache_full(cache: Params, k_new, v_new, pos: torch.Tensor,
                      block: SlotBlock | None = None) -> Params:
    """Write one token at absolute position ``pos`` (0-d int tensor), in
    place.  With ``block`` only the rank that holds slot ``pos`` writes it:
    every rank writes its slot nearest ``pos`` with the new token where it
    owns ``pos`` and with the slot's own value elsewhere (on the device,
    so ``pos`` is never read on the host)."""
    if block is None:
        slot = pos.reshape(1)
        cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
        return cache
    local = pos.reshape(1) - block.start
    owns = (local >= 0) & (local < block.size)
    local = torch.clamp(local, 0, block.size - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        c.index_copy_(1, local, torch.where(owns, new.to(c.dtype), c.index_select(1, local)))
    return cache


def update_cache_ring(cache: Params, k_new, v_new, pos: torch.Tensor,
                      block: SlotBlock | None = None) -> Params:
    whole = cache["k"].shape[1] if block is None else block.whole
    return update_cache_full(cache, k_new, v_new, torch.remainder(pos, whole), block)


def fill_cache_from_prefill(k, v, capacity: int, ring: bool,
                            block: SlotBlock | None = None) -> Params:
    """Build a decode cache from prefill K/V of length S (with ``block``,
    the rank's slots alone: the whole cache is never built)."""
    B, S = k.shape[0], k.shape[1]
    if not ring and capacity < S:
        raise ValueError(f"cache capacity {capacity} < prefill length {S}")
    start, size = (0, capacity) if block is None else (block.start, block.size)
    # a full cache holds position p at slot p, a ring the last `capacity`
    # positions at slot p % capacity
    n = min(S, capacity)
    pos = torch.arange(S - n, S)
    slots = pos % capacity
    keep = (slots >= start) & (slots < start + size)
    at, src = (slots[keep] - start).to(k.device), pos[keep].to(k.device)
    out = {}
    for name, t in (("k", k), ("v", v)):
        c = torch.zeros((B, size) + tuple(t.shape[2:]), dtype=t.dtype, device=t.device)
        c[:, at] = t[:, src]
        out[name] = c
    return out


# ---------------------------------------------------------------------------
# Full attention layer (projections + rope + mix)
# ---------------------------------------------------------------------------

def head_mesh(cfg):
    """The running mesh when the layout splits the query heads over
    ``model`` (:func:`~repro_torch.sharding.collectives.layout_mesh`), else
    None."""
    return C.layout_mesh("wq", (cfg.d_model, cfg.num_heads, cfg.head_dim))


def local_kv_heads(cfg, mesh) -> tuple[int, int, bool]:
    """``(first, count, sharded)``: the kv heads this rank's query heads use.

    When ``model`` divides the kv heads they are sharded like the query
    heads.  Otherwise ``wk`` / ``wv`` replicate (the reference's spec) and
    each rank takes the kv heads its query heads map to under GQA (query
    head ``j`` to kv head ``j // (Nq / Nkv)``), which must be the same
    number for every one of its kv heads."""
    n = mesh.shape["model"]
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    if nkv % n == 0:
        return mesh.index("model") * (nkv // n), nkv // n, True
    g, q_loc = nq // nkv, nq // n
    if q_loc % g and g % q_loc:
        raise ValueError(f"{nq} query heads over {nkv} kv heads do not split over model {n}: "
                         "a rank's query heads would share kv heads unevenly")
    first = mesh.index("model") * q_loc // g
    return first, max(q_loc // g, 1), False


def _kv_weights(p: Params, cfg, mesh):
    """``wk`` / ``wv`` as this rank's kv heads use them (see
    :func:`local_kv_heads`).  Replicated weights are sliced; their gradient
    is summed over ``model``, since each rank's slice feeds its own heads."""
    if mesh is None:
        return p["wk"], p["wv"]
    first, count, sharded = local_kv_heads(cfg, mesh)
    if sharded:
        return p["wk"], p["wv"]
    return tuple(C.copy_to_model(p[w], mesh).narrow(1, first, count) for w in ("wk", "wv"))


def attention_layer_kv(p: Params, x: torch.Tensor, io: LayerIO, cfg, *, window: int | None,
                       kv_source: torch.Tensor | None = None, use_rope: bool = True, seq=None,
                       every_kv_head: bool = False):
    """Projections + rope + attention + output projection -> (y, k, v), with
    ``k`` roped: prefill fills its decode cache from the same projections.
    ``kv_source`` (B, T, D): cross-attention memory, K and V projected from
    it.  With this rank's block of the heads (a running ``model`` axis),
    the projections are column-split over heads, attention runs on the
    rank's heads, ``wo`` is row-split and one all-reduce over ``model``
    sums the output; ``k`` and ``v`` are the rank's kv heads.  There the
    caller hands ``kv_source`` in as a column-parallel input already
    (:func:`~repro_torch.sharding.collectives.copy_to_model`): every
    layer's cross-attention reads the one memory, whose cotangent is then
    summed over ``model`` once.  With ``seq``
    (:func:`~repro_torch.sharding.collectives.seq_mesh`) x is the rank's
    chunk of the sequence, gathered before the projections, and the output
    is the rank's chunk, reduce-scattered in place of the all-reduce
    (:func:`~repro_torch.sharding.collectives.enter_linear` /
    :func:`~repro_torch.sharding.collectives.leave_model`); ``k`` and ``v``
    cover the whole sequence.  With ``every_kv_head`` (a self-attention
    layer whose kv heads do not split over ``model``: its ``wk`` / ``wv``
    are whole on the rank) ``k`` and ``v`` are every kv head's, for a cache
    whose capacity is split over ``model`` (:class:`SlotBlock`); the
    attention still runs on the rank's own."""
    dt = x.dtype
    cross = kv_source is not None
    mesh = head_mesh(cfg)
    # cross-attention is plain MHA: its kv heads split as the query heads
    wk, wv = (p["wk"], p["wv"]) if cross or every_kv_head else _kv_weights(p, cfg, mesh)
    if cross:
        x, q = C.enter_linear(x, mesh, seq, [p["wq"].to(dt)])
        k = torch.einsum("btd,dnh->btnh", kv_source, wk.to(dt))
        v = torch.einsum("btd,dnh->btnh", kv_source, wv.to(dt))
    else:
        x, q, k, v = C.enter_linear(x, mesh, seq, [p["wq"].to(dt), wk.to(dt), wv.to(dt)])
    if use_rope and not cross:
        q = apply_rope(q, io.positions, cfg.rope_theta)
        k = apply_rope(k, io.positions, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim**-0.5
    q = q * torch.tensor(scale, dtype=dt)
    k_all, v_all = k, v
    if every_kv_head and mesh is not None:
        first, count, _ = local_kv_heads(cfg, mesh)
        if count < k.shape[2]:
            k, v = (t.narrow(2, first, count).contiguous() for t in (k, v))
    if cfg.use_pallas and not cross:
        # the flash kernel (contiguous positions); q is pre-scaled above
        out = flash_attention(q, k, v, causal=io.causal, window=window,
                              softcap=cfg.attn_logit_softcap, scale=1.0)
    else:
        src = kv_source if cross else x
        B, T = src.shape[0], src.shape[1]
        kpos = torch.arange(T, device=x.device)[None].expand(B, T) if cross else io.positions
        out = blockwise_attention(
            q, k, v, io.positions, kpos,
            causal=io.causal and not cross, window=window, softcap=cfg.attn_logit_softcap,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        )
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(dt))
    return C.leave_model(y, mesh, "attn", seq), k_all, v_all


def attention_layer(p: Params, x: torch.Tensor, io: LayerIO, cfg, *, window: int | None,
                    kv_source: torch.Tensor | None = None, use_rope: bool = True,
                    seq=None) -> torch.Tensor:
    """Projections + rope + attention + output projection."""
    return attention_layer_kv(p, x, io, cfg, window=window, kv_source=kv_source,
                              use_rope=use_rope, seq=seq)[0]
