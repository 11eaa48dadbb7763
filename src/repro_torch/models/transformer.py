"""Decoder trunk: heterogeneous blocks, prefill and cached decode (port of
``src/repro/models/transformer.py``).

A config's ``block_pattern`` (recurrentgemma's recurrent/recurrent/local,
stablelm's global) defines one period; the stack is ``num_periods``
repetitions of it plus unrolled remainder layers.  Params keep the
reference's layout — with ``scan_layers`` each leaf of the period is stacked
on a leading layer axis under ``pos{j}``, remainder layers sit under
``rem{i}`` — so flat buffers carry over element for element.  A Python loop
over layers takes the place of ``lax.scan``: the stacked leaves are
``unbind``-ed once (whose backward is one ``stack`` per leaf, not one
full-size scatter per layer), and ``torch.utils.checkpoint`` takes the place
of ``jax.checkpoint`` under ``cfg.remat``.

Each layer type owns its decode cache, stacked like the params:
  global     -> full KV cache (capacity = max sequence)
  local      -> ring KV cache (capacity = window)
  recurrent  -> (conv window, lru state h)
  ssm        -> (conv window, selective-scan state h)
A decode step updates the cache in place and returns it.  A Mamba (``ssm``)
block is its mixer and the residual alone (no MLP, no post-norm), as in the
reference.  With ``cfg.num_experts`` every other block's MLP is a
Mixture-of-Experts layer (:mod:`repro_torch.models.moe`), whose router
load-balance loss the full-sequence path returns beside ``x`` and sums over
the stack in layer order; a block without experts contributes no term (the
reference's zero, not materialised, so a dense stack runs no extra op).

Under a running sharded mesh a rank stores its block of every weight over
``data`` too (the reference's FSDP storage): each layer's subtree is
gathered over ``data`` just before the layer runs
(:func:`~repro_torch.sharding.collectives.gather_weights`), inside the block
that ``cfg.remat`` checkpoints, so the recompute gathers it again and no
more than a layer's weights are whole at once; the gather's backward
reduce-scatters their gradient.  Under a running ``model`` axis the blocks
need nothing more of their own: the
attention, MLP, MoE, Mamba and RG-LRU layers shard themselves (their params
are the rank's blocks), each ends in an all-reduce over ``model``, and so
the norms (replicated), the residual stream and the local / global windows
see the whole ``(B, S, D)`` activations on every rank.  With
``cfg.sequence_parallel`` (Megatron sequence parallelism, the reference's
``seq_sp`` rule in its ``apply_block``; training and prefill, where
``model`` divides the sequence:
:func:`~repro_torch.sharding.collectives.seq_mesh`) the residual stream
is the rank's ``(B, S / model, D)`` chunk instead: the norms and the
residual adds run on the chunk (each norm's gradient summed over
``model``), every mixer, MLP and MoE gathers its input over ``model`` and
reduce-scatters its output back to the chunks, and the local / global
windows see the whole gathered sequence.  A decode step (S = 1) runs as
without it.  A decode cache
holds the rank's kv heads, or the rank's channels of a Mamba or RG-LRU
layer's conv window and state.  Whether the Mamba and RG-LRU layers run
sharded is the storage layout's one decision
(:func:`~repro_torch.sharding.collectives.layout_mesh`, through
:func:`repro_torch.models.ssm.ssm_mesh` and
:func:`repro_torch.models.rglru.lru_mesh`).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    LayerIO,
    Params,
    apply_layernorm,
    apply_mlp,
    apply_rmsnorm,
    apply_rope,
    init_layernorm,
    init_mlp,
    init_rmsnorm,
    mlp_mesh,
)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.ctx import current_rules, rules_in_force
from repro_torch.tree import tree_map


def _norm_init(cfg, device):
    fn = init_layernorm if cfg.norm_type == "layernorm" else init_rmsnorm
    return fn(cfg.d_model, device)


def _norm(cfg, p, x):
    fn = apply_layernorm if cfg.norm_type == "layernorm" else apply_rmsnorm
    return fn(p, x, cfg.norm_eps)


def _check_supported(layer_type: str, cfg) -> None:
    if layer_type not in ("global", "local", "recurrent", "ssm"):
        raise ValueError(f"unknown layer type {layer_type!r}")


def _window_for(layer_type: str, cfg) -> int | None:
    return cfg.window_size if layer_type == "local" else None


def init_block(gen, layer_type: str, cfg, device) -> Params:
    _check_supported(layer_type, cfg)
    p: Params = {"pre_norm": _norm_init(cfg, device)}
    if layer_type == "ssm":
        p["ssm"] = S.init_ssm(gen, cfg, device)
        return p  # a mamba block has no separate MLP
    if layer_type == "recurrent":
        p["rglru"] = R.init_rglru(gen, cfg, device)
    else:
        p["attn"] = A.init_attention(gen, cfg, device)
    if cfg.use_post_norms:
        p["post_norm"] = _norm_init(cfg, device)
    p["mlp_pre_norm"] = _norm_init(cfg, device)
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)
    if cfg.use_post_norms:
        p["mlp_post_norm"] = _norm_init(cfg, device)
    return p


def _norms_on_chunk(p: Params, seq) -> Params:
    """A block's params with its norms' leaves passed through
    :func:`~repro_torch.sharding.collectives.copy_to_model` under ``seq``:
    a norm that runs on the rank's chunk of the sequence gives its scale a
    gradient of that chunk's rows alone, summed over ``model`` in the
    backward (one all-reduce of the leaf)."""
    if seq is None:
        return p
    return {k: (tree_map(lambda w: C.copy_to_model(w, seq), v) if k.endswith("norm") else v)
            for k, v in p.items()}


def _mlp_residual(p: Params, x, pre, h, cfg, seq=None):
    """The block's second half: post-norm of the mixer output, residual, MLP
    (or MoE) -> (x, the MoE's aux loss or None); with ``seq`` on the
    rank's chunk of the sequence."""
    if cfg.use_post_norms:
        h = _norm(cfg, p["post_norm"], h)
    if cfg.parallel_residual:
        m_in = pre
    else:
        x = x + h
        m_in = _norm(cfg, p["mlp_pre_norm"], x)
    aux = None
    if cfg.num_experts:
        m, aux = MOE.apply_moe(p["moe"], m_in, cfg, seq)
    else:
        m = apply_mlp(p["mlp"], m_in, cfg.act, mesh=mlp_mesh(cfg), seq=seq)
    if cfg.use_post_norms:
        m = _norm(cfg, p["mlp_post_norm"], m)
    return ((x + h + m) if cfg.parallel_residual else (x + m)), aux


def apply_block(p: Params, x: torch.Tensor, layer_type: str, io: LayerIO, cfg):
    """Full-sequence (train / prefill) path of one pre-norm residual block ->
    (x, aux): the MoE's load-balance loss, None for a block without experts.
    Under :func:`~repro_torch.sharding.collectives.seq_mesh` of the
    sequence ``io`` describes, x and the output are the rank's chunk of it
    (module docstring)."""
    _check_supported(layer_type, cfg)
    seq = C.seq_mesh(cfg, io.positions.shape[1])
    p = _norms_on_chunk(p, seq)
    pre = _norm(cfg, p["pre_norm"], x)
    if layer_type == "ssm":
        return x + S.apply_ssm(p["ssm"], pre, cfg, seq), None
    if layer_type == "recurrent":
        h = R.apply_rglru(p["rglru"], pre, cfg, seq)
    else:
        h = A.attention_layer(p["attn"], pre, io, cfg, window=_window_for(layer_type, cfg),
                              use_rope=cfg.use_rope, seq=seq)
    return _mlp_residual(p, x, pre, h, cfg, seq)


# ---------------------------------------------------------------------------
# Decode-step block (single token, threaded cache)
# ---------------------------------------------------------------------------

def _kv_block(layer_type: str, capacity: int | None, cfg):
    """:func:`repro_torch.models.attention.cache_block` of an attention
    layer's cache for ``capacity`` positions (a local layer's ring holds
    ``min(window, capacity)`` slots); None in a decode step, which reads
    them from the serving shape."""
    return A.cache_block(capacity, cfg.num_kv_heads, cfg.head_dim,
                         window=_window_for(layer_type, cfg))


def _cache_kv_heads(cfg, block) -> int:
    """The kv heads an attention layer's cache holds on this rank: every
    one where its capacity is split over ``model`` instead, else the
    rank's (:func:`repro_torch.models.attention.local_kv_heads`)."""
    mesh = A.head_mesh(cfg)
    if mesh is None or (block is not None and block.every_kv_head):
        return cfg.num_kv_heads
    return A.local_kv_heads(cfg, mesh)[1]


def init_block_cache(layer_type: str, batch: int, capacity: int, cfg, dtype, device) -> Params:
    _check_supported(layer_type, cfg)
    if layer_type == "ssm":
        return S.init_ssm_cache(batch, cfg, dtype, device)
    if layer_type == "recurrent":
        return R.init_rglru_cache(batch, cfg, dtype, device)
    cap = min(cfg.window_size, capacity) if layer_type == "local" else capacity
    block = _kv_block(layer_type, capacity, cfg)
    return A.init_kv_cache(batch, cap if block is None else block.size,
                           _cache_kv_heads(cfg, block), cfg.head_dim, dtype, device)


def _attn_decode(p, x, cache, layer_type, pos, cfg):
    """Project one token, write it into the cache, attend.  With the
    cache's capacity split (:func:`_kv_block`) the rank writes the token
    only where it holds its slot, and attends over its slots with a
    combined softmax (:func:`repro_torch.models.attention.decode_heads`)."""
    dt = x.dtype
    B = x.shape[0]
    mesh = A.head_mesh(cfg)
    block = _kv_block(layer_type, None, cfg)
    if mesh is not None:
        x = C.copy_to_model(x, mesh)
    every = block is not None and block.every_kv_head
    wk, wv = (p["wk"], p["wv"]) if every else A._kv_weights(p, cfg, mesh)
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", x, wk.to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, wv.to(dt))
    qpos = pos.reshape(1, 1).expand(B, 1)
    if cfg.use_rope:
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim**-0.5
    q = q * torch.tensor(scale, dtype=dt)
    ring = layer_type == "local"
    cache = (A.update_cache_ring if ring else A.update_cache_full)(cache, k, v, pos, block)
    cpos_fn = A.cache_positions_ring if ring else A.cache_positions_full
    cpos = cpos_fn(cache["k"].shape[1] if block is None else block.whole, pos + 1, B, block)
    out = A.decode_heads(q, cache["k"], cache["v"], cpos, qpos,
                         window=_window_for(layer_type, cfg), softcap=cfg.attn_logit_softcap,
                         block=block, mesh=mesh)
    # the reference's jnp promotion: an f32 cache gives an f32 output
    od = torch.promote_types(out.dtype, dt)
    y = torch.einsum("bsnh,nhd->bsd", out.to(od), p["wo"].to(dt).to(od))
    return (y if mesh is None else C.reduce_from_model(y, mesh, "attn")), cache


def apply_block_step(p: Params, x: torch.Tensor, cache: Params, layer_type: str, pos, cfg):
    """x: (B, 1, D), pos: 0-d int tensor (absolute position) -> (x, cache);
    the cache is updated in place."""
    pre = _norm(cfg, p["pre_norm"], x)
    if layer_type == "ssm":
        h, cache = S.apply_ssm_step(p["ssm"], pre, cache, cfg)
        return x + h, cache
    if layer_type == "recurrent":
        h, cache = R.apply_rglru_step(p["rglru"], pre, cache, cfg)
    else:
        h, cache = _attn_decode(p["attn"], pre, cache, layer_type, pos, cfg)
    return _mlp_residual(p, x, pre, h, cfg)[0], cache


def prefill_block_cache(p: Params, x: torch.Tensor, layer_type: str, io: LayerIO, cfg,
                        capacity: int, cache_dtype):
    """Full-sequence pass that also emits the decode cache.

    The reference runs :func:`apply_block` and then the mixer's projections
    (or its recurrence, or its scan) a second time for the cache; here one
    pass of the mixer gives both its output and the cache's contents, which
    are the same values.
    """
    _check_supported(layer_type, cfg)
    seq = C.seq_mesh(cfg, io.positions.shape[1])
    pre = _norm(cfg, p["pre_norm"], x)
    if layer_type == "ssm":
        h, cache = S.ssm_prefill_cache(p["ssm"], pre, cfg, cache_dtype, seq)
        return x + h, cache
    if layer_type == "recurrent":
        h, cache = R.rglru_prefill_cache(p["rglru"], pre, cfg, cache_dtype, seq)
    else:
        block = _kv_block(layer_type, capacity, cfg)
        h, k, v = A.attention_layer_kv(p["attn"], pre, io, cfg,
                                       window=_window_for(layer_type, cfg), use_rope=cfg.use_rope,
                                       seq=seq, every_kv_head=block is not None
                                       and block.every_kv_head)
        ring = layer_type == "local"
        cap = min(cfg.window_size, capacity) if ring else capacity
        cache = A.fill_cache_from_prefill(k.to(cache_dtype), v.to(cache_dtype), cap, ring, block)
    return _mlp_residual(p, x, pre, h, cfg, seq)[0], cache


# ---------------------------------------------------------------------------
# Stack: periods + unrolled remainder
# ---------------------------------------------------------------------------

def _stacked(cfg) -> bool:
    return cfg.scan_layers and cfg.num_periods > 0


def _layers(cfg) -> list[tuple[str, str, int | None]]:
    """``(group key, layer type, index in the group or None)`` in stack order."""
    pattern = cfg.block_pattern
    if _stacked(cfg):
        out = [(f"pos{j}", t, i) for i in range(cfg.num_periods) for j, t in enumerate(pattern)]
    else:
        out = [(f"layer{i}", t, None) for i, t in enumerate(pattern * cfg.num_periods)]
    return out + [(f"rem{i}", t, None) for i, t in enumerate(cfg.remainder_layers)]


def _stack_trees(trees: list) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_stacked_blocks(n: int, init_one) -> Params:
    """``n`` blocks from ``init_one()`` stacked on a leading axis, each drawn,
    copied into its slot and dropped: stacking a list of blocks would hold
    the period twice (2 x 27 GB for falcon-mamba-7b's 64 layers), and
    keeping earlier blocks alive while the next is drawn holds two more
    (5.04 GB at qwen2-moe-a2.7b's width)."""
    block = init_one()
    out = tree_map(lambda leaf: leaf.new_empty((n,) + tuple(leaf.shape)), block)
    for i in range(n):
        if i:
            block = init_one()
        tree_map(lambda dst, src, i=i: dst[i].copy_(src), out, block)
        del block
    return out


def init_stack(gen, cfg, device) -> Params:
    params: Params = {}
    n_per = cfg.num_periods
    if _stacked(cfg):
        for j, t in enumerate(cfg.block_pattern):
            params[f"pos{j}"] = init_stacked_blocks(
                n_per, lambda t=t: init_block(gen, t, cfg, device))
    else:
        for i, t in enumerate(cfg.block_pattern * n_per):
            params[f"layer{i}"] = init_block(gen, t, cfg, device)
    for i, t in enumerate(cfg.remainder_layers):
        params[f"rem{i}"] = init_block(gen, t, cfg, device)
    return params


def _unstack(stacked: Params, n: int) -> list[Params]:
    """Per-layer views of a stacked period, through one ``unbind`` per leaf."""
    per_leaf = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda parts, i=i: parts[i], per_leaf) for i in range(n)]


def _per_layer(tree: Params, cfg) -> list[tuple[str, str, Params]]:
    """``(group key, layer type, that layer's subtree)`` in stack order; the
    subtree of a stacked layer is a view into the stacked leaves."""
    views = {key: _unstack(tree[key], cfg.num_periods)
             for key in {g for g, _, i in _layers(cfg) if i is not None}}
    return [(g, t, tree[g] if i is None else views[g][i]) for g, t, i in _layers(cfg)]


def remat_call(fn, x: torch.Tensor, cfg):
    """``fn(x)``; under ``cfg.remat`` checkpointed (``jax.checkpoint``'s
    counterpart).  Under a running sharded mesh the recompute runs the
    whole block: with early stopping it would end before the block's last
    all-reduce, so the collectives of a step would depend on which tensors
    autograd saved.  And it re-enters the sharding rules: a CUDA backward
    recomputes on autograd's device thread, which does not see this
    thread's rules."""
    if not cfg.remat:
        return fn(x)
    rules = current_rules()

    def block(x):
        with rules_in_force(rules):
            return fn(x)

    with set_checkpoint_early_stop(False) if C.sharded_mesh() is not None else \
            contextlib.nullcontext():
        return checkpoint(block, x, use_reentrant=False)


def gathered(apply, p: Params, prefix: str, cfg):
    """``apply`` with its first argument, the layer's params at ``prefix``,
    gathered over ``data`` when it runs
    (:func:`~repro_torch.sharding.collectives.gather_weights`)."""

    def run(*args, **kwargs):
        return apply(C.gather_weights(p, prefix, cfg), *args, **kwargs)

    return run


def apply_stack(params: Params, x: torch.Tensor, io: LayerIO, cfg):
    """-> (x, aux_total): the blocks' aux losses summed in layer order (f32;
    zero for a stack without experts)."""
    aux_total = None
    for g, t, p in _per_layer(params, cfg):
        x, a = remat_call(functools.partial(gathered(apply_block, p, f"stack/{g}", cfg),
                                            layer_type=t, io=io, cfg=cfg), x, cfg)
        if a is not None:  # 0 + a is a exactly: the reference's sum from zero
            aux_total = a if aux_total is None else aux_total + a
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux_total


def init_stack_cache(cfg, batch: int, capacity: int, dtype, device) -> Params:
    """A zero cache, stacked like the params (real memory: decode writes into it)."""
    cache: Params = {}
    if _stacked(cfg):
        for j, t in enumerate(cfg.block_pattern):
            one = init_block_cache(t, batch, capacity, cfg, dtype, device)
            cache[f"pos{j}"] = tree_map(
                lambda leaf: leaf.new_zeros((cfg.num_periods,) + tuple(leaf.shape)), one)
    else:
        for i, t in enumerate(cfg.block_pattern * cfg.num_periods):
            cache[f"layer{i}"] = init_block_cache(t, batch, capacity, cfg, dtype, device)
    for i, t in enumerate(cfg.remainder_layers):
        cache[f"rem{i}"] = init_block_cache(t, batch, capacity, cfg, dtype, device)
    return cache


def apply_stack_step(params: Params, x: torch.Tensor, cache: Params, pos, cfg):
    """One token through every layer; the cache is updated in place."""
    for (g, t, p), (_, _, c) in zip(_per_layer(params, cfg), _per_layer(cache, cfg)):
        x, _ = apply_block_step(C.gather_weights(p, f"stack/{g}", cfg), x, c, t, pos, cfg)
    return x, cache


def prefill_stack(params: Params, x: torch.Tensor, io: LayerIO, cfg, capacity: int, cache_dtype):
    """Prefill the whole stack -> (hidden states, decode cache stacked like
    the params)."""
    groups: dict[str, list] = {}
    for g, t, p in _per_layer(params, cfg):
        x, c = prefill_block_cache(C.gather_weights(p, f"stack/{g}", cfg), x, t, io, cfg,
                                   capacity, cache_dtype)
        groups.setdefault(g, []).append(c)
    cache = {g: _stack_trees(cs) if g.startswith("pos") else cs[0] for g, cs in groups.items()}
    return x, cache
