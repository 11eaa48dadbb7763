"""Decoder trunk, global blocks (port of ``src/repro/models/transformer.py``).

Params keep the reference's layout — with ``scan_layers`` each leaf of the
period is stacked on a leading layer axis under ``pos{j}`` — so flat buffers
carry over element for element.  A Python loop over layers takes the place of
``lax.scan``: the stacked leaves are ``unbind``-ed once (whose backward is one
``stack`` per leaf, not one full-size scatter per layer), and
``torch.utils.checkpoint`` takes the place of ``jax.checkpoint`` under
``cfg.remat`` (recompute in the backward; the numbers are the same).
Local/ssm/recurrent/MoE blocks and the decode path are not ported yet.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models.layers import (
    LayerIO,
    Params,
    apply_layernorm,
    apply_mlp,
    apply_rmsnorm,
    init_layernorm,
    init_mlp,
    init_rmsnorm,
)
from repro_torch.tree import tree_map


def _norm_init(cfg, device):
    fn = init_layernorm if cfg.norm_type == "layernorm" else init_rmsnorm
    return fn(cfg.d_model, device)


def _norm(cfg, p, x):
    fn = apply_layernorm if cfg.norm_type == "layernorm" else apply_rmsnorm
    return fn(p, x, cfg.norm_eps)


def _check_supported(layer_type: str, cfg) -> None:
    if layer_type != "global" or cfg.num_experts:
        raise NotImplementedError(
            f"layer type {layer_type!r} (experts={cfg.num_experts}) is not ported yet; "
            "this slice runs dense global-attention blocks"
        )


def init_block(gen, layer_type: str, cfg, device) -> Params:
    _check_supported(layer_type, cfg)
    p: Params = {"pre_norm": _norm_init(cfg, device), "attn": A.init_attention(gen, cfg, device)}
    if cfg.use_post_norms:
        p["post_norm"] = _norm_init(cfg, device)
    p["mlp_pre_norm"] = _norm_init(cfg, device)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)
    if cfg.use_post_norms:
        p["mlp_post_norm"] = _norm_init(cfg, device)
    return p


def apply_block(p: Params, x: torch.Tensor, layer_type: str, io: LayerIO, cfg) -> torch.Tensor:
    """Full-sequence (train) path of one pre-norm residual block."""
    _check_supported(layer_type, cfg)
    pre = _norm(cfg, p["pre_norm"], x)
    h = A.attention_layer(p["attn"], pre, io, cfg, window=None, use_rope=cfg.use_rope)
    if cfg.use_post_norms:
        h = _norm(cfg, p["post_norm"], h)
    if cfg.parallel_residual:
        m_in = pre
    else:
        x = x + h
        m_in = _norm(cfg, p["mlp_pre_norm"], x)
    m = apply_mlp(p["mlp"], m_in, cfg.act)
    if cfg.use_post_norms:
        m = _norm(cfg, p["mlp_post_norm"], m)
    return (x + h + m) if cfg.parallel_residual else (x + m)


def init_stack(gen, cfg, device) -> Params:
    params: Params = {}
    n_per = cfg.num_periods
    if cfg.scan_layers and n_per > 0:
        for j, t in enumerate(cfg.block_pattern):
            layers = [init_block(gen, t, cfg, device) for _ in range(n_per)]
            params[f"pos{j}"] = tree_map(lambda *xs: torch.stack(xs), *layers)
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


def apply_stack(params: Params, x: torch.Tensor, io: LayerIO, cfg) -> torch.Tensor:
    def layer(p, x, t):
        if cfg.remat:
            return checkpoint(functools.partial(apply_block, p, layer_type=t, io=io, cfg=cfg),
                              x, use_reentrant=False)
        return apply_block(p, x, t, io, cfg)

    pattern = cfg.block_pattern
    if cfg.scan_layers and cfg.num_periods > 0:
        per_pos = [_unstack(params[f"pos{j}"], cfg.num_periods) for j in range(len(pattern))]
        for i in range(cfg.num_periods):
            for j, t in enumerate(pattern):
                x = layer(per_pos[j][i], x, t)
    else:
        for i, t in enumerate(pattern * cfg.num_periods):
            x = layer(params[f"layer{i}"], x, t)
    for i, t in enumerate(cfg.remainder_layers):
        x = layer(params[f"rem{i}"], x, t)
    return x
