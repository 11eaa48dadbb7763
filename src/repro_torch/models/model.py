"""Top-level model API for decoder-only LMs (port of
``src/repro/models/model.py``): embedding -> block stack -> final norm ->
(tied) unembed, the masked cross-entropy loss, and serving — ``prefill`` of a
prompt into a decode cache, then one ``decode_step`` per token.

A batch is ``{"tokens": (B, S) int, "labels": (B, S) int}``; ``-1`` labels are
masked.  Vision prefixes and the whisper encoder-decoder are not ported yet.
Serving runs without autograd; a decode step updates the cache in place and
returns it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    LayerIO,
    Params,
    apply_embedding,
    apply_unembed,
    dtype_of,
    init_embedding,
)

__all__ = ["init_model", "forward", "cross_entropy", "loss_fn", "init_decode_state", "decode_step",
           "prefill"]

f32 = torch.float32


def _check_decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.family} models are not ported yet")


def init_model(gen, cfg, device) -> Params:
    _check_decoder_only(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "stack": T.init_stack(gen, cfg, device),
        "final_norm": T._norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, device)
    return params


def _embed(params: Params, tokens: torch.Tensor, cfg) -> tuple[torch.Tensor, LayerIO]:
    """Token embeddings and the causal geometry of positions 0..S-1."""
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens, scale=cfg.embed_scale,
                        act_dtype=dtype_of(cfg.activation_dtype))
    positions = torch.arange(S, device=tokens.device).unsqueeze(0).expand(B, S)
    return x, LayerIO(positions=positions, causal=True)


def forward(params: Params, batch: dict[str, Any], cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B, S, V), aux_loss scalar)."""
    x, io = _embed(params, batch["tokens"], cfg)
    x = T.apply_stack(params["stack"], x, io, cfg)
    x = T._norm(cfg, params["final_norm"], x)
    logits = apply_unembed(params.get("unembed", params["embed"]), x,
                           softcap=cfg.final_logit_softcap)
    return logits, torch.zeros((), dtype=f32, device=logits.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean CE in float32; labels < 0 are ignored."""
    logits = logits.to(f32)
    mask = (labels >= 0).to(f32)
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom, denom


def loss_fn(params: Params, batch: dict[str, Any], cfg) -> tuple[torch.Tensor, dict]:
    logits, aux = forward(params, batch, cfg)
    labels = batch.get("labels")
    if labels is None:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], -torch.ones_like(tokens[:, :1])], dim=1)
    ce, n_tok = cross_entropy(logits, labels)
    return ce, {"ce": ce, "aux": aux, "n_tokens": n_tok}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(params: Params, cfg, batch_size: int, capacity: int, *,
                      cache_dtype=torch.bfloat16) -> Params:
    """Fresh decode cache sized for ``capacity`` positions, on the params'
    device."""
    _check_decoder_only(cfg)
    device = params["embed"]["embedding"].device
    return T.init_stack_cache(cfg, batch_size, capacity, cache_dtype, device)


@torch.no_grad()
def decode_step(params: Params, cache: Params, token: torch.Tensor, pos, cfg):
    """One decode step.  token: (B,) int; pos: the absolute position, an int
    or a 0-d int tensor (a device tensor keeps the step free of host syncs).

    Returns (logits (B, V), cache), the cache updated in place.
    """
    _check_decoder_only(cfg)
    act_dt = dtype_of(cfg.activation_dtype)
    x = apply_embedding(params["embed"], token[:, None], scale=cfg.embed_scale, act_dtype=act_dt)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    x, cache = T.apply_stack_step(params["stack"], x, cache, pos, cfg)
    x = T._norm(cfg, params["final_norm"], x)
    logits = apply_unembed(params.get("unembed", params["embed"]), x[:, 0],
                           softcap=cfg.final_logit_softcap)
    return logits, cache


@torch.no_grad()
def prefill(params: Params, batch: dict[str, Any], cfg, capacity: int, *,
            cache_dtype=torch.bfloat16):
    """Process a prompt -> (last-position logits (B, V), decode cache)."""
    _check_decoder_only(cfg)
    x, io = _embed(params, batch["tokens"], cfg)
    x, cache = T.prefill_stack(params["stack"], x, io, cfg, capacity, cache_dtype)
    # the norm is row-wise: normalizing the last position alone is the same
    x = T._norm(cfg, params["final_norm"], x[:, -1])
    logits = apply_unembed(params.get("unembed", params["embed"]), x,
                           softcap=cfg.final_logit_softcap)
    return logits, cache
