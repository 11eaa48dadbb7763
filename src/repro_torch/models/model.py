"""Top-level model API for the dense decoder-only LM (port of
``src/repro/models/model.py``): embedding -> block stack -> final norm ->
(tied) unembed, and the masked cross-entropy loss.

A batch is ``{"tokens": (B, S) int, "labels": (B, S) int}``; ``-1`` labels are
masked.  Vision prefixes, the whisper encoder-decoder and decode are not
ported yet.
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

__all__ = ["init_model", "forward", "cross_entropy", "loss_fn"]

f32 = torch.float32


def init_model(gen, cfg, device) -> Params:
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.family} models are not ported yet")
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "stack": T.init_stack(gen, cfg, device),
        "final_norm": T._norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, device)
    return params


def forward(params: Params, batch: dict[str, Any], cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B, S, V), aux_loss scalar)."""
    act_dt = dtype_of(cfg.activation_dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens, scale=cfg.embed_scale, act_dtype=act_dt)
    positions = torch.arange(S, device=tokens.device).unsqueeze(0).expand(B, S)
    x = T.apply_stack(params["stack"], x, LayerIO(positions=positions, causal=True), cfg)
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
