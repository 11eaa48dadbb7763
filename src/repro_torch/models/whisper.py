"""Whisper-large-v3 encoder-decoder backbone (port of
``src/repro/models/whisper.py``; arXiv:2212.04356).

As in the reference, the mel-spectrogram and conv feature extractor are a
stub: the batch carries precomputed frame embeddings ``(B, T_enc, D)``
(``data.make_batch_for``'s ``enc_embeds``).  This module is the transformer
that consumes them:

* encoder: ``num_encoder_layers`` bidirectional pre-LN blocks over the frame
  embeddings plus fixed sinusoidal positions, then a LayerNorm;
* decoder: causal self-attention (a full KV cache when decoding),
  cross-attention into the encoder memory and an MLP, pre-LN, a final
  LayerNorm and the tied unembedding.

Plain MHA (KV heads = query heads), LayerNorm, non-gated GeLU MLPs and
absolute sinusoidal positions, no RoPE, all from the config.  Each stack's
params are stacked on a leading layer axis as in the reference (its
``lax.scan`` becomes a loop over ``unbind`` views).  Under ``use_pallas`` the
encoder's and the decoder's self-attention run the flash kernel (the
encoder's non-causal); cross-attention runs the plain path.

A decode step updates the self-attention cache in place.  As the decoder
trunk's decode step (``transformer._attn_decode``), it follows jnp's type
promotion: attention read from an f32 cache gives an f32 output, and the
weights are cast to the dtype the activations then have.

Under a running sharded mesh the params are the rank's blocks, as the
decoder trunk's: over ``data`` they are gathered layer by layer (the
encoder's and the decoder's, inside the block ``cfg.remat`` checkpoints;
the cross K/V projections' ``wk`` / ``wv`` alone for the cache).  Under a
running ``model`` axis every attention (the encoder's, the decoder's self- and
cross-attention) runs the rank's heads and every MLP the rank's d_ff, each
ending in an all-reduce over ``model``; the embedding and unembedding are
split by vocab where ``model`` divides it (``vmesh``, else whole on every
rank).  The encoder's output is replicated and enters the decoder as one
column-parallel input, so its cotangent is summed over ``model`` once for
all the layers' cross-attention.  The cache holds the rank's heads of the
self-attention K/V and of the cross K/V.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as A
from repro_torch.models.layers import (
    LayerIO,
    Params,
    apply_embedding,
    apply_layernorm,
    apply_mlp,
    apply_unembed,
    dtype_of,
    init_embedding,
    init_layernorm,
    init_mlp,
    mlp_mesh,
    position_table,
)
from repro_torch.models.transformer import _unstack, gathered, init_stacked_blocks, remat_call
from repro_torch.sharding import collectives as C

__all__ = ["init_whisper", "encode", "decode_train", "init_whisper_cache", "whisper_decode_step"]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_encoder_block(gen, cfg, device) -> Params:
    return {
        "attn_norm": init_layernorm(cfg.d_model, device),
        "attn": A.init_attention(gen, cfg, device, cross=True),  # MHA: kv == q heads
        "mlp_norm": init_layernorm(cfg.d_model, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, device),
    }


def apply_encoder_block(p: Params, x: torch.Tensor, io: LayerIO, cfg) -> torch.Tensor:
    h = apply_layernorm(p["attn_norm"], x, cfg.norm_eps)
    h = A.attention_layer(p["attn"], h, io, cfg, window=None, use_rope=False)
    x = x + h
    m = apply_layernorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], m, cfg.act, mesh=mlp_mesh(cfg))


def init_decoder_block(gen, cfg, device) -> Params:
    return {
        "self_norm": init_layernorm(cfg.d_model, device),
        "self_attn": A.init_attention(gen, cfg, device),
        "cross_norm": init_layernorm(cfg.d_model, device),
        "cross_attn": A.init_attention(gen, cfg, device, cross=True),
        "mlp_norm": init_layernorm(cfg.d_model, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, device),
    }


def apply_decoder_block(p: Params, x: torch.Tensor, memory: torch.Tensor, io: LayerIO, cfg):
    """One decoder block; under a running ``model`` axis ``memory`` is the
    column-parallel input (:func:`decode_train`)."""
    h = apply_layernorm(p["self_norm"], x, cfg.norm_eps)
    h = A.attention_layer(p["self_attn"], h, io, cfg, window=None, use_rope=False)
    x = x + h
    c = apply_layernorm(p["cross_norm"], x, cfg.norm_eps)
    c = A.attention_layer(p["cross_attn"], c, io, cfg, window=None, kv_source=memory,
                          use_rope=False)
    x = x + c
    m = apply_layernorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], m, cfg.act, mesh=mlp_mesh(cfg))


# ---------------------------------------------------------------------------
# Stacks (identical layers, params stacked on the leading axis)
# ---------------------------------------------------------------------------

def init_whisper(gen, cfg, device) -> Params:
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "encoder": init_stacked_blocks(cfg.num_encoder_layers,
                                       lambda: init_encoder_block(gen, cfg, device)),
        "encoder_norm": init_layernorm(cfg.d_model, device),
        "decoder": init_stacked_blocks(cfg.num_layers,
                                       lambda: init_decoder_block(gen, cfg, device)),
        "decoder_norm": init_layernorm(cfg.d_model, device),
    }


def _positions(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None].expand(B, n)


def encode(params: Params, frame_embeds: torch.Tensor, cfg) -> torch.Tensor:
    """frame_embeds: (B, T_enc, D), the conv-frontend stub's output -> the
    encoder memory (B, T_enc, D)."""
    B, T, D = frame_embeds.shape
    x = frame_embeds + position_table(T, D, frame_embeds.device, frame_embeds.dtype)[None]
    io = LayerIO(positions=_positions(B, T, x.device), causal=False)
    for p in _unstack(params["encoder"], cfg.num_encoder_layers):
        x = apply_encoder_block(C.gather_weights(p, "encoder", cfg), x, io, cfg)
    return apply_layernorm(params["encoder_norm"], x, cfg.norm_eps)


def decode_train(params: Params, tokens: torch.Tensor, memory: torch.Tensor, cfg, *,
                 vmesh=None) -> torch.Tensor:
    """Teacher-forced decoder pass. tokens: (B, S) -> logits (B, S, V), or
    with ``vmesh`` (the vocab split over ``model``) the rank's vocab block."""
    B, S = tokens.shape
    act_dt = dtype_of(cfg.activation_dtype)
    x = apply_embedding(params["embed"], tokens, scale=False, act_dtype=act_dt, mesh=vmesh)
    x = x + position_table(S, cfg.d_model, x.device, act_dt)[None]
    io = LayerIO(positions=_positions(B, S, x.device), causal=True)
    mem = memory.to(act_dt)
    hmesh = A.head_mesh(cfg)
    if hmesh is not None:
        mem = C.copy_to_model(mem, hmesh)
    for p in _unstack(params["decoder"], cfg.num_layers):
        x = remat_call(functools.partial(gathered(apply_decoder_block, p, "decoder", cfg),
                                         memory=mem, io=io, cfg=cfg), x, cfg)
    x = apply_layernorm(params["decoder_norm"], x, cfg.norm_eps)
    return apply_unembed(params["embed"], x, softcap=cfg.final_logit_softcap, mesh=vmesh)


# ---------------------------------------------------------------------------
# Decode (one token) — cache = self-attention KV per layer + projected cross KV
# ---------------------------------------------------------------------------

def _cache_blocks(cfg, capacity: int | None = None, frames: int | None = None):
    """:func:`repro_torch.models.attention.cache_block` of the
    self-attention cache (``capacity`` slots over the config's kv heads)
    and of the cross K/V (``frames`` encoder frames over its query heads:
    plain MHA); both read from the serving shape when None (a decode
    step)."""
    return (A.cache_block(capacity, cfg.num_kv_heads, cfg.head_dim),
            A.cache_block(frames, cfg.num_heads, cfg.head_dim, memory=True))


def init_whisper_cache(params: Params, memory: torch.Tensor, cfg, capacity: int, dtype) -> Params:
    """An empty self-attention KV cache ``(L, B, capacity, N, H)`` and the
    cross-attention K/V ``(L, B, T_enc, N, H)``, projected once from the
    memory; N the heads the params hold (under a running ``model`` axis the
    rank's).  Where the capacity or the frames are split
    (:func:`_cache_blocks`: batch 1 over ``data`` under
    ``seq_shard_cache``) each holds the rank's block of them, the cross
    K/V projected from the rank's frames alone."""
    B, T, _ = memory.shape
    self_block, cross_block = _cache_blocks(cfg, capacity, T)
    if cross_block is not None:
        memory = memory.narrow(1, cross_block.start, cross_block.size)
        T = cross_block.size
    cross = params["decoder"]["cross_attn"]
    L, N, H = cfg.num_layers, cross["wk"].shape[-2], cfg.head_dim
    kv = {name: torch.empty((L, B, T, N, H), dtype=dtype, device=memory.device)
          for name in ("k", "v")}
    for i in range(L):
        kv_w = C.gather_weights({"wk": cross["wk"][i], "wv": cross["wv"][i]},
                                "decoder/cross_attn", cfg)
        for name, w in (("k", "wk"), ("v", "wv")):
            proj = torch.einsum("btd,dnh->btnh", memory, kv_w[w].to(memory.dtype))
            kv[name][i].copy_(proj)
    cap = capacity if self_block is None else self_block.size
    self_kv = {name: torch.zeros((L, B, cap, N, H), dtype=dtype, device=memory.device)
               for name in ("k", "v")}
    return {"self": self_kv, "cross": kv}


def _proj_out(o: torch.Tensor, wo: torch.Tensor, dt) -> torch.Tensor:
    """The output projection with jnp's promotion of (o, the dt-cast wo)."""
    od = torch.promote_types(o.dtype, dt)
    return torch.einsum("bsnh,nhd->bsd", o.to(od), wo.to(dt).to(od))


def _attn_out(o: torch.Tensor, wo: torch.Tensor, dt, mesh) -> torch.Tensor:
    y = _proj_out(o, wo, dt)
    return y if mesh is None else C.reduce_from_model(y, mesh, "attn")


def whisper_decode_step(params: Params, cache: Params, token: torch.Tensor, pos, cfg, *,
                        vmesh=None):
    """token: (B,) int, pos: a 0-d int tensor (or an int) -> (logits (B, V),
    cache), the self-attention cache updated in place.  With ``vmesh`` the
    logits are the rank's vocab block; under a running ``model`` axis each
    attention runs the rank's heads (module docstring)."""
    act_dt = dtype_of(cfg.activation_dtype)
    B = token.shape[0]
    hmesh, mmesh = A.head_mesh(cfg), mlp_mesh(cfg)
    x = apply_embedding(params["embed"], token[:, None], scale=False, act_dtype=act_dt,
                        mesh=vmesh)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    self_block, cross_block = _cache_blocks(cfg)
    cap = cache["self"]["k"].shape[2] if self_block is None else self_block.whole
    # the current token's sinusoidal row, read on the device
    pos_row = position_table(cap, cfg.d_model, x.device, act_dt).index_select(0, pos.reshape(1))
    x = x + pos_row[None]
    qpos = pos.reshape(1, 1).expand(B, 1)
    T = cache["cross"]["k"].shape[2] if cross_block is None else cross_block.whole
    mpos = A.cache_positions_full(T, torch.tensor(T, device=x.device), B, cross_block)
    mq = torch.full((B, 1), T, device=x.device)  # cross attention: every memory slot visible
    layers = zip(_unstack(params["decoder"], cfg.num_layers),
                 _unstack(cache["self"], cfg.num_layers),
                 _unstack(cache["cross"], cfg.num_layers))
    for p, self_kv, cross_kv in layers:
        # the cross-attention's wk / wv are not read: the cache holds its K/V
        ca = {k: w for k, w in p["cross_attn"].items() if k not in ("wk", "wv")}
        p = C.gather_weights({**p, "cross_attn": ca}, "decoder", cfg)
        dt = x.dtype
        sa = p["self_attn"]
        h = apply_layernorm(p["self_norm"], x, cfg.norm_eps)
        if hmesh is not None:
            h = C.copy_to_model(h, hmesh)
        q = torch.einsum("bsd,dnh->bsnh", h, sa["wq"].to(dt))
        k = torch.einsum("bsd,dnh->bsnh", h, sa["wk"].to(dt))
        v = torch.einsum("bsd,dnh->bsnh", h, sa["wv"].to(dt))
        q = q * torch.tensor(cfg.head_dim**-0.5, dtype=dt)
        A.update_cache_full(self_kv, k, v, pos, self_block)
        cpos = A.cache_positions_full(cap, pos + 1, B, self_block)
        o = A.decode_heads(q, self_kv["k"], self_kv["v"], cpos, qpos, window=None, softcap=None,
                           block=self_block, mesh=hmesh)
        x = x + _attn_out(o, sa["wo"], dt, hmesh)

        dt = x.dtype
        ca = p["cross_attn"]
        c = apply_layernorm(p["cross_norm"], x, cfg.norm_eps)
        if hmesh is not None:
            c = C.copy_to_model(c, hmesh)
        qc = torch.einsum("bsd,dnh->bsnh", c, ca["wq"].to(dt))
        qc = qc * torch.tensor(cfg.head_dim**-0.5, dtype=dt)
        oc = A.decode_heads(qc, cross_kv["k"], cross_kv["v"], mpos, mq, window=None,
                            softcap=None, block=cross_block, mesh=hmesh)
        x = x + _attn_out(oc, ca["wo"], dt, hmesh)

        m = apply_layernorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + apply_mlp(p["mlp"], m, cfg.act, mesh=mmesh)
    x = apply_layernorm(params["decoder_norm"], x, cfg.norm_eps)
    logits = apply_unembed(params["embed"], x[:, 0], softcap=cfg.final_logit_softcap, mesh=vmesh)
    return logits, cache
