"""Top-level model API, one entry point for every arch (port of
``src/repro/models/model.py``).

``init_model`` / ``forward`` / ``loss_fn`` / ``init_decode_state`` /
``decode_step`` / ``prefill`` dispatch on the config's family:

* decoder-only (dense, moe, ssm, hybrid): embedding -> block stack
  (:mod:`repro_torch.models.transformer`) -> final norm -> (tied) unembed;
* vlm: the same trunk, with ``prefix_embeds`` ``(B, P, D)`` (the vision
  projector stub's output) ahead of the token embeddings at positions
  ``0..P-1``; their rows leave the logits, so the logits align with the
  tokens;
* audio (whisper): the encoder-decoder of :mod:`repro_torch.models.whisper`,
  fed ``enc_embeds`` ``(B, T_enc, D)`` by the conv frontend stub.

A batch is a dict: ``tokens`` (B, S) int, always; ``labels`` (B, S) int for
training, ``-1`` masking a position; ``prefix_embeds`` (vlm) and
``enc_embeds`` (audio).  The loss adds ``router_aux_coef`` x the router's
load-balance loss for configs with experts.  Serving runs without autograd;
a decode step updates the cache in place and returns it.

Under ``use_sharding_rules`` with a running sharded mesh the params are
this rank's blocks (:func:`repro_torch.training.steps.init_params`): over
``data`` too (the reference's FSDP storage), where every entry point
gathers the weights outside the layer stacks (the embedding, the
unembedding) once over ``data`` and the stacks gather theirs layer by
layer (:func:`~repro_torch.sharding.collectives.gather_weights`).  With
more than one ``model`` process ``forward`` /
``prefill`` / ``decode_step`` return the logits of the rank's vocab block
(``V / model``); :func:`cross_entropy` reduces them over ``model``.  Every
layer of the ten archs shards: attention, MLP, embedding and unembedding,
the MoE's experts, attention and shared expert, the Mamba and RG-LRU
layers' inner width, whisper's encoder and cross-attention.  A vocab that
``model`` does not divide (internvl2-2b's 92,553) keeps the embedding, the
unembedding and the logits whole on every rank
(:func:`~repro_torch.sharding.collectives.vocab_mesh` is None); a vlm
prefix joins the token embeddings after the vocab-parallel lookup's
all-reduce.  Params held whole raise at ``forward`` / ``prefill`` /
``decode_step``.  With ``cfg.sequence_parallel``
(:func:`~repro_torch.sharding.collectives.seq_mesh` of the P + S
positions) ``forward`` and ``prefill`` cut the embeddings to the rank's
chunk of the sequence before the stack, and gather the stack's output
(``forward``: after the final norm, which runs on the chunk) before the
unembedding; ``cfg.shard_grads`` changes nothing (the gradients come out
in each weight's storage layout already).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.layers import (
    LayerIO,
    Params,
    apply_embedding,
    apply_unembed,
    dtype_of,
    init_embedding,
)
from repro_torch.sharding import collectives as C

__all__ = ["init_model", "forward", "cross_entropy", "loss_fn", "init_decode_state", "decode_step",
           "prefill"]

f32 = torch.float32


def init_model(gen, cfg, device) -> Params:
    """The whole param tree (blocks are sliced from it by the caller:
    :func:`repro_torch.training.steps.init_params`)."""
    if cfg.is_encoder_decoder:
        return W.init_whisper(gen, cfg, device)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "stack": T.init_stack(gen, cfg, device),
        "final_norm": T._norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, device)
    return params


def _vocab_layout(params: Params, cfg):
    """:func:`~repro_torch.sharding.collectives.vocab_mesh`, once the params
    are checked to be this rank's blocks under a running sharded mesh
    (:func:`~repro_torch.sharding.specs.check_local_params`)."""
    mesh = C.sharded_mesh()
    if mesh is None:
        return None
    from repro_torch.sharding.specs import check_local_params

    check_local_params(params, cfg, mesh)
    return C.vocab_mesh(cfg)


_STACKS = ("stack", "encoder", "decoder")


def _outer(params: Params, cfg) -> Params:
    """``params`` with the leaves outside the layer stacks (the embedding,
    the unembedding, the final norms) gathered over ``data``, once for the
    step: a tied table's embedding and unembedding read one gather."""
    return {k: v if k in _STACKS else C.gather_weights(v, k, cfg) for k, v in params.items()}


def _embed_with_prefix(params: Params, batch: dict[str, Any], cfg, vmesh
                       ) -> tuple[torch.Tensor, LayerIO, int]:
    """Token embeddings, behind the vlm prefix if the config has one ->
    (x, the causal geometry of positions 0..P+S-1, P)."""
    act_dt = dtype_of(cfg.activation_dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens, scale=cfg.embed_scale, act_dtype=act_dt,
                        mesh=vmesh)
    n_prefix = 0
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(act_dt)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    total = n_prefix + S
    positions = torch.arange(total, device=tokens.device).unsqueeze(0).expand(B, total)
    return x, LayerIO(positions=positions, causal=True), n_prefix


def _encode(params: Params, batch: dict[str, Any], cfg) -> torch.Tensor:
    return W.encode(params, batch["enc_embeds"].to(dtype_of(cfg.activation_dtype)), cfg)


def forward(params: Params, batch: dict[str, Any], cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B, S, V) aligned with the tokens,
    aux_loss f32 scalar)."""
    vmesh = _vocab_layout(params, cfg)
    params = _outer(params, cfg)
    if cfg.is_encoder_decoder:
        logits = W.decode_train(params, batch["tokens"], _encode(params, batch, cfg), cfg,
                                vmesh=vmesh)
        return logits, torch.zeros((), dtype=f32, device=logits.device)
    x, io, n_prefix = _embed_with_prefix(params, batch, cfg, vmesh)
    seq = C.seq_mesh(cfg, x.shape[1])
    x, aux = T.apply_stack(params["stack"], C.scatter_seq(x, seq, summed=False), io, cfg)
    x = T._norm(cfg, T._norms_on_chunk(params, seq)["final_norm"], x)
    x = C.gather_seq(x, seq, summed=False)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = apply_unembed(params.get("unembed", params["embed"]), x,
                           softcap=cfg.final_logit_softcap, mesh=vmesh)
    return logits, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean CE in float32; labels < 0 are ignored.

    With ``mesh`` (the logits are this rank's vocab block,
    :func:`~repro_torch.sharding.collectives.vocab_mesh`) it takes the
    vocab-parallel form: the max, the sum of exponentials and the target's
    logit (from the rank that owns it) are reduced over ``model``, three
    ``(B, S)`` f32 all-reduces.  With more
    than one data rank the token count and the loss are summed over
    ``data``: every rank returns the token mean over the global batch, and
    its gradient is its rows' share of it (the caller sums the gradients
    over ``data``)."""
    logits = logits.to(f32)
    mask = (labels >= 0).to(f32)
    safe = torch.clamp(labels, min=0).long()
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        v_loc = logits.shape[-1]
        m = C.max_over(torch.amax(logits, dim=-1), mesh, "model", "logits")
        se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        lse = torch.log(C.reduce_from_model(se, mesh, "logits")) + m
        local = safe - mesh.index("model") * v_loc
        inside = (local >= 0) & (local < v_loc)
        ll = torch.gather(logits, -1, torch.clamp(local, 0, v_loc - 1)[..., None])[..., 0]
        ll = C.reduce_from_model(torch.where(inside, ll, 0.0), mesh, "logits")
    nll = (lse - ll) * mask
    n_tok = mask.sum()
    data = C.sharded_mesh()
    if data is not None and C.data_size(data) > 1:
        n_tok = C.sum_over_data(n_tok, data, "loss")
        denom = torch.clamp(n_tok, min=1.0)
        return C.sum_over_data(nll.sum() / denom, data, "loss"), denom
    denom = torch.clamp(n_tok, min=1.0)
    return nll.sum() / denom, denom


def loss_fn(params: Params, batch: dict[str, Any], cfg) -> tuple[torch.Tensor, dict]:
    logits, aux = forward(params, batch, cfg)
    labels = batch.get("labels")
    if labels is None:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], -torch.ones_like(tokens[:, :1])], dim=1)
    ce, n_tok = cross_entropy(logits, labels, mesh=C.vocab_mesh(cfg))
    if cfg.num_experts:
        aux = _data_parallel_aux(aux, cfg)
        loss = ce + cfg.router_aux_coef * aux
    else:
        loss = ce
    return loss, {"ce": ce, "aux": aux, "n_tokens": n_tok}


def _data_parallel_aux(aux: torch.Tensor, cfg) -> torch.Tensor:
    """The router's aux loss under :func:`cross_entropy`'s data-parallel
    convention (every rank holds the global loss, its gradient is its
    rows' share, summed over ``data`` by the FSDP gather's backward or, for
    the leaves whole over ``data``, by the caller): the mean over
    the data ranks, the reference's ``pmean``.  Where the MoE routes each
    rank's rows alone (one model rank, not weights-stationary) the mean is
    taken here (one f32 all-reduce).  A sharded MoE branch
    (:func:`~repro_torch.models.moe.sharded_layout`: expert-parallel, or
    weights-stationary at any ``model`` width) returns that mean already,
    but its backward sums aux's cotangent over ``data``
    (:mod:`repro_torch.models.moe`: the loss is the sum over data groups),
    so its gradient is divided by the data ranks here."""
    from repro_torch.models.moe import sharded_layout

    mesh = C.sharded_mesh()
    n_data = 1 if mesh is None else C.data_size(mesh)
    if n_data == 1:
        return aux
    if sharded_layout(cfg) is None:
        return C.sum_over_data(aux.reshape(1), mesh, "aux")[0] / n_data
    return C.scale_grad(aux, 1.0 / n_data)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _check_serving(capacity: int, frames: int | None = None) -> None:
    """Under a running sharded mesh inside
    :func:`~repro_torch.sharding.collectives.serving` the rank's caches are
    laid out by its shape, and a decode step reads the capacity from it:
    the cache built here must be the one it describes."""
    shape = C.serve_shape()
    if shape is None or C.sharded_mesh() is None:
        return
    if shape.capacity != capacity or (frames is not None and shape.memory != frames):
        raise ValueError(f"a cache of {capacity} positions (encoder frames {frames}) built "
                         f"inside serving({shape}), which describes another")


@torch.no_grad()
def init_decode_state(params: Params, cfg, batch_size: int, capacity: int, *,
                      cache_dtype=torch.bfloat16, batch: dict[str, Any] | None = None) -> Params:
    """Fresh decode cache sized for ``capacity`` positions, on the params'
    device.  Whisper's holds the encoder memory's cross K/V, so ``batch``
    with ``enc_embeds`` must be given for encoder-decoder configs.  Under a
    running ``model`` axis the cache holds the rank's heads and channels;
    under ``SPEC_OPTIONS["seq_shard_cache"]`` an attention cache may hold
    the rank's block of the capacity instead
    (:func:`repro_torch.models.attention.cache_block`)."""
    _vocab_layout(params, cfg)  # the rank's blocks, checked
    if cfg.is_encoder_decoder:
        if batch is None or "enc_embeds" not in batch:
            raise ValueError("an encoder-decoder cache needs batch['enc_embeds']")
        _check_serving(capacity, batch["enc_embeds"].shape[1])
        return W.init_whisper_cache(params, _encode(params, batch, cfg), cfg, capacity,
                                    cache_dtype)
    _check_serving(capacity)
    device = params["embed"]["embedding"].device
    return T.init_stack_cache(cfg, batch_size, capacity, cache_dtype, device)


@torch.no_grad()
def decode_step(params: Params, cache: Params, token: torch.Tensor, pos, cfg):
    """One decode step.  token: (B,) int; pos: the absolute position, an int
    or a 0-d int tensor (a device tensor keeps the step free of host syncs).

    Returns (logits (B, V), cache), the cache updated in place.
    """
    vmesh = _vocab_layout(params, cfg)
    params = _outer(params, cfg)
    if cfg.is_encoder_decoder:
        return W.whisper_decode_step(params, cache, token, pos, cfg, vmesh=vmesh)
    act_dt = dtype_of(cfg.activation_dtype)
    x = apply_embedding(params["embed"], token[:, None], scale=cfg.embed_scale, act_dtype=act_dt,
                        mesh=vmesh)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    x, cache = T.apply_stack_step(params["stack"], x, cache, pos, cfg)
    x = T._norm(cfg, params["final_norm"], x)
    logits = apply_unembed(params.get("unembed", params["embed"]), x[:, 0],
                           softcap=cfg.final_logit_softcap, mesh=vmesh)
    return logits, cache


@torch.no_grad()
def prefill(params: Params, batch: dict[str, Any], cfg, capacity: int, *,
            cache_dtype=torch.bfloat16):
    """Process a prompt -> (last-position logits (B, V), decode cache).  A
    vlm prompt is its prefix and its tokens, so ``capacity`` counts both."""
    vmesh = _vocab_layout(params, cfg)
    params = _outer(params, cfg)
    if cfg.is_encoder_decoder:
        _check_serving(capacity, batch["enc_embeds"].shape[1])
        memory = _encode(params, batch, cfg)
        logits = W.decode_train(params, batch["tokens"], memory, cfg, vmesh=vmesh)
        return logits[:, -1], W.init_whisper_cache(params, memory, cfg, capacity, cache_dtype)
    _check_serving(capacity)
    x, io, _ = _embed_with_prefix(params, batch, cfg, vmesh)
    seq = C.seq_mesh(cfg, x.shape[1])
    x, cache = T.prefill_stack(params["stack"], C.scatter_seq(x, seq, summed=False), io, cfg,
                               capacity, cache_dtype)
    x = C.gather_seq(x, seq, summed=False)
    # the norm is row-wise: normalizing the last position alone is the same
    x = T._norm(cfg, params["final_norm"], x[:, -1])
    logits = apply_unembed(params.get("unembed", params["embed"]), x,
                           softcap=cfg.final_logit_softcap, mesh=vmesh)
    return logits, cache
