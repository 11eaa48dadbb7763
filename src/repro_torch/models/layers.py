"""Shared building blocks (port of ``src/repro/models/layers.py``).

Parameters are nested dicts of tensors, ``init_*`` builds them from a
``torch.Generator`` on ``device`` and ``apply_*`` applies them, as in the
reference.  On the ``meta`` device ``init_*`` only allocates shapes — the
port's ``jax.eval_shape``.  Activations follow the reference's dtypes: every
matmul takes the activation-dtype cast of the f32 params.

Under a running ``model`` axis (:mod:`repro_torch.sharding.collectives`)
the embedding, unembedding and MLP take this rank's blocks of their
weights, the vocab or d_ff split over ``model`` (Megatron-style), when
their params are blocks; params held whole run the one-process path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C

Params = dict[str, Any]
f32 = torch.float32


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


def truncated_normal(gen, shape, scale, device, dtype=f32) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to ``[-2, 2]`` (the reference's
    initializer; the draws are torch's, not jax's)."""
    t = torch.empty(shape, dtype=f32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(scale)
    return t.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device, dtype=f32) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(f32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(f32))).to(x.dtype)


def init_layernorm(d: int, device, dtype=f32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(f32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(f32) + p["bias"].to(f32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, device, dtype=f32) -> Params:
    return {"embedding": truncated_normal(gen, (vocab, d), 1.0 / np.sqrt(d), device, dtype)}


def apply_embedding(p: Params, tokens: torch.Tensor, *, scale: bool, act_dtype,
                    mesh) -> torch.Tensor:
    """Token embeddings.  With ``mesh`` (the table split over vocab,
    :func:`~repro_torch.sharding.collectives.vocab_mesh`) ``p`` is the
    rank's vocab block: each rank looks up the tokens in its range, zeroes
    the rest, and one all-reduce over ``model`` sums the blocks."""
    emb = p["embedding"].to(act_dtype)
    if mesh is None:
        x = F.embedding(tokens, emb)
    else:
        v_loc = emb.shape[0]
        local = tokens - mesh.index("model") * v_loc
        inside = (local >= 0) & (local < v_loc)
        x = F.embedding(torch.where(inside, local, 0), emb)
        x = C.reduce_from_model(torch.where(inside[..., None], x, 0.0), mesh, "embed")
    if scale:
        x = x * torch.tensor(np.sqrt(emb.shape[-1]), dtype=act_dtype)
    return x


def apply_unembed(p: Params, x: torch.Tensor, *, softcap: float | None,
                  mesh) -> torch.Tensor:
    """Logits; with ``mesh`` (as :func:`apply_embedding`) the logits of the
    rank's vocab block only, ``(..., V / model)`` (x is the column-parallel
    input)."""
    if mesh is not None:
        x = C.copy_to_model(x, mesh)
    logits = x @ p["embedding"].to(x.dtype).t()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# Depthwise causal conv (the RG-LRU and Mamba branches)
# ---------------------------------------------------------------------------

def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, in ``u``'s dtype.  u: (B, S, C), w: (K, C).

    ``sum_k w[k, c] * u[t - (K-1) + k, c]``, summed in the reference's order."""
    K = w.shape[0]
    upad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(upad[:, k:k + u.shape[1], :] * w[k][None, None, :] for k in range(K))
    return out + b[None, None, :]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def init_mlp(gen, d: int, f: int, gated: bool, device, dtype=f32) -> Params:
    p: Params = {
        "w_up": truncated_normal(gen, (d, f), 1.0 / np.sqrt(d), device, dtype),
        "w_down": truncated_normal(gen, (f, d), 1.0 / np.sqrt(f), device, dtype),
    }
    if gated:
        p["w_gate"] = truncated_normal(gen, (d, f), 1.0 / np.sqrt(d), device, dtype)
    return p


def mlp_mesh(cfg):
    """The running mesh when the layout splits the dense MLP's d_ff over
    ``model`` (:func:`~repro_torch.sharding.collectives.layout_mesh`), else
    None."""
    return C.layout_mesh("w_up", (cfg.d_model, cfg.d_ff))


def apply_mlp(p: Params, x: torch.Tensor, act: str, *, mesh, seq=None) -> torch.Tensor:
    """The (gated) MLP.  With ``mesh`` (d_ff split over ``model``) ``p`` is
    the rank's d_ff block: ``w_gate`` / ``w_up`` column-split, ``w_down``
    row-split, and one all-reduce over ``model``.  With ``seq`` x and the
    output are the rank's chunks of the sequence, gathered before and
    reduce-scattered after (:func:`~repro_torch.sharding.collectives.enter_linear`)."""
    _, *h = C.enter_linear(x, mesh, seq, mlp_in(p, x.dtype))
    return C.leave_model(mlp_out(p, h, act), mesh, "mlp", seq)


def mlp_in(p: Params, dt) -> list:
    """The MLP's column-parallel weights in ``dt``: ``w_up`` and, gated,
    ``w_gate``."""
    return [p["w_up"].to(dt)] + ([p["w_gate"].to(dt)] if "w_gate" in p else [])


def mlp_out(p: Params, h: list, act: str) -> torch.Tensor:
    """The MLP from its column-parallel products ``h`` (the input times
    :func:`mlp_in`'s weights) before the sum over ``model`` of a row-split
    ``w_down``: a partial sum with the rank's d_ff block, the output with
    the whole MLP.  ``h`` is emptied, so that no product outlives its use
    (a serving pass holds none of them through the down projection)."""
    up, *gate = h
    h.clear()
    hidden = _act(act, gate.pop()) * up if gate else _act(act, up)
    del up
    return hidden @ p["w_down"].to(hidden.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The reference's float64 frequencies, rounded to f32 — computed on the
    device itself: a host table copied in per call would wait for the device
    (a pageable host-to-device copy synchronizes) four times per layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / (theta ** exps)).to(f32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].to(f32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal position table ``(n, d)``: angles in
    float64, stored as float32, exactly the reference's numpy."""
    pos = np.arange(n)[:, None].astype(np.float64)
    dim = np.arange(0, d, 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((n, d), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


_POSITION_TABLES: dict = {}


def position_table(n: int, d: int, device, dtype) -> torch.Tensor:
    """:func:`sinusoidal_positions` as a tensor on ``device`` in ``dtype``,
    built once per (n, d, device, dtype): a decode step reads a row of it
    and would otherwise copy the table in, and wait for it, every step."""
    key = (n, d, str(torch.device(device)), dtype)
    if key not in _POSITION_TABLES:
        _POSITION_TABLES[key] = torch.from_numpy(sinusoidal_positions(n, d)).to(device, dtype)
    return _POSITION_TABLES[key]


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


@dataclasses.dataclass(frozen=True)
class LayerIO:
    """What a mixing layer needs to know about the token geometry."""

    positions: torch.Tensor  # (batch, seq) absolute positions
    causal: bool = True
