"""RG-LRU recurrent block (port of ``src/repro/models/rglru.py``;
recurrentgemma-9b / Griffin, arXiv:2402.19427).

Griffin's recurrent block:

    x -> norm -> [branch A: linear -> conv1d(k=4) -> RG-LRU]
              -> [branch B: linear -> GeLU]
    y = out_proj(A * B)

RG-LRU recurrence (eq. 1–4 of the Griffin paper), in log space:

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    a_t = exp(c * r_t * log sigmoid(Lambda)),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Under ``cfg.use_pallas`` the recurrence runs the hand-written RG-LRU kernel
(:mod:`repro_torch.kernels.rg_lru`; the plain version on a CPU tensor), as
the reference runs its Pallas kernel.  Decode is O(1): the cache carries the
conv window and h, and :func:`apply_rglru_step` updates it IN PLACE.

Under a running ``model`` axis whose storage layout splits the width
(:func:`lru_mesh`), the params are the rank's blocks of ``W / model``
channels and the layer runs them Megatron-style: ``in_x`` and ``in_gate``
column-parallel, the conv on the rank's channels; the gates' ``w_a`` /
``w_i`` are column blocks whose input is the whole width (the reference's
``(None, "model")``), so the conv output is gathered over ``model`` first,
while the gated input takes the rank's own channels; the recurrence (the
kernel on ``(B, S, W / model)``) on the rank's channels; ``out_proj``
row-parallel.  The decode cache holds the rank's channels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.rg_lru.cuda import rg_lru
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.models.layers import Params, causal_conv, truncated_normal
from repro_torch.sharding import collectives as C

_C = 8.0  # Griffin's fixed gate sharpness
f32 = torch.float32


def init_rglru(gen, cfg, device) -> Params:
    d, w, kconv = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    s = 1.0 / np.sqrt(d)
    # Lambda init so a = sigmoid(Lambda) in [0.9, 0.999]: the reference's own
    # numpy draw, so this leaf is identical in both packages
    u = np.random.RandomState(1).uniform(0.9, 0.999, size=(w,))
    lam = torch.from_numpy(np.log(u / (1.0 - u)).astype(np.float32))
    return {
        "in_x": truncated_normal(gen, (d, w), s, device),  # recurrent branch
        "in_gate": truncated_normal(gen, (d, w), s, device),  # GeLU branch
        "conv_w": truncated_normal(gen, (kconv, w), 1.0 / np.sqrt(kconv), device),
        "conv_b": torch.zeros((w,), dtype=f32, device=device),
        "w_a": truncated_normal(gen, (w, w), 1.0 / np.sqrt(w), device),
        "b_a": torch.zeros((w,), dtype=f32, device=device),
        "w_i": truncated_normal(gen, (w, w), 1.0 / np.sqrt(w), device),
        "b_i": torch.zeros((w,), dtype=f32, device=device),
        "lambda_": lam.to(device),
        "out_proj": truncated_normal(gen, (w, d), 1.0 / np.sqrt(w), device),
    }


def lru_mesh(cfg):
    """The running mesh when the layout splits the width over ``model``
    (:func:`~repro_torch.sharding.collectives.layout_mesh`), else None."""
    return C.layout_mesh("in_x", (cfg.d_model, cfg.lru_width or cfg.d_model))


def _gates(p: Params, u: torch.Tensor, mesh):
    """u: (B, S, W) -> log_a: (B, S, W) f32, gated input x_t: (B, S, W) f32.
    With ``mesh`` u is the rank's channels, gathered over ``model`` for the
    gates' products (module docstring)."""
    dt = u.dtype
    whole = u if mesh is None else C.gather_over_model(u, mesh, "lru_gather")
    r = torch.sigmoid((whole @ p["w_a"].to(dt)).to(f32) + p["b_a"])
    i = torch.sigmoid((whole @ p["w_i"].to(dt)).to(f32) + p["b_i"])
    log_a = _C * r * F.logsigmoid(p["lambda_"])[None, None, :]  # <= 0
    a2 = torch.exp(2.0 * log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * u.to(f32))
    return log_a, x_in


def _branches(p: Params, x: torch.Tensor, mesh, seq=None):
    """The recurrent branch before its conv, and the GeLU branch (with
    ``seq``, of the sequence gathered from the ranks' chunks)."""
    dt = x.dtype
    _, u, g = C.enter_linear(x, mesh, seq, [p["in_x"].to(dt), p["in_gate"].to(dt)])
    return u, F.gelu(g, approximate="tanh")


def _out(p: Params, h: torch.Tensor, g: torch.Tensor, mesh, seq=None) -> torch.Tensor:
    out = (h.to(g.dtype) * g) @ p["out_proj"].to(g.dtype)
    return C.leave_model(out, mesh, "lru_out", seq)


def _forward(p: Params, x: torch.Tensor, cfg, seq=None):
    """Full-sequence pass -> (out, the branch before its conv, ys).

    Under ``cfg.use_pallas`` the recurrence runs the :func:`rg_lru` wrapper
    (the kernel on the card), else the plain loop, as the reference's
    ``lax.scan``.  Under :func:`lru_mesh` on the rank's channels (module
    docstring); with ``seq`` x and the output are the rank's chunks of the
    sequence (:func:`~repro_torch.sharding.collectives.enter_linear`)."""
    dt = x.dtype
    mesh = lru_mesh(cfg)
    u_raw, g = _branches(p, x, mesh, seq)
    u = causal_conv(u_raw, p["conv_w"].to(dt), p["conv_b"].to(dt))
    log_a, x_in = _gates(p, u, mesh)
    ys = rg_lru(log_a, x_in) if cfg.use_pallas else rg_lru_ref(log_a, x_in)
    return _out(p, ys, g, mesh, seq), u_raw, ys


def apply_rglru(p: Params, x: torch.Tensor, cfg, seq=None) -> torch.Tensor:
    """Full-sequence path.  x: (B, S, D), or with ``seq`` the rank's chunk
    of it."""
    return _forward(p, x, cfg, seq)[0]


def init_rglru_cache(batch: int, cfg, dtype, device) -> Params:
    """A zero cache; under :func:`lru_mesh` of the rank's ``W / model``
    channels."""
    mesh = lru_mesh(cfg)
    w = cfg.lru_width or cfg.d_model
    if mesh is not None:
        w //= mesh.shape["model"]
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=f32, device=device),
    }


def apply_rglru_step(p: Params, x: torch.Tensor, cache: Params, cfg):
    """x: (B, 1, D) -> (y, cache), the cache updated in place."""
    dt = x.dtype
    mesh = lru_mesh(cfg)
    u, g = _branches(p, x, mesh)
    # the reference's jnp type promotion: an f32 cache lifts the window, the
    # conv and the gates to f32 under bf16 activations
    wd = torch.promote_types(cache["conv"].dtype, dt)
    win = torch.cat([cache["conv"].to(wd), u.to(wd)], dim=1)  # (B, K, W)
    u_c = (torch.einsum("bkw,kw->bw", win, p["conv_w"].to(dt).to(wd))[:, None, :]
           + p["conv_b"].to(dt).to(wd))
    log_a, x_in = _gates(p, u_c, mesh)
    h = torch.exp(log_a[:, 0]) * cache["h"] + x_in[:, 0]
    out = _out(p, h[:, None, :], g, mesh)
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return out, cache


def rglru_prefill_cache(p: Params, x: torch.Tensor, cfg, dtype, seq=None):
    """Full-sequence pass that also emits the decode cache.

    The reference always runs its own ``lax.scan`` a second time here and
    takes its final carry as ``h``.  This port takes ``h = ys[:, -1]`` from
    the recurrence that gave the output: the same value, since the
    recurrence starts from ``h0 = 0`` — and on the card a Python loop of S
    steps in every recurrent layer would dwarf the rest of the prefill.
    """
    out, u_raw, ys = _forward(p, x, cfg, seq)
    K = cfg.ssm_conv
    # copies, not views: a view would keep the whole (B, S, W) tensor alive
    return out, {"conv": u_raw[:, -(K - 1):, :].to(dtype).clone(), "h": ys[:, -1].clone()}
