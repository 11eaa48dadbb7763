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

Under :func:`~repro_torch.sharding.use_sharding_rules` with a running
:class:`~repro_torch.launch.mesh.Mesh` whose :func:`moe_layout` is sharded
(a ``model`` axis of more than one process, or the weights-stationary
layout at any ``model`` width, 1 included, as the reference's branch
condition), :func:`apply_moe` takes the reference's two ``shard_map``
branches, written as explicit collectives over the mesh's process groups.
Each process holds its own batch rows and its own block of the expert
stacks (:func:`local_expert_params` slices them; stacks held whole raise);
the router is replicated.  The shared expert is the dense MLP of
:func:`~repro_torch.models.layers.apply_mlp`: column- and row-split over
``model`` with one all-reduce in the port's storage layout
(:func:`repro_torch.training.init_params`), whole in the layout of
:func:`local_expert_params`, which slices the expert stacks alone.

* **Expert-parallel**: the stacks hold ``E / n_model`` experts.  Each rank
  routes its own tokens over all experts, runs its experts
  (``_routed_local`` with its ``e_start``) and the partial outputs are summed
  over ``model`` (one all-reduce); aux is averaged over every rank.  The
  dispatch needs no communication, since tokens are replicated over
  ``model``.
* **Weights-stationary** (``cfg.moe_weights_stationary``, a ``data`` axis
  that divides d_ff): the stacks also split d_ff over ``data``.  The tokens
  of the ``data`` group are gathered, each rank runs its f-slice of its
  experts on all of them, the outputs are summed over every rank, and each
  rank keeps its own rows.  Expert weights never move.  Every rank routes
  the data group's tokens with the capacity of all of them, so the routes,
  the drops and aux are those of one process on the whole global batch
  (not the mean over data shards that the expert-parallel layout
  computes); with one ``model`` rank nothing is summed over ``model``.

The collectives are :mod:`repro_torch.sharding.collectives`' (one byte
counter for the MoE's and the dense layers').  The gather is an all-reduce
of a zero-filled ``(n_data, T_loc, D)`` buffer in
which each rank fills its own rows: gloo reduces CUDA tensors but does not
gather them, and NCCL refuses two ranks on one card, so this one form runs on
gloo with several processes on one card and on NCCL with one card each.

Gradients (when one is asked for) follow the data-parallel convention: the
step's loss is the SUM over data groups of each group's loss, which the
model ranks of a group compute alike (and count once); the caller sums the
gradients of the leaves replicated over the batch axes (router, shared
expert, and the expert stacks unless weights-stationary) over those axes,
as data-parallel training does.  Each collective's backward follows from
that: a sum over ``model`` of partial outputs passes its cotangent through;
a sum over the batch axes (the token gather, the weights-stationary
combine, aux) sums the cotangents over them; and the replicated inputs of
the partial expert computation (the tokens and the router) sum their
cotangents over ``model``.  ``tests/test_torch_moe_ep.py`` holds every
rank's gradient to the one-process gradient.
The expert products are plain matrix products in the reference too
(outside any Pallas kernel), so ``torch.bmm`` is their counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.layers import Params, apply_mlp, mlp_in, mlp_out, truncated_normal, _act
from repro_torch.sharding.collectives import (  # noqa: F401  (the counter is re-exported)
    COLLECTIVE_BYTES,
    _gather,
    _sum_over,
    _to_model,
    copy_to_model,
    enter_linear,
    model_mesh,
    reset_collective_bytes,
    scatter_seq,
    sharded_mesh,
)

__all__ = ["init_moe", "capacity_for", "route", "apply_moe", "local_expert_params", "moe_layout",
           "sharded_layout",
           "COLLECTIVE_BYTES", "reset_collective_bytes"]

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


def route(xt: torch.Tensor, p: Params, cfg, logits: torch.Tensor | None = None):
    """The f32 router: xt (T, D) -> (probs (T, E) f32, top-k probabilities
    (T, K) renormalised in f32 and cast to xt's dtype, top-k expert ids
    (T, K)).  ``logits``: xt's f32 product with the router, where the
    caller has it already (:func:`apply_moe` under sequence parallelism)."""
    E, n = cfg.experts_padded, cfg.num_experts
    if logits is None:
        logits = xt.to(f32) @ p["router"].to(f32)
    if E != n:
        ids = torch.arange(E, device=xt.device)
        logits = logits + torch.where(ids >= n, -1e30, 0.0).to(f32)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    topk_p = (topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)).to(xt.dtype)
    return probs, topk_p, topk_idx


def _expert_ffn(xin: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    """xin: (E_loc, C, D) -> (E_loc, C, D) through the (E_loc, D, F) /
    (E_loc, F, D) stacks, cast to xin's dtype."""
    dt = xin.dtype
    gate = torch.bmm(xin, p["w_gate_e"].to(dt))
    up = torch.bmm(xin, p["w_up_e"].to(dt))
    return torch.bmm(_act(act, gate) * up, p["w_down_e"].to(dt))


def _routed_local(xt: torch.Tensor, p: Params, cfg, C: int, e_start: int = 0,
                  e_local: int | None = None, logits: torch.Tensor | None = None):
    """Dispatch -> expert FFN -> weighted combine for experts
    ``[e_start, e_start + e_local)`` (default: all E), whose stacks are
    exactly ``p``'s.  xt: (T, D) -> (partial out (T, D), zero rows where the
    token's experts live elsewhere; aux f32 scalar); ``logits``: see
    :func:`route`."""
    dt = xt.dtype
    T, D = xt.shape
    E, K, n = cfg.experts_padded, cfg.top_k, cfg.num_experts
    e_local = E if e_local is None else e_local

    probs, topk_p, topk_idx = route(xt, p, cfg, logits)
    pos, counts = _slot_assignment(topk_idx, E)
    keep = (topk_idx >= e_start) & (topk_idx < e_start + e_local) & (pos < C)
    # dropped or elsewhere -> the trash row
    dest = torch.where(keep, (topk_idx - e_start) * C + pos, e_local * C)

    buf = torch.zeros((e_local * C + 1, D), dtype=dt, device=xt.device)
    for kk in range(K):  # K scatters, each to distinct rows but the trash row
        buf = buf.index_copy(0, dest[:, kk], xt)
    eout = _expert_ffn(buf[:e_local * C].reshape(e_local, C, D), p,
                       cfg.act).reshape(e_local * C, D)
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


class MoeLayout(NamedTuple):
    """Where an MoE layer runs over a layout (:func:`moe_layout`)."""

    batch_axes: tuple[str, ...]
    n_model: int
    n_data: int
    stationary: bool  # the weights-stationary branch

    @property
    def sharded(self) -> bool:
        """Whether :func:`apply_moe` takes a sharded branch; else every
        rank routes its own rows over all experts, as one process."""
        return self.n_model > 1 or self.stationary


def moe_layout(cfg, mesh) -> MoeLayout:
    """The one decision of where an MoE layer runs over ``mesh`` (its
    sizes are read, so a planning mesh gives a running one's answer), which
    :func:`apply_moe`, :func:`local_expert_params`, the loss's aux
    convention and ``launch.analysis.port_collective_bytes`` read.  As the
    reference's branch condition, the weights-stationary branch runs
    whenever the config asks for it and a batch axis divides the expert
    d_ff, ``model`` of 1 included; its ``(B * S) % n_data`` test holds by
    construction here, since each rank holds whole batch rows."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_data = mesh.size(batch_axes) if batch_axes else 1
    stationary = bool(cfg.moe_weights_stationary and batch_axes
                      and cfg.d_ff_expert % n_data == 0)
    return MoeLayout(batch_axes, mesh.shape.get("model", 1), n_data, stationary)


def local_expert_params(p: Params, cfg, mesh) -> Params:
    """This rank's block of an MoE param tree (any tree holding ``*_e``
    stacks, stacked layers included): the expert axis (dim -3) sliced over
    ``model``, and for the weights-stationary layout d_ff sliced over the
    batch axes; everything else is returned as is (replicated)."""
    batch_axes, n_model, n_data, stationary = moe_layout(cfg, mesh)
    E = cfg.experts_padded
    if E % n_model:
        raise ValueError(f"experts {E} must divide the model axis {n_model}")
    e_local = E // n_model
    f_local = cfg.d_ff_expert // n_data if stationary else cfg.d_ff_expert
    e0 = mesh.index("model") * e_local
    f0 = mesh.index(batch_axes) * f_local if stationary else 0

    def one(name, t):
        if not name.endswith("_e"):
            return t
        t = t.narrow(-3, e0, e_local)
        f_dim = -2 if name == "w_down_e" else -1
        return t.narrow(f_dim, f0, f_local).contiguous()

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else one(k, v)) for k, v in node.items()}

    return walk(p)


def _apply_sharded(p: Params, x: torch.Tensor, cfg, mesh, layout: MoeLayout, seq=None,
                   logits=None):
    """The reference's two ``shard_map`` branches (module docstring).  x is
    this rank's rows (B_loc, S, D); returns (out (B_loc, S, D), aux).  With
    one ``model`` rank (weights-stationary alone) nothing is summed over
    ``model``.  With ``seq`` x is already gathered from the ranks' chunks
    of the sequence (its backward sums the tokens' cotangents over
    ``model``), expert-parallel with its router ``logits`` (B_loc, S, E)
    from the same gather, and out is the rank's chunk: the expert-parallel
    partial sums reduce-scattered, the weights-stationary sum cut."""
    Bl, S, D = x.shape
    E = cfg.experts_padded
    batch_axes, n_model, n_data, stationary = layout
    e_local = E // n_model
    if E % n_model or p["w_gate_e"].shape[-3] != e_local:
        raise ValueError(f"under a model axis of {n_model} the expert stacks must hold this "
                         f"rank's {E} / {n_model} experts (local_expert_params), not "
                         f"{p['w_gate_e'].shape[-3]}")
    e_start = mesh.index("model") * e_local
    model_axes = ("model",) if n_model > 1 else ()
    world = mesh.group(model_axes + batch_axes)
    data = mesh.group(batch_axes) if batch_axes else None

    def to_model(t):
        return _to_model(t, mesh) if n_model > 1 else t

    def tokens(t):
        return t if seq is not None else to_model(t)

    p = {**p, "router": to_model(p["router"])}
    T_loc = Bl * S
    xt = x.reshape(T_loc, D)
    if stationary:
        # gather the data group's tokens: each rank fills its own rows of a
        # zero buffer and the buffer is summed (module docstring)
        d_idx = mesh.index(batch_axes)
        xg = _gather(xt, data, n_data, d_idx, "gather", dim=0)
        C = capacity_for(n_data * T_loc, E, cfg.top_k, cfg.capacity_factor)
        out, aux = _routed_local(tokens(xg), p, cfg, C, e_start, e_local)
        out = _sum_over(out, world, "combine", back=data)
        out = scatter_seq(out.reshape(n_data, T_loc, D)[d_idx].reshape(Bl, S, D), seq,
                          summed=False)
    else:
        C = capacity_for(T_loc, E, cfg.top_k, cfg.capacity_factor)
        out, aux = _routed_local(tokens(xt), p, cfg, C, e_start, e_local,
                                 None if logits is None else logits.reshape(T_loc, E))
        out = out.reshape(Bl, S, D)
        if seq is None:
            out = _sum_over(out, mesh.group("model"), "combine")
        else:
            out = scatter_seq(out, seq, summed=True)
    aux = _sum_over(aux.reshape(1), world, "aux", back=data)[0] / (n_model * n_data)
    return out, aux


def sharded_layout(cfg) -> tuple | None:
    """``(running mesh, its :func:`moe_layout`)`` when :func:`apply_moe`
    takes a sharded branch under the current rules, else None."""
    mesh = sharded_mesh()
    if mesh is None:
        return None
    layout = moe_layout(cfg, mesh)
    return (mesh, layout) if layout.sharded else None


def apply_moe(p: Params, x: torch.Tensor, cfg, seq=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Under a running mesh whose
    :func:`moe_layout` is sharded, x and the expert stacks are this rank's
    blocks (module docstring).  With ``seq``
    (:func:`~repro_torch.sharding.collectives.seq_mesh`) x and out are the
    rank's chunks of the sequence: x is gathered once (only the chunk kept
    for the backward: :func:`~repro_torch.sharding.collectives.enter_linear`)
    for the expert-parallel router, the experts and a shared expert split
    over ``model``, whose outputs are reduce-scattered; the shared expert's
    sigmoid gate, and a shared expert held whole, run token by token on the
    chunk, their weights' gradients (of the chunk's rows) summed over
    ``model``."""
    B, S, D = x.shape
    run = sharded_layout(cfg)
    shared = p.get("shared")
    mesh = model_mesh()
    # split in the storage layout, whole in local_expert_params' (module
    # docstring)
    split = shared is not None and mesh is not None and \
        shared["w_up"].shape[-1] < cfg.shared_expert_ff
    xin, logits, h = x, None, []
    if seq is not None:
        # the weights-stationary branch routes the data group's tokens
        router = [] if run[1].stationary else [_to_model(p["router"], mesh).to(f32)]
        xin, *h = enter_linear(x, mesh, seq, router + (mlp_in(shared, x.dtype) if split else []))
        logits = h.pop(0) if router else None
    if run is not None:
        out, aux = _apply_sharded(p, xin, cfg, *run, seq=seq, logits=logits)
    else:
        C = capacity_for(B * S, cfg.experts_padded, cfg.top_k, cfg.capacity_factor)
        out, aux = _routed_local(x.reshape(B * S, D), p, cfg, C)
        out = out.reshape(B, S, D)
    if shared is not None:
        if seq is not None and split:
            sh = scatter_seq(mlp_out(shared, h, cfg.act), seq, summed=True)
            gate = copy_to_model(shared["gate_proj"], seq)
        else:
            held = shared if seq is None else {k: copy_to_model(w, seq) for k, w in shared.items()}
            sh = apply_mlp(held, x, cfg.act, mesh=mesh if split else None)
            gate = held["gate_proj"]
        sgate = torch.sigmoid(x @ gate.to(x.dtype))
        out = out + sgate * sh
    return out, aux
