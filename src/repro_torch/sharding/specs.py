"""Parameter / state / batch / cache specs on a 2-D ``data x model`` layout
(port of ``src/repro/sharding/specs.py``).

Megatron-style tensor parallelism over ``model`` and FSDP-style storage
sharding over ``data`` (and ``pod`` when present):

* attention projections shard heads over ``model``, d_model over ``data``;
* the MLP shards d_ff over ``model``; the MoE shards the expert axis over
  ``model`` (expert parallelism) and the expert d_ff over ``data``;
* embedding / unembedding shard vocab over ``model``;
* the SSM and RG-LRU shard their inner width over ``model``;
* norm scales and other small vectors replicate.

Every function is a pure function of a leaf's path, its shape and the
layout, held exactly to the reference's (``tests/test_torch_sharding.py``).
A spec is a :class:`~repro_torch.sharding.ctx.PartitionSpec`, a tuple with
one entry per dimension; the rules key on the LAST dims of a leaf,
so a leading stacked-layer axis gets ``None``.  A leaf's path is its keys
joined by ``/`` (dict keys, tuple indices, dataclass field names), the
reference's ``_path_str`` of the same tree.

The reference's ``*_shardings`` functions wrap each spec in a
``NamedSharding`` for ``jax.jit``; the port has no partitioner to hand them
to, so :func:`local_shape` and :func:`local_shard` give this card's block of
a leaf instead, and :func:`local_template` the shapes of a rank's param
blocks under the port's storage layout (:func:`storage_spec_for`: the
reference's FSDP storage over ``data``, or with
``SPEC_OPTIONS["replicate_params_over_data"]`` every weight whole over
``data``).  :func:`gather_dim` names the dim a rank gathers over ``data``
before a layer runs.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch

from repro_torch.sharding.ctx import PartitionSpec as P

__all__ = [
    "param_spec_for",
    "tree_specs",
    "leaf_paths",
    "batch_shape_structs",
    "batch_specs",
    "worker_specs",
    "cache_spec_for",
    "cache_specs",
    "capacity_split",
    "auto_spec_for",
    "auto_specs",
    "local_shape",
    "local_shard",
    "block_box",
    "block_view",
    "owns_block",
    "block_part",
    "storage_spec_for",
    "gather_dim",
    "local_template",
    "localize",
    "check_local_params",
    "P",
    "SPEC_OPTIONS",
]

# Layout variants (set by the planner's flags).
SPEC_OPTIONS = {
    # Decode caches whose kv-head axis cannot shard over `model` normally
    # replicate; this instead shards the cache's capacity (sequence) axis.
    "seq_shard_cache": False,
    # Serving layout: params sharded over `model` only, replicated over `data`.
    "replicate_params_over_data": False,
}


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _data_axes(mesh):
    present = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return present if present else None


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    sizes = _axis_sizes(mesh)
    n = math.prod(sizes[a] for a in axes) if isinstance(axes, tuple) else sizes[axes]
    return dim % n == 0


# (path regex, trailing spec): first match wins.  The spec applies to the
# LAST len(spec) dims; leading dims (the stacked layers) get None.
_RULES: list[tuple[str, tuple | None]] = [
    # attention: wq/wk/wv (d, heads, hd); wo (heads, hd, d)
    (r"(wq|wk|wv)$", ("data", "model", None)),
    (r"wo$", ("model", None, "data")),
    # MoE expert stacks: experts over model, d_ff over data
    (r"w_(gate|up)_e$", ("model", None, "data")),  # (E, d, f)
    (r"w_down_e$", ("model", "data", None)),  # (E, f, d)
    (r"router$", ("data", None)),
    # dense MLP (d, f) / (f, d)
    (r"w_(gate|up)$", ("data", "model")),
    (r"w_down$", ("model", "data")),
    # embedding (vocab, d)
    (r"embedding$", ("model", "data")),
    # mamba: in_proj (d, 2di); out_proj (di, d); x_proj (di, k); dt_proj (r, di)
    (r"in_proj$", ("data", "model")),
    (r"out_proj$", ("model", "data")),
    (r"x_proj$", ("model", None)),
    (r"dt_proj$", (None, "model")),
    (r"a_log$", ("model", None)),
    (r"(d_skip|dt_bias)$", ("model",)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    # rg-lru: in_x/in_gate (d, w); w_a/w_i (w, w); gates (w,)
    (r"(in_x|in_gate)$", ("data", "model")),
    (r"(w_a|w_i)$", (None, "model")),
    (r"(b_a|b_i|lambda_)$", ("model",)),
    # shared-expert gate (d, 1)
    (r"gate_proj$", (None, None)),
    # norms and everything small: replicate
    (r"(scale|bias)$", None),
]


def _resolve(axis, mesh, dim: int):
    if axis is None:
        return None
    if axis == "data":
        if SPEC_OPTIONS["replicate_params_over_data"]:
            return None
        axes = _data_axes(mesh)
        return axes if axes is not None and _fits(dim, mesh, axes) else None
    if axis in mesh.axis_names and _fits(dim, mesh, axis):
        return axis
    return None


def param_spec_for(path: str, shape: tuple[int, ...], mesh) -> P:
    """The spec of one parameter leaf, by its path and shape."""
    for pattern, trailing in _RULES:
        if re.search(pattern, path):
            if trailing is None:
                return P()
            n = len(trailing)
            if len(shape) < n:
                return P()
            lead = (None,) * (len(shape) - n)
            tail = tuple(
                _resolve(ax, mesh, shape[len(shape) - n + i]) for i, ax in enumerate(trailing)
            )
            return P(*(lead + tail))
    return P()  # default: replicate (small or unknown leaves)


# ---------------------------------------------------------------------------
# Trees: nested dicts, tuples, lists and dataclasses (TrainState & co.)
# ---------------------------------------------------------------------------

def _children(node) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs in the reference's flattening order (dicts by
    sorted key, sequences by index, dataclasses by field), or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in order; ``None`` holds no leaf (as
    in the reference's trees)."""
    if tree is None:
        return []
    kids = None if isinstance(tree, P) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, c in kids:
        out.extend(leaf_paths(c, f"{prefix}/{k}" if prefix else k))
    return out


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, c, f"{prefix}/{i}" if prefix else str(i))
                          for i, c in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name),
                                   f"{prefix}/{f.name}" if prefix else f.name)
            for f in dataclasses.fields(tree) if f.init})
    return fn(prefix, tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def tree_specs(tree: Any, mesh) -> Any:
    """Every leaf's spec, in a tree of the same structure."""
    return _map_with_path(lambda path, leaf: param_spec_for(path, _shape(leaf), mesh), tree)


# ---------------------------------------------------------------------------
# Worker-axis specs (sharded async engine)
# ---------------------------------------------------------------------------

def worker_specs(tree: Any, mesh, axis: str = "workers") -> Any:
    """Every leaf's LEADING dim over the ``workers`` axis (replicated when
    the layout has no such axis or the dim does not divide it)."""

    def one(_, leaf) -> P:
        shape = _shape(leaf)
        if not shape or axis not in mesh.axis_names or not _fits(shape[0], mesh, axis):
            return P()
        return P(axis, *((None,) * (len(shape) - 1)))

    return _map_with_path(one, tree)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_shape_structs(cfg, *, batch: int, seq: int) -> dict[str, torch.Tensor]:
    """Shape-only stand-ins (``meta`` tensors) of a training / prefill batch."""
    meta = torch.device("meta")
    out = {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device=meta),
        "labels": torch.empty((batch, seq), dtype=torch.int32, device=meta),
    }
    if cfg.frontend == "vision":
        out["prefix_embeds"] = torch.empty((batch, cfg.num_prefix_embeddings, cfg.d_model),
                                           dtype=torch.bfloat16, device=meta)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.empty((batch, cfg.encoder_positions, cfg.d_model),
                                        dtype=torch.bfloat16, device=meta)
    return out


def batch_specs(cfg, mesh, *, batch: int) -> dict[str, P]:
    """The batch's leading dim over (pod, data) when it divides."""
    daxes = _data_axes(mesh)
    b_ax = daxes if daxes is not None and _fits(batch, mesh, daxes) else None
    spec2, spec3 = P(b_ax, None), P(b_ax, None, None)
    out = {"tokens": spec2, "labels": spec2}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = spec3
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = spec3
    return out


def cache_spec_for(path: str, shape: tuple[int, ...], mesh, batch: int) -> P:
    """A decode-cache leaf's spec.

    KV caches (..., B, C, n_kv, hd): batch over data, kv heads over model.
    Conv rings (..., B, K, W) and recurrent states (..., B, W) /
    (..., B, W, N): batch over data, width over model.
    """
    daxes = _data_axes(mesh)
    b_ax = daxes if daxes is not None and _fits(batch, mesh, daxes) else None
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("k", "v"):
        head_ax = _resolve("model", mesh, shape[-2])
        if head_ax is None and SPEC_OPTIONS["seq_shard_cache"]:
            # kv heads do not shard: shard the capacity axis instead
            tail = (b_ax, _resolve("model", mesh, shape[-3]), None, None)
        elif b_ax is None and SPEC_OPTIONS["seq_shard_cache"]:
            # batch 1: the data axis idles, so the capacity goes on it
            cap_ax = daxes if daxes is not None and _fits(shape[-3], mesh, daxes) else None
            tail = (None, cap_ax, head_ax, None)
        else:
            tail = (b_ax, None, head_ax, None)
    elif leaf == "conv":
        tail = (b_ax, None, _resolve("model", mesh, shape[-1]))
    elif leaf == "h":
        if len(shape) >= 3 and shape[-1] <= 64:  # ssm state (B, Di, N)
            tail = (b_ax, _resolve("model", mesh, shape[-2]), None)
        else:  # rg-lru state (B, W)
            tail = (b_ax, _resolve("model", mesh, shape[-1]))
    else:
        return P()
    lead = (None,) * (len(shape) - len(tail))
    return P(*(lead + tail))


def cache_specs(tree: Any, mesh, batch: int) -> Any:
    return _map_with_path(lambda path, leaf: cache_spec_for(path, _shape(leaf), mesh, batch),
                          tree)


def capacity_split(shape: tuple[int, ...], mesh,
                   batch: int) -> tuple[tuple[str, ...], int, int] | None:
    """Where :func:`cache_spec_for` puts the capacity axis of a ``k`` / ``v``
    cache leaf of the whole ``shape`` (..., B, C, Nkv, H) with a global
    ``batch``: ``(axes, index, n)``, the axes it splits C over (``("model",)``
    or the batch axes; only under ``SPEC_OPTIONS["seq_shard_cache"]``), the
    rank's index along them (``mesh.coords``) and their size; None where C
    stays whole (the option off, or the axes do not divide C, or they have
    one card).  The rank holds the slots ``[index C / n, (index + 1) C / n)``.
    The one decision of the cache's layout: the decode caches' creation,
    prefill and decode step and the planner's byte count all read it."""
    axes = _axes_of(cache_spec_for("k", tuple(shape), mesh, batch)[-3])
    n = math.prod(_axis_sizes(mesh)[a] for a in axes)
    if n == 1:
        return None
    return axes, mesh.index(axes), n


# ---------------------------------------------------------------------------
# One rule for every leaf of a step's arguments (params + caches + batches)
# ---------------------------------------------------------------------------

def auto_spec_for(path: str, shape: tuple[int, ...], mesh, batch: int) -> P:
    """Any leaf of a step's input or output: cache leaves by name
    (k/v/conv/h), token and logit tensors by name, parameters by the
    rules above, everything else replicated."""
    daxes = _data_axes(mesh)
    b_ax = daxes if daxes is not None and _fits(batch, mesh, daxes) else None
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("k", "v", "conv", "h") and len(shape) >= 2:
        return cache_spec_for(path, shape, mesh, batch)
    if leaf == "logits" and len(shape) >= 2:
        lead = (None,) * (len(shape) - 2)
        return P(*(lead + (b_ax, _resolve("model", mesh, shape[-1]))))
    if leaf == "next_token" and len(shape) == 1:
        return P(b_ax)
    if leaf in ("tokens", "labels") and len(shape) == 2:
        return P(b_ax, None)
    if leaf in ("prefix_embeds", "enc_embeds") and len(shape) == 3:
        return P(b_ax, None, None)
    return param_spec_for(path, shape, mesh)


def auto_specs(tree: Any, mesh, batch: int) -> Any:
    return _map_with_path(lambda path, leaf: auto_spec_for(path, _shape(leaf), mesh, batch), tree)


# ---------------------------------------------------------------------------
# This card's block of a leaf
# ---------------------------------------------------------------------------

def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one card's block of a leaf of ``shape`` under ``spec``."""
    sizes = _axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in _axes_of(e)) for d, e in zip(shape, spec))


# The SSM's in_proj (d, 2 d_inner) stacks the conv branch u and the gate z
# on its last dim.  A rank holds its columns of each, [u_r | z_r], so that
# the layer's chunk(2) still splits its block into u and z.  The one leaf
# whose block is not a contiguous slice of the whole: every function below
# that cuts or writes a block reads this rule.
_STACKED_HALVES = r"in_proj$"


def _halves(path: str) -> int:
    return 2 if path and re.search(_STACKED_HALVES, path) else 1


def block_box(shape: tuple[int, ...], spec: tuple, mesh, path: str = ""):
    """``(index_shape, offsets, lengths)``: a leaf of ``shape`` as
    :func:`block_view` cuts it (for a leaf of stacked halves whose last dim
    is split, that dim as ``(2, d_inner)``) and this rank's block in it, a
    box of ``lengths`` at ``offsets`` (``mesh.coords`` gives the rank's
    place along each axis)."""
    shape = tuple(shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if _halves(path) > 1 and _axes_of(spec[-1]):
        shape = shape[:-1] + (2, shape[-1] // 2)
        spec = spec[:-1] + (None, spec[-1])
    offsets, lengths = [], []
    for dim, e in zip(shape, spec):
        axes = _axes_of(e)
        block = dim // mesh.size(axes) if axes else dim
        offsets.append(mesh.index(axes) * block if axes else 0)
        lengths.append(block)
    return shape, tuple(offsets), tuple(lengths)


def block_view(t: torch.Tensor, spec: tuple, mesh, path: str = "") -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` as a view of ``t``
    (:func:`block_box`).  For a leaf of stacked halves (``path`` an SSM's
    ``in_proj``) whose last dim is split, the view has that dim unflattened
    to ``(2, d_inner / n)``: ``[u_r | z_r]`` once flattened."""
    shape, offsets, lengths = block_box(tuple(t.shape), spec, mesh, path)
    if len(shape) > t.dim():
        t = t.unflatten(-1, shape[-2:])
    for dim, (o, n) in enumerate(zip(offsets, lengths)):
        if n != shape[dim]:
            t = t.narrow(dim, o, n)
    return t


def local_shard(t: torch.Tensor, spec: tuple, mesh, path: str = "") -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, of :func:`local_shape`'s
    shape: a view, but for the stacked halves of an SSM's ``in_proj``
    (``path``; :func:`block_view`), whose block ``[u_r | z_r]`` is a copy."""
    block = block_view(t, spec, mesh, path)
    return block.flatten(-2) if block.dim() > t.dim() else block


def owns_block(spec: tuple, mesh) -> bool:
    """Whether this rank is the one that holds its block of a leaf under
    ``spec`` at coordinate 0 of every axis the leaf is replicated over: of
    the ranks holding the same block, the one whose copy a gather takes."""
    used = {a for e in spec for a in _axes_of(e)}
    return all(mesh.coords.get(a, 0) == 0 for a in mesh.axis_names if a not in used)


def block_part(run, offsets: tuple[int, ...], lengths: tuple[int, ...]):
    """``localize`` of one chunk of a leaf's stream: the part of the block
    (a box of ``lengths`` at ``offsets`` in the leaf's index space,
    :func:`block_box`) that the chunk ``run = (index, lo, hi)`` (the
    elements ``[*index, lo:hi, ...]``,
    :func:`repro_torch.checkpoint.store.runs`) holds, as ``(in_chunk,
    in_block)``: the indices of that part in the chunk and in the block.
    None when the chunk holds none of the block."""
    index, lo, hi = run
    if not lengths:
        return (), ()
    in_block = []
    for i, o, n in zip(index, offsets, lengths):
        if not o <= i < o + n:
            return None
        in_block.append(i - o)
    d = len(index)
    a, b = max(lo, offsets[d]), min(hi, offsets[d] + lengths[d])
    if a >= b:
        return None
    rest = tuple(slice(o, o + n) for o, n in zip(offsets[d + 1:], lengths[d + 1:]))
    in_block.append(slice(a - offsets[d], b - offsets[d]))
    return (slice(a - lo, b - lo),) + rest, tuple(in_block)


# ---------------------------------------------------------------------------
# The port's storage layout: what a rank of a running mesh holds
# ---------------------------------------------------------------------------

def _stationary_stack(path: str, cfg) -> bool:
    """An expert stack of the weights-stationary MoE, whose d_ff stays over
    the batch axes in both layouts (the layout of
    :func:`repro_torch.models.moe.local_expert_params`: its weights never
    move)."""
    return bool(cfg is not None and cfg.moe_weights_stationary
                and re.search(r"w_(gate|up|down)_e$", path))


def storage_spec_for(path: str, shape: tuple[int, ...], mesh, cfg=None) -> P:
    """The spec a rank of the port stores a parameter leaf by: the
    reference's :func:`param_spec_for` (FSDP storage over the batch axes:
    d_model, d_ff or the expert d_ff over ``data``, and ``pod`` when
    present; heads, d_ff, vocab or inner width over ``model``; each only
    where the axes divide the dimension).  Under
    ``SPEC_OPTIONS["replicate_params_over_data"]`` (the reference's serving
    layout) the batch axes are dropped and every leaf is whole over
    ``data``, but for the weights-stationary MoE's expert stacks, whose d_ff
    stays over them in both layouts.  One difference from the reference: an
    SSM's ``in_proj`` splits over ``model`` where ``model`` divides each of
    its halves, and its block is ``[u_r | z_r]`` (:func:`block_view`).

    The layers run on the leaves gathered over ``data``
    (:func:`gather_dim`,
    :func:`repro_torch.sharding.collectives.gather_weights`).  It reads the
    rule table itself: the layers decide from it on every call
    (:func:`repro_torch.sharding.collectives.layout_mesh`), and
    ``tools.reprolint`` joins :func:`param_spec_for` by name with the
    reference's, whose host-side ``int`` it would report in the step."""
    sizes = _axis_sizes(mesh)
    daxes = _data_axes(mesh)
    n_data = math.prod(sizes[a] for a in daxes) if daxes else 1
    keep = not SPEC_OPTIONS["replicate_params_over_data"] or _stationary_stack(path, cfg)
    for pattern, trailing in _RULES:
        if not re.search(pattern, path):
            continue
        n = len(trailing or ())
        if n == 0 or len(shape) < n:
            return P()
        tail = []
        for i, (ax, dim) in enumerate(zip(trailing, shape[len(shape) - n:])):
            if i == n - 1:
                dim //= _halves(path)  # each of in_proj's halves splits on its own
            if ax == "model" and "model" in sizes and dim % sizes["model"] == 0:
                tail.append("model")
            elif ax == "data" and keep and daxes and dim % n_data == 0:
                tail.append(daxes)
            else:
                tail.append(None)
        return P(*((None,) * (len(shape) - n) + tuple(tail)))
    return P()


def gather_dim(path: str, shape: tuple[int, ...], mesh, cfg=None) -> int | None:
    """The dim of a leaf (counted from the end, so that it holds for a
    stacked leaf and for one layer's slice of it) that a rank gathers over
    the batch axes before a layer reads it: the one its
    :func:`storage_spec_for` splits over them, but for the
    weights-stationary MoE's expert stacks, which are never gathered.  None
    for a leaf whole over ``data``."""
    if _stationary_stack(path, cfg):
        return None
    spec = storage_spec_for(path, shape, mesh, cfg)
    daxes = _data_axes(mesh)
    for i, e in enumerate(spec):
        if daxes and e == daxes:
            return i - len(shape)
    return None


def local_template(cfg, mesh) -> Any:
    """The param tree's ``(shape, dtype)`` leaves as one rank of ``mesh``
    stores them (the counterpart of
    :func:`repro_torch.training.steps.param_template`): every leaf at
    ``local_shape(shape, storage_spec_for(path, shape, mesh, cfg), mesh)``,
    its block over ``data`` and ``model`` (over ``model`` alone under
    ``replicate_params_over_data``).  Only the layout's sizes are read, so
    a mesh with no running processes plans a rank's blocks."""
    from repro_torch.models import model as M

    meta = M.init_model(None, cfg, "meta")
    return _map_with_path(
        lambda path, t: (local_shape(tuple(t.shape), storage_spec_for(path, tuple(t.shape), mesh,
                                                                      cfg), mesh), t.dtype),
        meta)


def localize(tree: Any, cfg, mesh) -> Any:
    """This rank's blocks of a param tree held whole (each a contiguous
    copy, so the whole can be freed).  A leaf that is already the rank's
    block (its :func:`local_template` shape) is kept as it is; a leaf of
    neither shape raises."""
    from repro_torch.models import model as M

    whole = {path: tuple(t.shape) for path, t in leaf_paths(M.init_model(None, cfg, "meta"))}

    def one(path, t):
        full = whole[path]
        spec = storage_spec_for(path, full, mesh, cfg)
        shape = local_shape(full, spec, mesh)
        if t.device.type == "meta":
            return torch.empty(shape, dtype=t.dtype, device="meta")
        if tuple(t.shape) == shape:
            return t
        if tuple(t.shape) != full:
            raise ValueError(f"{path}: shape {tuple(t.shape)} is neither the whole leaf {full} "
                             f"nor this rank's block {shape}")
        # a copy, not a view: a view would keep the whole leaf alive
        return local_shard(t, spec, mesh, path).clone(memory_format=torch.contiguous_format)

    return _map_with_path(one, tree)


def check_local_params(params: Any, cfg, mesh) -> None:
    """Raise unless every leaf of ``params`` has its :func:`local_template`
    shape.  Under a running sharded mesh the layers take the rank's blocks
    (gathered over ``data`` layer by layer); a tree held whole must not run
    whole on every rank."""
    from repro_torch.sharding.collectives import data_layout

    want = data_layout(cfg, mesh).shapes
    for path, t in leaf_paths(params):
        if tuple(t.shape) != want[path]:
            raise ValueError(
                f"{path}: shape {tuple(t.shape)} under a {dict(mesh.shape)} layout, where the "
                f"rank's block is {want[path]}: build the rank's blocks "
                "(training.init_params or bridge.params_from_jax under the mesh)")
