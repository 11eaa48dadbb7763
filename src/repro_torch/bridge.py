"""Carry the reference's weights and state across, as numpy arrays.

The two packages cannot draw the same random numbers (``jax.random`` and
``torch.Generator`` differ by design), so parity runs start from the SAME
arrays instead: the reference's params, adaptation tables and delayed ring,
exported as numpy, become the port's tensors here.

* :func:`params_from_jax` takes the reference's params as a dict keyed by
  their key-path names — the names of the reference checkpoint's npz arrays,
  ``['embed']['embedding']`` and so on — and packs them, in leaf order, into
  the port's flat ``(N,)`` buffer.  Shapes are checked against the port's own
  template; a missing or extra name raises.  With a ``mesh`` it packs one
  rank's blocks instead, and :func:`gather_params` puts every rank's blocks
  back together into the one-process buffer.
* :func:`adapt_from_jax` and :func:`delayed_from_jax` do the same for an
  ``AdaptState``'s tables and histogram and for a flat delayed ring (a bf16
  ring arrives as numpy's ``bfloat16`` extension type and keeps its bits).
* :func:`worker_adapt_from_jax` and :func:`worker_ring_from_jax` carry the
  sharded engine's ``WorkerAdaptState`` and per-worker ``(W, K, ...)``
  rings (flat, or a dict keyed by the params' key-path names).
* :func:`cnn_params_from_jax` turns the reference's CNN or MLP classifier
  params (key-path names, HWIO convolution weights) into the port's tree.
* :func:`cache_from_jax` turns the reference's decode cache (from
  ``prefill`` or ``init_decode_state``, keyed by key path the same way;
  whisper's ``self`` / ``cross`` K/V too) into the port's, dtypes and bf16
  bits kept, so a decode step can be compared from the same cache.

:func:`params_from_jax` takes every arch's tree, the MoE's ``moe`` leaves,
whisper's ``encoder`` / ``decoder`` stacks and an untied ``unembed``
included: the names and shapes come from the port's own template.

Nothing here imports the JAX package: the caller does the export.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.async_engine.delayed import DelayedGradients, WorkerRing
from repro_torch.models.transformer import init_stack_cache
from repro_torch.training.adapt import AdaptState, WorkerAdaptState
from repro_torch.training.steps import param_template
from repro_torch.tree import keystr, tree_paths

__all__ = ["params_from_jax", "gather_params", "params_to_numpy", "adapt_from_jax", "delayed_from_jax",
           "worker_adapt_from_jax", "worker_ring_from_jax", "cnn_params_from_jax",
           "cache_from_jax", "to_torch"]


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy -> torch, keeping bf16 bit patterns (numpy cannot cast them)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _check_names(what: str, np_tree: dict, template) -> None:
    names = {keystr(path) for path, _ in tree_paths(template)}
    missing = sorted(names - set(np_tree))
    extra = sorted(set(np_tree) - names)
    if missing or extra:
        raise ValueError(f"{what} names disagree: missing {missing}, unexpected {extra}")


def params_from_jax(np_tree: dict, cfg, device="cpu", mesh=None) -> tuple[torch.Tensor, dict]:
    """The reference's params -> ``(flat (N,) f32 buffer, template)``.  With
    a ``mesh`` (its sizes and this rank's coordinates), this rank's blocks:
    the flat ``(N_local,)`` buffer and
    :func:`~repro_torch.sharding.specs.local_template`."""
    from repro_torch.sharding.specs import local_shard, local_template, storage_spec_for

    template = param_template(cfg)
    _check_names("param", np_tree, template)
    parts = []
    for path, (shape, dtype) in tree_paths(template):
        a = np_tree[keystr(path)]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{keystr(path)}: shape {a.shape} != template {shape}")
        t = to_torch(a).to(dtype)
        if mesh is not None:
            name = "/".join(path)
            t = local_shard(t, storage_spec_for(name, tuple(shape), mesh, cfg), mesh, name)
        parts.append(t.reshape(-1))
    if mesh is not None:
        template = local_template(cfg, mesh)
    return torch.cat(parts).to(device), template


def gather_params(local_flat: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The one-process flat ``(N,)`` buffer from every rank's ``(N_local,)``
    blocks (a collective: every rank of ``mesh`` calls it and gets the
    whole).  Each leaf is written into a zero buffer by the one rank that
    owns its block at coordinate 0 of every axis the leaf is replicated
    over (:func:`~repro_torch.sharding.specs.owns_block`, the rule the
    sharded checkpoint's gather takes too), and one all-reduce over the
    whole layout sums the buffer, so every element is its owner's value
    up to the sign of a zero, which the sum makes ``+0.0`` (gloo reduces
    CUDA tensors but does not gather them; a checkpoint gathers bits).  An SSM's ``in_proj`` block ``[u_r | z_r]``
    goes back to its columns of u and of z
    (:func:`~repro_torch.sharding.specs.block_view`)."""
    import math

    import torch.distributed as dist

    from repro_torch.sharding.specs import block_view, local_shape, owns_block, storage_spec_for

    whole = param_template(cfg)
    out = torch.zeros((sum(math.prod(s) for _, (s, _) in tree_paths(whole)),),
                      dtype=local_flat.dtype, device=local_flat.device)
    src = dst = 0
    for path, (shape, _) in tree_paths(whole):
        name = "/".join(path)
        spec = storage_spec_for(name, tuple(shape), mesh, cfg)
        n_local = math.prod(local_shape(tuple(shape), spec, mesh))
        if owns_block(spec, mesh):
            view = block_view(out[dst:dst + math.prod(shape)].view(shape), spec, mesh, name)
            view.copy_(local_flat[src:src + n_local].view(view.shape))
        src += n_local
        dst += math.prod(shape)
    dist.all_reduce(out, group=mesh.group(mesh.axis_names))
    return out


def params_to_numpy(params, cfg) -> dict:
    """The port's params (flat or tree) -> numpy dict keyed by key-path name."""
    from repro_torch.training.steps import param_view

    return {keystr(path): leaf.detach().cpu().numpy()
            for path, leaf in tree_paths(param_view(params, cfg))}


def adapt_from_jax(alpha_table, tau_cdf, hist, device="cpu") -> AdaptState:
    """An AdaptState from the reference's three arrays (dtypes kept: f32,
    f32, int32)."""
    return AdaptState(
        alpha_table=to_torch(np.asarray(alpha_table, np.float32), device),
        tau_cdf=to_torch(np.asarray(tau_cdf, np.float32), device),
        hist=to_torch(np.asarray(hist, np.int32), device),
    )


def delayed_from_jax(ring, step, device="cpu") -> DelayedGradients:
    """A flat ``(K, N)`` delayed ring and its step counter."""
    return DelayedGradients(ring=to_torch(ring, device),
                            step=torch.tensor(int(step), dtype=torch.int32, device=device))


def worker_adapt_from_jax(alpha_table, tau_cdf, tau_trace, use_trace, hist,
                          device="cpu") -> WorkerAdaptState:
    """A WorkerAdaptState from the reference's five arrays (f32, f32, int32,
    int32, int32)."""
    return WorkerAdaptState(
        alpha_table=to_torch(np.asarray(alpha_table, np.float32), device),
        tau_cdf=to_torch(np.asarray(tau_cdf, np.float32), device),
        tau_trace=to_torch(np.asarray(tau_trace, np.int32), device),
        use_trace=to_torch(np.asarray(use_trace, np.int32), device),
        hist=to_torch(np.asarray(hist, np.int32), device),
    )


def _nest(np_tree: dict, device) -> dict:
    """``{"['a']['b']": array}`` -> ``{"a": {"b": tensor}}``."""
    out: dict = {}
    for name, a in np_tree.items():
        keys = re.findall(r"\['([^']*)'\]", name)
        if not keys or "".join(f"['{k}']" for k in keys) != name:
            raise ValueError(f"not a key-path name: {name!r}")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = to_torch(a, device)
    return out


def worker_ring_from_jax(ring, step, cfg=None, device="cpu") -> WorkerRing:
    """Per-worker rings and their step: a flat ``(W, K, N)`` array, or (with
    ``cfg``) a dict of ``(W, K, ...)`` arrays keyed by the params' key-path
    names; bf16 bits are kept."""
    if isinstance(ring, dict):
        _check_names("worker ring", ring, param_template(cfg))
        ring = _nest(ring, device)
    else:
        ring = to_torch(ring, device)
    return WorkerRing(ring=ring, step=torch.tensor(int(step), dtype=torch.int32, device=device))


def cnn_params_from_jax(np_tree: dict, device="cpu") -> dict:
    """The reference's CNN (or MLP classifier) params, keyed by key-path
    name (``['conv1']['w']`` ...), as the port's nested dict on ``device``;
    the layouts are the same (HWIO convolution weights), so nothing is
    transposed."""
    return _nest(np_tree, device)


def cache_from_jax(np_tree: dict, cfg, device="cpu") -> dict:
    """The reference's decode cache -> the port's cache tree on ``device``.

    The names must be the port's own (``pos{j}`` / ``rem{i}`` groups, ``k`` /
    ``v`` or ``conv`` / ``h`` leaves; whisper's ``self`` / ``cross`` groups)
    and each leaf of the rank the port expects; batch, capacity and dtypes are the arrays' own.
    """
    if cfg.is_encoder_decoder:  # whisper: {"self", "cross"} x {"k", "v"}, (L, B, T, N, H)
        kv = {"k": torch.empty((1,) * 5, device="meta"), "v": torch.empty((1,) * 5, device="meta")}
        template = {"self": kv, "cross": dict(kv)}
    else:
        template = init_stack_cache(cfg, 1, 1, torch.float32, "meta")
    _check_names("cache", np_tree, template)
    cache: dict = {}
    for path, leaf in tree_paths(template):
        a = np_tree[keystr(path)]
        if a.ndim != leaf.dim():
            raise ValueError(f"{keystr(path)}: rank {a.ndim} != {leaf.dim()}")
        node = cache
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_torch(a, device)
    return cache
