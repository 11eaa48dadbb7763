"""Carry the reference's weights and state across, as numpy arrays.

The two packages cannot draw the same random numbers (``jax.random`` and
``torch.Generator`` differ by design), so parity runs start from the SAME
arrays instead: the reference's params, adaptation tables and delayed ring,
exported as numpy, become the port's tensors here.

* :func:`params_from_jax` takes the reference's params as a dict keyed by
  their key-path names — the names of the reference checkpoint's npz arrays,
  ``['embed']['embedding']`` and so on — and packs them, in leaf order, into
  the port's flat ``(N,)`` buffer.  Shapes are checked against the port's own
  template; a missing or extra name raises.
* :func:`adapt_from_jax` and :func:`delayed_from_jax` do the same for an
  ``AdaptState``'s tables and histogram and for a flat delayed ring (a bf16
  ring arrives as numpy's ``bfloat16`` extension type and keeps its bits).
* :func:`worker_adapt_from_jax` and :func:`worker_ring_from_jax` carry the
  sharded engine's ``WorkerAdaptState`` and per-worker ``(W, K, ...)``
  rings (flat, or a dict keyed by the params' key-path names).
* :func:`cnn_params_from_jax` turns the reference's CNN or MLP classifier
  params (key-path names, HWIO convolution weights) into the port's tree.
* :func:`cache_from_jax` turns the reference's decode cache (from
  ``prefill`` or ``init_decode_state``, keyed by key path the same way) into
  the port's, dtypes and bf16 bits kept, so a decode step can be compared
  from the same cache.

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

__all__ = ["params_from_jax", "params_to_numpy", "adapt_from_jax", "delayed_from_jax",
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


def params_from_jax(np_tree: dict, cfg, device="cpu") -> tuple[torch.Tensor, dict]:
    """The reference's params -> ``(flat (N,) f32 buffer, template)``."""
    template = param_template(cfg)
    _check_names("param", np_tree, template)
    parts = []
    for path, (shape, dtype) in tree_paths(template):
        a = np_tree[keystr(path)]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{keystr(path)}: shape {a.shape} != template {shape}")
        parts.append(to_torch(a).to(dtype).reshape(-1))
    return torch.cat(parts).to(device), template


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
    ``v`` or ``conv`` / ``h`` leaves) and each leaf of the rank the port
    expects; batch, capacity and dtypes are the arrays' own.
    """
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
