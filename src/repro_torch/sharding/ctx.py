"""Logical-axis sharding context (port of ``src/repro/sharding/ctx.py``).

Model code names the axes of its activations with *logical* names
(``"batch"``, ``"seq"``, ``"heads"``, ``"ff"``, ``"experts"``, ``"vocab"`` ...).
A :class:`ShardingRules` context maps logical names to the axes of a
:class:`~repro_torch.launch.mesh.Mesh`.  A spec is a :class:`PartitionSpec`:
a plain tuple with one entry per dimension (an axis name, a tuple of axis
names, or ``None``, replicated), the entries of the reference's
``PartitionSpec``; the subclass only marks it as a leaf of a tree of specs.

The reference's ``shard_activation`` hands the spec to XLA's SPMD
partitioner (``with_sharding_constraint``).  Eager PyTorch has no such
partitioner, so here it is the identity: a tensor is always this process's
own block, and code that needs data from other processes says so with an
explicit collective (:mod:`repro_torch.sharding.collectives`: the
Megatron-style attention, MLP, embedding and cross-entropy of
:mod:`repro_torch.models`, and the expert-parallel MoE).
The reference's ``shard_map_compat`` (a version shim over ``jax.shard_map``)
has no counterpart for the same reason: what it wraps is written as
explicit collectives over the mesh's process groups.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Sequence

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "use_sharding_rules",
    "shard_activation",
    "current_rules",
    "rules_in_force",
    "DEFAULT_RULES",
]

# logical axis -> mesh axis (or tuple of mesh axes, or None)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    # Megatron-style sequence parallelism of the residual stream (the
    # reference applies it only with cfg.sequence_parallel)
    "seq_sp": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "d_model": None,
    "embed_shard": "data",  # the FSDP-style storage axis for weights
    "state": "model",
}


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)`` == ``("data", None)``: a tuple of one
    entry per dimension, told apart from the containers of a tree."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any  # repro_torch.launch.mesh.Mesh (or anything with axis_names)
    rules: dict[str, object]

    def spec(self, logical: Sequence[object]) -> PartitionSpec:
        """The spec of a tensor whose dimensions have these logical names;
        a mesh axis the mesh lacks maps to ``None``."""
        axes = []
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            mapped = self.rules.get(str(name))
            if mapped is None:
                axes.append(None)
            elif isinstance(mapped, tuple):
                present = tuple(a for a in mapped if a in self.mesh.axis_names)
                axes.append(present if present else None)
            else:
                axes.append(mapped if mapped in self.mesh.axis_names else None)
        return PartitionSpec(*axes)


_CTX: contextvars.ContextVar[ShardingRules | None] = contextvars.ContextVar(
    "sharding_rules", default=None
)


def current_rules() -> ShardingRules | None:
    return _CTX.get()


@contextlib.contextmanager
def use_sharding_rules(mesh, rules: dict[str, object] | None = None):
    token = _CTX.set(ShardingRules(mesh, dict(DEFAULT_RULES if rules is None else rules)))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def rules_in_force(rules: ShardingRules | None):
    """Make ``rules`` (as :func:`current_rules` returned them, None
    included) current again, for code that runs on another thread: the
    rules live in a context variable, which a thread started elsewhere
    (autograd's device thread, where a CUDA backward and its checkpoint
    recompute run) does not see."""
    token = _CTX.set(rules)
    try:
        yield
    finally:
        _CTX.reset(token)


def shard_activation(x, logical: Sequence[object]):
    """The identity: eager PyTorch has no SPMD partitioner (module
    docstring).  Kept so that code written against the reference's
    annotations reads the same."""
    return x
