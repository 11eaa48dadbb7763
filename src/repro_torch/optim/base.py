"""DEPRECATED optimizer shims over the transform pipeline (port of
``src/repro/optim/base.py``).

An :class:`Optimizer` is the legacy ``(init, update)`` pair over param trees:

    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, scale=s)

Each one shims a :mod:`repro_torch.optim.transform` chain (``opt.pipeline``):
it keeps the legacy state layout (``momentum``'s velocity tree, ``adam``'s
``{"m", "v", "t"}``) and the ``scale=`` multiplier, and the arithmetic is
the chain's, so a trajectory is bitwise that of the chain run directly
(``tests/test_torch_optim_shims.py``).  New code builds the chain:

    from repro_torch.optim import transform as T
    pipe = T.chain(T.scale(-lr))                                 # == sgd(lr)
    pipe = T.chain(T.scale(-lr), T.trace(mu))                    # == momentum(lr, mu)
    pipe = T.chain(T.fused_apply(lr, mu))                        # == momentum(fused=True)
    pipe = T.chain(T.scale_by_adam(b1, b2, eps), T.scale(-lr))   # == adam(...)

``scale`` multiplies the learning rate: the seam where MindTheStep's
``alpha(tau) / alpha`` plugs in (:mod:`repro_torch.optim.mindthestep`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.optim import transform as T
from repro_torch.optim.transform import (  # noqa: F401  (their home is transform.py)
    apply_updates,
    global_norm,
    pack_flat,
    unpack_flat,
)
from repro_torch.tree import tree_map

Params = Any

__all__ = [
    "Optimizer",
    "sgd",
    "momentum",
    "adam",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "pack_flat",
    "unpack_flat",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Legacy (init, update) interface; ``pipeline`` is the chain it shims.
    ``update(grads, state, params, scale=1.0)`` returns ``(new_params,
    new_state)``."""

    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]
    pipeline: T.GradientTransform | None = None


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    """Eager clip over a tree (the legacy function; the chainable link is
    :func:`repro_torch.optim.transform.clip_by_global_norm`)."""
    n = global_norm(tree)
    factor = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda leaf: leaf * factor.to(leaf.dtype), tree)


def sgd(lr: float) -> Optimizer:
    """Plain SGD, the paper's eq. (1)/(4): ``x <- x - alpha g``.  Shim over
    ``chain(scale(-lr))``; legacy state ``()``."""
    pipe = T.chain(T.scale(-lr))

    def init(params):
        return ()

    def update(grads, state, params, scale=1.0):
        new_params, _ = T.run_pipeline(pipe, grads, ((),), params, T.StepContext(scale=scale))
        return new_params, state

    return Optimizer(init, update, pipeline=pipe)


def momentum(lr: float, mu: float = 0.9, *, fused: bool = False) -> Optimizer:
    """``v <- mu v - alpha g;  x <- x + v`` (eq. 5).  Shim over
    ``chain(scale(-lr), trace(mu))``: the trace state is eq. 5's velocity, the
    legacy state.  ``fused=True`` shims ``chain(fused_apply(lr, mu))``: one
    flat f32 velocity and one ``fused_update`` launch per step on the card."""
    if fused:
        return _momentum_fused(lr, mu)
    pipe = T.chain(T.scale(-lr), T.trace(mu))

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params, scale=1.0):
        new_params, (_, v) = T.run_pipeline(pipe, grads, ((), state), params,
                                            T.StepContext(scale=scale))
        return new_params, v

    return Optimizer(init, update, pipeline=pipe)


def _momentum_fused(lr: float, mu: float) -> Optimizer:
    """Momentum over a flat buffer (see :func:`momentum`); ``update`` takes
    the gradient as a tree or already packed."""
    pipe = T.chain(T.fused_apply(lr, mu))

    def init(params):
        return pipe.init(params)[0]

    def update(grads, state, params, scale=1.0):
        new_params, (v,) = T.run_pipeline(pipe, grads, (state,), params,
                                          T.StepContext(scale=scale))
        return new_params, v

    return Optimizer(init, update, pipeline=pipe)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Shim over ``chain(scale_by_adam(b1, b2, eps), scale(-lr))``; legacy
    state is the preconditioner link's ``{"m", "v", "t"}``."""
    pipe = T.chain(T.scale_by_adam(b1, b2, eps), T.scale(-lr))

    def init(params):
        return pipe.init(params)[0]

    def update(grads, state, params, scale=1.0):
        new_params, (mvt, _) = T.run_pipeline(pipe, grads, (state, ()), params,
                                              T.StepContext(scale=scale))
        return new_params, mvt

    return Optimizer(init, update, pipeline=pipe)
