"""Composable gradient-transform pipeline — the paper's "modularized alpha"
(port of ``src/repro/optim/transform.py``).

Every stage of the server update is a :class:`GradientTransform`, an
``(init, update)`` pair over update trees (nested dicts of tensors), and
:func:`chain` composes them:

    state   = t.init(params)
    updates, state = t.update(updates, state, params, ctx)

``ctx`` is a :class:`StepContext` carrying the per-step observations the links
key on (``tau``/``taus``, the device-resident ``AdaptState``, the
``staleness_applied`` flag of the async engines).  The link -> paper-equation
map, the canonical ``chain(scale(-lr), trace(mu))`` ordering and the async
absorption of ``scale_by_staleness``/``drop_stale`` into the combine weights
are the reference's, unchanged.

Numerics follow the reference op for op: each link multiplies by its factor
as an f32 scalar in the same operand order, so the fused flat step
(:mod:`repro_torch.optim.fuse`) is bitwise equal to this link-by-link chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
Updates = Any
f32 = torch.float32

__all__ = [
    "StepContext",
    "GradientTransform",
    "Chain",
    "chain",
    "identity",
    "scale",
    "trace",
    "scale_by_staleness",
    "scale_by_adam",
    "drop_stale",
    "clip_by_global_norm",
    "fused_apply",
    "global_norm",
    "pack_flat",
    "unpack_flat",
    "flat_view",
    "apply_updates",
    "run_pipeline",
    "staleness_link",
    "drop_link",
    "iter_links",
    "scalar",
    "staleness_alpha",
]


def scalar(x) -> torch.Tensor:
    """An f32 0-d CPU tensor: the form every link's factor takes, so the
    linked and the fused paths multiply by the same f32 value.  A CPU 0-d
    tensor combines with tensors on any device without a copy or a sync."""
    return torch.tensor(x, dtype=f32)


# ---------------------------------------------------------------------------
# Step context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepContext:
    """Per-step observations threaded through a pipeline (see reference):
    ``tau`` (scalar staleness, sync path), ``taus`` ((W,) async), ``scale``
    (extra learning-rate multiplier), ``adapt`` (the AdaptState) and
    ``staleness_applied`` (True when the async step already applied the
    alpha/drop weighting inside the ring combine).  ``sq_norm``, when set,
    is the squared global norm of an update held as this rank's blocks of a
    sharded layout (:func:`repro_torch.sharding.collectives.make_sq_norm`),
    which the clip link takes in place of :func:`global_norm`."""

    tau: Any = None
    taus: Any = None
    scale: Any = 1.0
    adapt: Any = None
    staleness_applied: bool = False
    sq_norm: Any = None


# ---------------------------------------------------------------------------
# The transform protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class GradientTransform:
    """An (init, update) pair.  A link with ``applies_params=True`` is
    terminal: its first return value is the NEW PARAMS."""

    init: Callable[[Params], Any]
    update: Callable[[Updates, Any, Params, StepContext], tuple[Updates, Any]]
    applies_params: bool = False
    kind: str = ""


@dataclasses.dataclass(eq=False)
class Chain(GradientTransform):
    links: tuple = ()


def chain(*links: GradientTransform) -> Chain:
    """Compose links left to right; only the last may be terminal."""
    links = tuple(links)
    for link in links[:-1]:
        assert not link.applies_params, (
            f"terminal link {link.kind!r} must be the last stage of a chain"
        )

    def init(params):
        return tuple(link.init(params) for link in links)

    def update(updates, state, params, ctx=None):
        ctx = StepContext() if ctx is None else ctx
        assert isinstance(state, tuple) and len(state) == len(links), (
            f"chain state is {type(state).__name__} for {len(links)} links — "
            "initialize the optimizer state with this pipeline's init() "
            "(a dict here usually means a fused state fed to an unfused step)"
        )
        new_states = []
        for link, s in zip(links, state):
            updates, s = link.update(updates, s, params, ctx)
            new_states.append(s)
        return updates, tuple(new_states)

    return Chain(
        init=init,
        update=update,
        applies_params=bool(links) and links[-1].applies_params,
        kind="chain",
        links=links,
    )


def _stateless(update, kind: str, **attrs) -> GradientTransform:
    t = GradientTransform(init=lambda params: (), update=update, kind=kind)
    for k, v in attrs.items():
        setattr(t, k, v)
    return t


def identity() -> GradientTransform:
    return _stateless(lambda u, s, p, ctx: (u, s), kind="identity")


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------

def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.sum(torch.square(leaves[0].to(f32)))
    for leaf in leaves[1:]:
        total = total + torch.sum(torch.square(leaf.to(f32)))
    return torch.sqrt(total)


def pack_flat(tree: Params, dtype=f32) -> torch.Tensor:
    """Pack every leaf into one contiguous 1-D buffer, in leaf order (the
    reference's ``ravel_pytree`` order)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])


def unpack_flat(flat: torch.Tensor, like: Params) -> Params:
    """Split a packed buffer back into the shapes/dtypes of ``like``."""
    return flat_view(flat, tree_map(lambda t: (tuple(t.shape), t.dtype), like))


def flat_view(flat: torch.Tensor, template: Params) -> Params:
    """View a packed ``(N,)`` buffer as the leaves of ``template``.

    ``template`` leaves are tensors or ``(shape, dtype)`` pairs.  The leaves
    are ``torch.split`` views reshaped in place, so differentiating through
    the view gives the packed gradient directly (the backward of ``split`` is
    one concatenation): gradients are born flat.
    """
    specs = [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
             for t in tree_leaves(template)]
    sizes = [math.prod(shape) for shape, _ in specs]
    assert sum(sizes) == flat.shape[0], (
        f"flat buffer has {flat.shape[0]} elements, template needs {sum(sizes)}"
    )
    pieces = iter(
        piece.view(shape).to(dtype)
        for piece, (shape, dtype) in zip(torch.split(flat, sizes), specs)
    )
    return tree_map(lambda _: next(pieces), template) if isinstance(template, dict) else next(pieces)


def apply_updates(params: Params, updates: Updates) -> Params:
    """``x <- x + u`` with f32 accumulation, cast back to the param dtype."""
    return tree_map(lambda p, u: (p.to(f32) + u).to(p.dtype), params, updates)


def run_pipeline(pipeline: GradientTransform, grads, opt_state, params, ctx=None):
    """Run a pipeline over raw gradients and apply: ``(new_params, new_state)``."""
    updates, new_state = pipeline.update(grads, opt_state, params, ctx)
    if pipeline.applies_params:
        return updates, new_state
    return apply_updates(params, updates), new_state


# ---------------------------------------------------------------------------
# Scaling links
# ---------------------------------------------------------------------------

def scale(factor: float) -> GradientTransform:
    """Multiply updates by ``factor * ctx.scale`` — the base step ``alpha_c``."""
    f = float(factor)

    def update(u, s, params, ctx):
        m = scalar(f) * ctx.scale
        return tree_map(lambda leaf: m * leaf.to(f32), u), s

    return _stateless(update, kind="scale", factor=f)


def trace(mu: float) -> GradientTransform:
    """Polyak heavy ball (paper eq. 5): ``v <- mu v + u; out = v``."""
    mu = float(mu)

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)

    def update(u, v, params, ctx):
        m = scalar(mu)
        v2 = tree_map(lambda v_, u_: m * v_ + u_.to(f32), v, u)
        return v2, v2

    t = GradientTransform(init=init, update=update, kind="trace")
    t.mu = mu
    return t


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    """Cap the global update norm (the paper's §V.C clip protocol, tree-wise)."""
    max_norm = float(max_norm)

    def update(u, s, params, ctx):
        n = global_norm(u) if ctx.sq_norm is None else torch.sqrt(ctx.sq_norm(u))
        factor = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
        return tree_map(lambda leaf: leaf * factor.to(leaf.dtype), u), s

    return _stateless(update, kind="clip", max_norm=max_norm)


# ---------------------------------------------------------------------------
# Staleness-keyed links
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class StalenessTransform(GradientTransform):
    """``scale_by_staleness`` link: the strategy plus the online hooks that
    :func:`repro_torch.training.adapt.host_refresh` drives."""

    schedule: Any = None
    alpha_c: float = 1.0
    estimator: Any = None

    def observe(self, tau) -> None:
        if self.estimator is not None:
            self.estimator.observe(np.asarray(tau))

    def observe_counts(self, counts) -> None:
        if self.estimator is not None:
            self.estimator.observe_counts(counts)

    def refresh(self, strategy: str = "poisson_momentum", *, family: str = "poisson",
                K: float | None = None, normalize: bool = True) -> None:
        """Refit the staleness model and rebuild alpha(tau)."""
        assert self.estimator is not None, "construct with m= (an estimator) to refresh"
        self.schedule = self.estimator.rebuild_schedule(
            strategy, self.alpha_c, family=family,
            K=self.alpha_c if K is None else K, normalize=normalize,
        )


def staleness_alpha(link, ctx, tau):
    """``alpha(tau)`` for a ``scale_by_staleness`` link: from the device table
    in ``ctx.adapt`` when there is one (a refresh rewrites it in place), else
    from the link's schedule."""
    if ctx.adapt is not None:
        table = ctx.adapt.alpha_table
        return table[torch.as_tensor(tau, device=table.device).long().clamp(0, table.shape[0] - 1)]
    assert link.schedule is not None, (
        "scale_by_staleness without a schedule needs ctx.adapt (the device alpha table)"
    )
    return link.schedule(tau)


def scale_by_staleness(
    schedule=None,
    alpha_c: float = 1.0,
    *,
    m: int | None = None,
    tau_max: int = 256,
) -> StalenessTransform:
    """Multiply updates by ``alpha(tau) / alpha_c`` (paper eq. 4 / Alg. 1);
    ``m`` attaches an online estimator for the §IV refresh loop."""
    if m is not None:
        from repro_torch.core.estimator import OnlineStalenessEstimator

        estimator = OnlineStalenessEstimator(m=m, tau_max=tau_max)
    else:
        estimator = None

    link = StalenessTransform(
        init=lambda params: (),
        update=None,
        kind="staleness",
        schedule=schedule,
        alpha_c=float(alpha_c),
        estimator=estimator,
    )

    def update(u, s, params, ctx):
        if ctx.staleness_applied:
            return u, s
        tau = 0 if ctx.tau is None else ctx.tau
        factor = staleness_alpha(link, ctx, tau) / scalar(link.alpha_c)
        return tree_map(lambda leaf: factor * leaf.to(f32), u), s

    link.update = update
    return link


def drop_stale(tau_drop: int) -> GradientTransform:
    """Zero the update when ``tau > tau_drop`` (the paper's §V.C drop rule)."""
    tau_drop = int(tau_drop)

    def update(u, s, params, ctx):
        if ctx.staleness_applied:
            return u, s
        tau = 0 if ctx.tau is None else ctx.tau
        keep = (torch.as_tensor(tau) <= tau_drop).to(f32)
        return tree_map(lambda leaf: leaf * keep, u), s

    return _stateless(update, kind="drop", tau_drop=tau_drop)


# ---------------------------------------------------------------------------
# Preconditioner link
# ---------------------------------------------------------------------------

def adam_corrections(b1: float, b2: float, t: torch.Tensor):
    """The bias corrections ``1/(1 - b^t)`` for step ``t`` (int tensor), in
    the one expression both the link and the fused scalars use."""
    tf = t.to(f32)
    return 1.0 / (1.0 - b1 ** tf), 1.0 / (1.0 - b2 ** tf)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransform:
    """Adam direction ``m_hat / (sqrt(v_hat) + eps)`` (state: m, v, t)."""
    b1, b2, eps = float(b1), float(b2), float(eps)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=f32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(u, state, params, ctx):
        t = state["t"] + 1
        sb1, somb1, sb2, somb2, seps = (scalar(x) for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps))
        m = tree_map(lambda m_, g: sb1 * m_ + somb1 * g.to(f32), state["m"], u)
        v = tree_map(lambda v_, g: sb2 * v_ + somb2 * torch.square(g.to(f32)), state["v"], u)
        c1, c2 = adam_corrections(b1, b2, t)
        out = tree_map(lambda m_, v_: (m_ * c1) / (torch.sqrt(v_ * c2) + seps), m, v)
        return out, {"m": m, "v": v, "t": t}

    t = GradientTransform(init=init, update=update, kind="adam")
    t.b1, t.b2, t.eps = b1, b2, eps
    return t


# ---------------------------------------------------------------------------
# Terminal stage: the fused parameter-server apply
# ---------------------------------------------------------------------------

def fused_apply(lr: float, mu: float = 0.0) -> GradientTransform:
    """Terminal stage: flat-buffer momentum apply in one pass — the
    ``fused_update`` Hopper kernel on the card
    (:func:`repro_torch.kernels.adaptive_update.cuda.fused_update`).
    Returns NEW PARAMS; must be last in a chain."""
    lr, mu = float(lr), float(mu)

    def init(params):
        from repro_torch.async_engine.delayed import flat_size

        device = tree_leaves(params)[0].device
        return torch.zeros((flat_size(params),), dtype=f32, device=device)

    def update(u, v_flat, params, ctx):
        from repro_torch.kernels.adaptive_update.cuda import fused_update

        g_flat = u.to(f32) if isinstance(u, torch.Tensor) else pack_flat(u)
        p_flat = params.clone() if isinstance(params, torch.Tensor) else pack_flat(params)
        v_new = v_flat.clone()
        fused_update(p_flat, g_flat, v_new, scalar(lr) * ctx.scale, scalar(mu))
        new_params = p_flat if isinstance(params, torch.Tensor) else unpack_flat(p_flat, params)
        return new_params, v_new

    t = GradientTransform(init=init, update=update, applies_params=True, kind="fused_apply")
    t.lr, t.mu = lr, mu
    return t


# ---------------------------------------------------------------------------
# Pipeline introspection
# ---------------------------------------------------------------------------

def iter_links(pipeline):
    if isinstance(pipeline, Chain):
        for link in pipeline.links:
            yield from iter_links(link)
    elif isinstance(pipeline, GradientTransform):
        yield pipeline


def staleness_link(pipeline) -> StalenessTransform | None:
    for link in iter_links(pipeline):
        if link.kind == "staleness":
            return link
    return None


def drop_link(pipeline) -> GradientTransform | None:
    for link in iter_links(pipeline):
        if link.kind == "drop":
            return link
    return None
