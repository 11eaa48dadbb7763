"""Pipeline fusion compiler: lower a ``chain()`` to one flat-buffer kernel
(port of ``src/repro/optim/fuse.py``).

:func:`plan_fusion` classifies a chain's links exactly as the reference does:
``scale_by_staleness``/``drop_stale`` become scalar factors (absorbed into the
ring-combine weights in async mode), ``clip_by_global_norm`` a norm reduction
outside the kernel whose scalar is fused in, and the body selects the ``sgd``
/ ``momentum`` / ``adam`` member of the kernel family.

Execution: :func:`flat_chain_step` is one ``fused_chain`` launch and
:func:`flat_tick_step` one ``fused_tick`` launch (two with clip: a
``fused_combine`` launch, the norm, a ``fused_chain`` launch) — the
hand-written Hopper kernels of :mod:`repro_torch.kernels.adaptive_update.cuda`
on a CUDA tensor, their plain versions on a CPU tensor.  Both update ``p``,
the optimizer state and the ring IN PLACE.  On the CPU the plain versions are
the exact composition of the unfused ops, so the fused step is bitwise equal
to the link-by-link pipeline in f32 (the clip variant to round-off: its norm
runs over the flat buffer).  Every scalar stays a tensor: nothing here waits
for the device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.async_engine.delayed import DelayedGradients, flat_size
from repro_torch.optim import transform as T
from repro_torch.tree import tree_leaves

__all__ = [
    "FusionPlan",
    "plan_fusion",
    "fuse_pipeline",
    "flat_chain_step",
    "flat_tick_step",
]

_PREFIX_KINDS = ("staleness", "drop")
_BODIES = {
    ("scale",): "sgd",
    ("scale", "trace"): "momentum",
    ("fused_apply",): "momentum",
    ("adam", "scale"): "adam",
}
# Kinds deliberately left on the unfused path (none: clip folds into
# FusionPlan.clip, everything else is a prefix or a body).
UNFUSEABLE_KINDS: tuple = ()


@dataclasses.dataclass(eq=False)
class FusionPlan:
    """Static lowering decision for one chain."""

    kind: str  # kernel family member: "sgd" | "momentum" | "adam"
    scale: float  # signed base step (e.g. -lr)
    mu: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float | None = None
    staleness: T.StalenessTransform | None = None
    drop: T.GradientTransform | None = None


def plan_fusion(pipeline) -> FusionPlan | None:
    """Classify a pipeline's links; None when any link resists fusion."""
    if not isinstance(pipeline, T.GradientTransform):
        return None
    links = [link for link in T.iter_links(pipeline) if link.kind != "identity"]
    staleness = drop = None
    i = 0
    while i < len(links) and links[i].kind in _PREFIX_KINDS:
        link = links[i]
        if link.kind == "staleness":
            if staleness is not None:
                return None
            staleness = link
        else:
            if drop is not None:
                return None
            drop = link
        i += 1
    clip = None
    if i < len(links) and links[i].kind == "clip":
        clip = links[i].max_norm
        i += 1
    body = links[i:]
    kind = _BODIES.get(tuple(link.kind for link in body))
    if kind is None:
        return None
    plan = FusionPlan(kind=kind, scale=0.0, clip=clip, staleness=staleness, drop=drop)
    if body[0].kind == "fused_apply":
        plan.scale, plan.mu = -body[0].lr, body[0].mu
    elif kind == "adam":
        adam, sc = body
        plan.scale = sc.factor
        plan.b1, plan.b2, plan.eps = adam.b1, adam.b2, adam.eps
    else:
        plan.scale = body[0].factor
        if kind == "momentum":
            plan.mu = body[1].mu
    return plan


def _prefix_scalars(plan: FusionPlan, ctx: T.StepContext):
    """The staleness/drop factors for one step (1.0 when absorbed or absent)."""
    one = T.scalar(1.0)
    f_stale, f_keep = one, one
    if not ctx.staleness_applied:
        tau = 0 if ctx.tau is None else ctx.tau
        if plan.staleness is not None:
            f_stale = T.staleness_alpha(plan.staleness, ctx, tau) / T.scalar(plan.staleness.alpha_c)
        if plan.drop is not None:
            f_keep = (torch.as_tensor(tau) <= plan.drop.tau_drop).to(torch.float32)
    return f_stale, f_keep


def _family_scalars(plan: FusionPlan, g_flat, bufs, ctx: T.StepContext):
    """The scalar bundle for one fused step on ``g_flat`` plus the kernel's
    view of the family state and the new pipeline state:
    ``(scalars, kernel_bufs, new_bufs)``.  ``new_bufs`` shares the kernel's
    buffers (updated in place) and carries adam's incremented ``t``."""
    f_stale, f_keep = _prefix_scalars(plan, ctx)
    f_clip = T.scalar(1.0)
    if plan.clip is not None:
        pre = (f_stale * g_flat) * f_keep
        sq = torch.sum(torch.square(pre)) if ctx.sq_norm is None else ctx.sq_norm(pre)
        norm = torch.sqrt(sq)
        f_clip = torch.clamp(plan.clip / torch.clamp(norm, min=1e-9), max=1.0)
    scalars = {
        "f_stale": f_stale,
        "f_keep": f_keep,
        "f_clip": f_clip,
        "m_scale": T.scalar(plan.scale) * ctx.scale,
    }
    if plan.kind == "momentum":
        scalars["mu"] = T.scalar(plan.mu)
        return scalars, bufs, bufs
    if plan.kind == "adam":
        t = bufs["t"] + 1
        c1, c2 = T.adam_corrections(plan.b1, plan.b2, t)
        scalars.update(
            b1=T.scalar(plan.b1), omb1=T.scalar(1.0 - plan.b1),
            b2=T.scalar(plan.b2), omb2=T.scalar(1.0 - plan.b2),
            eps=T.scalar(plan.eps), c1=c1, c2=c2,
        )
        return scalars, {"m": bufs["m"], "v": bufs["v"]}, {"m": bufs["m"], "v": bufs["v"], "t": t}
    return scalars, (), bufs


def flat_chain_step(plan: FusionPlan, g_flat, bufs, p_flat, ctx=None):
    """One fused step in ONE launch, in place on ``p_flat`` and ``bufs``:
    returns ``(p_flat, new_bufs)``."""
    from repro_torch.kernels.adaptive_update.cuda import fused_chain

    ctx = T.StepContext() if ctx is None else ctx
    g_flat = g_flat.to(torch.float32)
    scalars, kernel_bufs, new_bufs = _family_scalars(plan, g_flat, bufs, ctx)
    fused_chain(plan.kind, p_flat, g_flat, kernel_bufs, scalars)
    return p_flat, new_bufs


def flat_tick_step(plan: FusionPlan, delayed: DelayedGradients, g_flat, taus, weights,
                   bufs, p_flat, ctx=None):
    """One whole async server tick, flat-resident and in place: ring push +
    alpha-weighted combine + scalars + body + apply.

    ``weights`` are the per-worker combine weights (alpha and drop folded in
    by the step factory).  Returns ``(p_flat, new_bufs, new_delayed, live)``;
    ``new_delayed`` holds the same ring tensor and ``step + 1``.  A clip-less
    chain is ONE ``fused_tick`` launch; the clip variant is a
    ``fused_combine`` launch, the norm, and a ``fused_chain`` launch.
    """
    from repro_torch.kernels.adaptive_update.cuda import fused_combine, fused_tick

    ctx = T.StepContext() if ctx is None else ctx
    g_flat = g_flat.to(torch.float32)
    if plan.clip is not None:
        g_eff, live = fused_combine(g_flat, delayed.ring, delayed.step, taus, weights)
        p_flat, new_bufs = flat_chain_step(plan, g_eff, bufs, p_flat, ctx)
    else:
        scalars, kernel_bufs, new_bufs = _family_scalars(plan, g_flat, bufs, ctx)
        live = fused_tick(plan.kind, p_flat, g_flat, kernel_bufs, scalars,
                          delayed.ring, delayed.step, taus, weights)
    return p_flat, new_bufs, DelayedGradients(ring=delayed.ring, step=delayed.step + 1), live


def fuse_pipeline(pipeline) -> T.Chain | None:
    """Lower a fuseable chain to its one-kernel form (else None).

    The result is a terminal chain (``kind="fused_chain"``) that keeps the
    original links in ``.links`` for introspection.  Its state is
    ``{"p", "bufs"}``: ``bufs`` is the family's flat state and ``p`` a
    resident flat copy of tree params (None for flat-native params, whose
    buffer IS the packed view).
    """
    plan = plan_fusion(pipeline)
    if plan is None:
        return None

    def _family_bufs(n, device):
        if plan.kind == "momentum":
            return torch.zeros((n,), dtype=torch.float32, device=device)
        if plan.kind == "adam":
            return {
                "m": torch.zeros((n,), dtype=torch.float32, device=device),
                "v": torch.zeros((n,), dtype=torch.float32, device=device),
                "t": torch.zeros((), dtype=torch.int32, device=device),
            }
        return ()

    def init(params):
        if isinstance(params, torch.Tensor) and params.dim() == 1:
            return {"p": None, "bufs": _family_bufs(params.shape[0], params.device)}
        leaves = tree_leaves(params)
        all_f32 = all(leaf.dtype == torch.float32 for leaf in leaves)
        return {
            "p": T.pack_flat(params) if all_f32 else None,
            "bufs": _family_bufs(flat_size(params), leaves[0].device),
        }

    def update(u, state, params, ctx=None):
        assert isinstance(state, dict) and set(state) == {"p", "bufs"}, (
            "fused pipeline got a non-fused opt state — initialize it with the "
            "same fuse=True flag (init_train_state)"
        )
        g_flat = u if isinstance(u, torch.Tensor) else T.pack_flat(u)
        flat_native = isinstance(params, torch.Tensor)
        if state["p"] is not None:
            p_flat = state["p"]
        else:
            p_flat = params if flat_native else T.pack_flat(params)
        p_new, bufs = flat_chain_step(plan, g_flat, state["bufs"], p_flat, ctx)
        new_state = {"p": state["p"], "bufs": bufs}
        return (p_new if flat_native else T.unpack_flat(p_new, params)), new_state

    fused = T.Chain(
        init=init,
        update=update,
        applies_params=True,
        kind="fused_chain",
        links=tuple(T.iter_links(pipeline)),
    )
    fused.plan = plan
    return fused
