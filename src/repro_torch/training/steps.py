"""Train and serve step factories (port of ``src/repro/training/steps.py``).

One factory, :func:`make_step`, produces the training step from a single
gradient-transform pipeline:

* ``mode="sync"``  — loss -> grad -> pipeline (the SyncPSGD baseline);
* ``mode="async"`` — MindTheStep-AsyncPSGD as async-as-delay: per tick ``W``
  worker taus are drawn from the inverse-CDF table in ``state.adapt``, the
  matching delayed gradients are combined from the ring with weights
  ``alpha(tau_w) / (alpha_c W)`` (the pipeline's ``scale_by_staleness`` and
  ``drop_stale`` links are absorbed into these weights) and the rest of the
  pipeline runs on the combined gradient;
* ``mode="sharded_async"`` — the same W-worker simulation with per-worker
  rings, heterogeneous tau samplers (CDF rows or replayed traces) and
  per-worker histograms (:class:`~repro_torch.training.adapt.WorkerAdaptState`),
  the workers split over the processes of a
  :class:`~repro_torch.launch.mesh.WorkersMesh`; each rank combines its own
  workers and one ``all_reduce`` sums the partial combines.

``fuse=True`` lowers the pipeline to the fused kernels
(:mod:`repro_torch.optim.fuse`): the ring is one flat ``(K, N)`` buffer, f32
params are flat-NATIVE (``TrainState.params`` is the packed ``(N,)`` buffer,
viewed leaf-wise only inside the loss, so autograd returns the packed
gradient) and the async tick is one ``fused_tick`` launch that updates
params, velocity and ring in place (in sharded mode the per-worker combine
stays plain and the apply is one ``fused_chain`` launch).  Inside the port
the fused trajectory is bitwise equal (f32, CPU) to the link-by-link one.

Nothing in a step waits for the device: taus, weights, the histogram and
every scalar stay tensors on the state's device, and the metrics come back as
0-d device tensors (a logger converts them when it prints).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.async_engine.delayed import (
    DelayedGradients,
    WorkerRing,
    delayed_combine,
    init_delayed,
    init_flat_delayed,
    init_flat_worker_ring,
    init_worker_ring,
    worker_ring_combine,
)
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of
from repro_torch.optim import transform as T
from repro_torch.training.adapt import (
    AdaptState,
    WorkerAdaptState,
    alpha_lookup,
    record_taus,
    record_worker_taus,
    sample_taus,
    sample_worker_taus,
)
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "TrainState",
    "init_params",
    "param_template",
    "param_view",
    "init_train_state",
    "init_sharded_async_state",
    "make_step",
    "make_sharded_async_train_step",
    "make_serve_step",
]

MODES = ("sync", "async", "sharded_async")
f32 = torch.float32


@dataclasses.dataclass
class TrainState:
    params: Any  # flat (N,) f32 tensor (fused, flat-native) or a nested dict
    opt_state: Any
    step: torch.Tensor  # int32 0-d, on the params' device
    rng: torch.Generator | None  # draws the workers' uniforms (async mode)
    delayed: DelayedGradients | WorkerRing | None = None
    adapt: AdaptState | WorkerAdaptState | None = None


def init_params(seed: int, cfg, device="cuda") -> Any:
    """Random params from ``seed`` (torch's draws: the reference's jax draws
    cannot be reproduced — parity tests carry the reference's params over
    with :mod:`repro_torch.bridge`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return M.init_model(gen, cfg, device)


def param_template(cfg) -> Any:
    """The param tree's ``(shape, dtype)`` leaves, with nothing allocated."""
    meta = M.init_model(None, cfg, "meta")
    return tree_map(lambda t: (tuple(t.shape), t.dtype), meta)


def param_view(params, cfg) -> Any:
    """Tree view of params that may be flat-native (accepts a TrainState)."""
    params = getattr(params, "params", params)
    if isinstance(params, torch.Tensor) and params.dim() == 1:
        return T.flat_view(params, param_template(cfg))
    return params


def _fused_form(pipeline):
    from repro_torch.optim.fuse import fuse_pipeline

    return fuse_pipeline(pipeline) if isinstance(pipeline, T.GradientTransform) else None


def init_train_state(
    cfg,
    opt,
    *,
    seed: int = 0,
    device="cuda",
    async_ring: int = 0,
    adapt: AdaptState | None = None,
    params: Any | None = None,
    fuse: bool = False,
    ring_dtype: Any = None,
) -> TrainState:
    """Initial state.  ``fuse=True`` builds the fused layout for a fuseable
    pipeline: flat optimizer state, a flat ``(K, N)`` ring and, for f32
    params, flat-native params.  ``params`` may be a tree or a packed
    ``(N,)`` buffer (e.g. from :func:`repro_torch.bridge.params_from_jax`);
    params on ``meta`` give a shape-only state (the resume template).

    As the reference, f32 leaves are first stored in ``cfg.param_dtype``: a
    bf16 tree is then not flat-native and gets a bf16 ring
    (:func:`ring_dtype_for`)."""
    if params is None:
        params = init_params(seed, cfg, device)
    fused = _fused_form(opt) if fuse else None
    flat_given = isinstance(params, torch.Tensor)
    if flat_given and (fused is None or cfg.param_dtype != "float32"):
        params = T.flat_view(params, param_template(cfg))
        flat_given = False
    if cfg.param_dtype != "float32":
        pd = dtype_of(cfg.param_dtype)
        params = tree_map(lambda p: p.to(pd) if p.dtype == f32 else p, params)
    if fused is not None and not flat_given and all(
        leaf.dtype == f32 for leaf in tree_leaves(params)
    ):
        params = T.pack_flat(params)
    dev = tree_leaves(params)[0].device
    init_ring = init_flat_delayed if fused is not None else init_delayed
    return TrainState(
        params=params,
        opt_state=(fused or opt).init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        # a shape-only (meta) state still needs a real generator: on ``device``
        rng=torch.Generator(device=device if dev.type == "meta" else dev).manual_seed(seed + 1),
        delayed=init_ring(params, async_ring, dtype=ring_dtype) if async_ring else None,
        adapt=adapt,
    )


def _resolve_alpha_c(alpha_c, transform) -> float:
    if alpha_c is not None:
        return alpha_c
    link = T.staleness_link(transform)
    return link.alpha_c if link is not None else 1.0


def _drop_mask(transform, taus):
    link = T.drop_link(transform)
    if link is None:
        return None
    return (taus <= link.tau_drop).to(f32)


def _check_absorbable_order(transform):
    """The async step absorbs staleness/drop into the combine weights (the
    front of the update): reject chains that place them after another link."""
    kinds = [link.kind for link in T.iter_links(transform)]
    non_absorbed = [i for i, k in enumerate(kinds) if k not in ("staleness", "drop", "identity")]
    misordered = non_absorbed and any(
        k in ("staleness", "drop") for k in kinds[non_absorbed[0]:]
    )
    assert not misordered, (
        f"async mode absorbs scale_by_staleness/drop_stale into the ring combine "
        f"weights, but this pipeline places one after a {kinds[non_absorbed[0]]!r} "
        f"link (chain order: {kinds}) — put the staleness/drop links first"
    )


def make_step(
    cfg,
    pipeline,
    *,
    mode: str = "sync",
    alpha_c: float | None = None,
    num_workers: int = 1,
    fuse: bool = False,
    tau_source: Callable[[], torch.Tensor] | None = None,
    mesh=None,
) -> Callable:
    """``(TrainState, batch) -> (TrainState, metrics)`` for ``mode``.

    ``tau_source`` (async modes) returns the tick's ``(W,)`` uniforms; by
    default they are drawn from ``state.rng`` on the state's device (in
    sharded mode every rank draws all ``W`` and keeps its own workers').  A
    test hands in the reference's own draws here.  ``mesh`` (sharded mode)
    is the :class:`~repro_torch.launch.mesh.WorkersMesh`; the sharded mode
    takes W from ``state.adapt``.  A pipeline the fusion compiler cannot
    classify falls back to link-by-link execution with a warning.
    """
    assert mode in MODES, f"mode must be one of {MODES}, got {mode!r}"
    assert isinstance(pipeline, T.GradientTransform), "make_step needs a GradientTransform"
    transform = pipeline
    fused_flat = False
    plan = None
    if fuse:
        fused = _fused_form(pipeline)
        if fused is None:
            warnings.warn(
                "make_step(fuse=True): pipeline is not fuseable (unrecognized "
                "link or ordering) — falling back to link-by-link execution",
                stacklevel=2,
            )
        else:
            transform, fused_flat, plan = fused, True, fused.plan
    alpha_c = _resolve_alpha_c(alpha_c, transform)
    if mode != "sync":
        _check_absorbable_order(transform)
    template = param_template(cfg)

    def apply_fn(grads, opt_state, params, ctx):
        return T.run_pipeline(transform, grads, opt_state, params, ctx)

    def loss_and_grads(params, batch):
        if isinstance(params, torch.Tensor):
            # flat-native: the model sees the leaf-wise view only inside the
            # loss; the gradient of the view is the packed gradient
            leaf = params.detach().requires_grad_(True)
            loss, metrics = M.loss_fn(T.flat_view(leaf, template), batch, cfg)
            (grads,) = torch.autograd.grad(loss, leaf)
        else:
            leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, metrics = M.loss_fn(leaves, batch, cfg)
            flat = tree_leaves(leaves)
            it = iter(torch.autograd.grad(loss, flat))
            grads = tree_map(lambda _: next(it), leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def _flat_grads(grads):
        return grads if isinstance(grads, torch.Tensor) else T.pack_flat(grads)

    if mode == "sync":

        def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
            loss, metrics, grads = loss_and_grads(state.params, batch)
            ctx = T.StepContext(adapt=state.adapt)
            with torch.no_grad():
                new_params, new_opt = apply_fn(grads, state.opt_state, state.params, ctx)
            return dataclasses.replace(
                state, params=new_params, opt_state=new_opt, step=state.step + 1
            ), {"loss": loss, **metrics}

        return train_step

    if mode == "sharded_async":
        if mesh is None:
            from repro_torch.launch.mesh import make_workers_mesh

            mesh = make_workers_mesh()
        group = mesh.group

        def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
            adapt, ring = state.adapt, state.delayed
            assert isinstance(adapt, WorkerAdaptState), (
                "sharded async step needs a WorkerAdaptState (see make_worker_adapt)")
            assert isinstance(ring, WorkerRing), (
                "sharded async step needs per-worker rings (see init_sharded_async_state)")
            assert isinstance(ring.ring, torch.Tensor) == fused_flat, (
                f"worker ring layout does not match make_step(fuse={fuse}) — initialize the "
                "state with the same fuse= flag (init_sharded_async_state)"
            )
            W = adapt.num_workers
            lo, hi = mesh.local_workers(W)
            loss, metrics, grads = loss_and_grads(state.params, batch)
            with torch.no_grad():
                if fused_flat:
                    grads = _flat_grads(grads)
                dev = state.step.device
                u = tau_source() if tau_source is not None else torch.rand(
                    W, generator=state.rng, device=dev)
                u = u.to(dev)[lo:hi]
                taus = sample_worker_taus(u, adapt.tau_cdf[lo:hi], adapt.tau_trace[lo:hi],
                                          adapt.use_trace[lo:hi], ring.step)
                alpha = alpha_lookup(adapt, taus)
                weights = alpha / np.float32(alpha_c * W)
                keep = _drop_mask(transform, taus)
                if keep is not None:
                    weights = weights * keep
                g_eff, live, new_ring = worker_ring_combine(
                    ring.ring, ring.step, grads, taus, weights, group=group)
                record_worker_taus(adapt.hist[lo:hi], taus)
                stats = torch.stack([taus.to(f32).sum(), alpha.sum(), live.sum()])
                if group is not None:
                    torch.distributed.all_reduce(stats, group=group)
                ctx = T.StepContext(adapt=adapt, staleness_applied=True)
                new_params, new_opt = apply_fn(g_eff, state.opt_state, state.params, ctx)
            new_state = TrainState(
                params=new_params, opt_state=new_opt, step=state.step + 1, rng=state.rng,
                delayed=WorkerRing(ring=new_ring, step=ring.step + 1), adapt=adapt,
            )
            return new_state, {
                "loss": loss,
                "tau_mean": stats[0] / W,
                "alpha_mean": stats[1] / W,
                "live_frac": stats[2] / W,
                **metrics,
            }

        return train_step

    W = int(num_workers)
    assert W >= 1
    inv_scale = np.float32(alpha_c * W)  # alpha / f32(alpha_c * W), as the reference

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        assert state.adapt is not None, "async step needs TrainState.adapt (see make_adapt)"
        assert state.delayed is not None, "async step needs a delayed ring (async_ring > 0)"
        assert isinstance(state.delayed.ring, torch.Tensor) == fused_flat, (
            f"delayed ring layout does not match make_step(fuse={fuse}) — "
            "initialize the state with the same fuse= flag (init_train_state)"
        )
        loss, metrics, grads = loss_and_grads(state.params, batch)
        with torch.no_grad():
            dev = state.step.device
            u = tau_source() if tau_source is not None else torch.rand(
                W, generator=state.rng, device=dev)
            taus = sample_taus(u.to(dev), state.adapt.tau_cdf)
            alpha = alpha_lookup(state.adapt, taus)
            weights = alpha / inv_scale
            keep = _drop_mask(transform, taus)
            if keep is not None:
                weights = weights * keep
            adapt = record_taus(state.adapt, taus)
            ctx = T.StepContext(taus=taus, adapt=adapt, staleness_applied=True)
            if fused_flat:
                from repro_torch.optim.fuse import flat_tick_step

                opt = state.opt_state
                flat_params = isinstance(state.params, torch.Tensor)
                if opt["p"] is not None:
                    p_flat = opt["p"]
                else:
                    p_flat = state.params if flat_params else T.pack_flat(state.params)
                p_new, bufs, new_ring, live = flat_tick_step(
                    plan, state.delayed, _flat_grads(grads), taus, weights,
                    opt["bufs"], p_flat, ctx,
                )
                new_opt = {"p": opt["p"], "bufs": bufs}
                new_params = p_new if flat_params else T.unpack_flat(p_new, state.params)
            else:
                g_eff, live, new_ring = delayed_combine(state.delayed, grads, taus, weights)
                new_params, new_opt = apply_fn(g_eff, state.opt_state, state.params, ctx)
        new_state = TrainState(
            params=new_params, opt_state=new_opt, step=state.step + 1,
            rng=state.rng, delayed=new_ring, adapt=adapt,
        )
        return new_state, {
            "loss": loss,
            "tau_mean": torch.mean(taus.to(f32)),
            "alpha_mean": torch.mean(alpha),
            "live_frac": torch.mean(live),
            **metrics,
        }

    return train_step


def make_sharded_async_train_step(cfg, opt, *, alpha_c: float, mesh=None) -> Callable:
    """MindTheStep-AsyncPSGD over the workers of ``mesh``; see
    :func:`make_step` ``mode="sharded_async"``."""
    return make_step(cfg, opt, mode="sharded_async", alpha_c=alpha_c, mesh=mesh)


def init_sharded_async_state(
    cfg,
    opt,
    *,
    ring: int,
    adapt: WorkerAdaptState,
    seed: int = 0,
    device="cuda",
    params: Any | None = None,
    mesh=None,
    fuse: bool = False,
    ring_dtype: Any = None,
) -> TrainState:
    """TrainState for the sharded engine: this rank's per-worker rings
    (``(W_local, K, ...)``, W from ``adapt``) and the WorkerAdaptState.
    ``fuse=True`` builds the fused layout (flat optimizer state and one
    ``(W_local, K, N)`` ring buffer) for a fuseable pipeline; pair it with
    ``make_step(..., fuse=True)``."""
    if mesh is None:
        from repro_torch.launch.mesh import make_workers_mesh

        mesh = make_workers_mesh(device=device)
    state = init_train_state(cfg, opt, seed=seed, device=device, async_ring=0, adapt=adapt,
                             params=params, fuse=fuse)
    init_wring = init_flat_worker_ring if fuse and _fused_form(opt) is not None else init_worker_ring
    lo, hi = mesh.local_workers(adapt.num_workers)
    return dataclasses.replace(
        state, delayed=init_wring(state.params, ring, hi - lo, dtype=ring_dtype))


def make_serve_step(cfg) -> Callable:
    """One batched greedy decode step: (params, cache, token, pos) ->
    {next_token, logits, cache}; the cache is updated in place."""

    def serve_step(params, cache, token: torch.Tensor, pos):
        logits, new_cache = M.decode_step(params, cache, token, pos, cfg)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"next_token": next_token, "logits": logits, "cache": new_cache}

    return serve_step
