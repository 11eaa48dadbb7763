"""DEPRECATED: ``train_loop`` is a shim over the One Run API (port of
``src/repro/training/loop.py``).

New code calls :func:`repro_torch.run.run` with a
:class:`repro_torch.run.RunSpec` and hooks.  The shim adapts the historical
``(step_fn, state, batches)`` signature onto the orchestrator through a
:class:`~repro_torch.run.engine.PrebuiltEngine` and a
:class:`~repro_torch.run.hooks.LogHook`: its trajectory, history rows and
log lines are those of calling ``run`` directly
(``tests/test_torch_optim_shims.py``).  A refresh goes through
``host_refresh`` (or ``worker_host_refresh`` for a per-worker state) with
``refresh_kwargs`` and the shim's ``logger``, as the reference's does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

__all__ = ["train_loop"]


def train_loop(
    step_fn: Callable,
    state,
    batches: Iterable[Any],
    *,
    num_steps: int,
    pipeline=None,
    refresh_every: int = 0,
    refresh_kwargs: dict | None = None,
    mesh=None,
    log_every: int = 50,
    logger: Callable[[str], None] = print,
    checkpoint_fn: Callable[[Any, int], None] | None = None,
    checkpoint_every: int = 0,
) -> tuple[Any, list[dict]]:
    """Run ``num_steps`` of ``step_fn`` over ``batches``; returns (state,
    history).  ``pipeline`` (the chain the step was built from) with
    ``refresh_every`` turns on online adaptation; ``mesh`` (a
    :class:`~repro_torch.launch.mesh.WorkersMesh`) merges a per-worker
    histogram across processes."""
    from repro_torch.run import Hook, LogHook, PrebuiltEngine, RunSpec, run
    from repro_torch.run.engine import _refresher_of

    if pipeline is not None and refresh_every:
        _refresher_of(pipeline)  # fail fast: the pipeline must carry a refresher
    spec = RunSpec(pipeline=pipeline, num_steps=num_steps, batches=batches, mesh=mesh,
                   refresh_every=refresh_every if pipeline is not None else 0)
    kwargs = {"logger": logger, **(refresh_kwargs or {})}

    class _Engine(PrebuiltEngine):
        def refresh(self, state):
            from repro_torch.training.adapt import (
                WorkerAdaptState,
                host_refresh,
                worker_host_refresh,
            )

            self.require_refreshable(state)
            link = _refresher_of(self.pipeline)
            if isinstance(state.adapt, WorkerAdaptState):
                worker_host_refresh(state.adapt, link, group=getattr(mesh, "group", None),
                                    **kwargs)
            else:
                host_refresh(state.adapt, link, **kwargs)
            return state

    hooks: list[Hook] = [LogHook(log_every=log_every, logger=logger)]
    if checkpoint_fn is not None and checkpoint_every:

        class _FnCheckpoint(Hook):
            def on_tick(self, ctx):
                if ctx.step % checkpoint_every == 0:
                    checkpoint_fn(ctx.state, ctx.step)

        hooks.append(_FnCheckpoint())
    result = run(spec, hooks=hooks, engine=_Engine(step_fn, state, pipeline=pipeline, spec=spec))
    return result.state, result.history
