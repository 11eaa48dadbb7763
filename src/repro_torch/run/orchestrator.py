"""The One Run API: ``run(spec, hooks=...)`` (port of
``src/repro/run/orchestrator.py``).

    state = engine.build()                    # or restore via resume_from
    for step in start_step+1..num_steps:
        state, metrics = engine.tick(state, batch)
        if refresh boundary: state = engine.refresh(state)   # then on_refresh
        hooks.on_tick
    state = engine.finish(state); hooks.on_end   # (failure path: engine.abort())

Resume is first-class: ``resume_from=directory`` restores the latest
full-fidelity checkpoint (device state + host estimator sidecar,
:mod:`repro_torch.run.ckpt`) into the engine's shape-only template and
continues bit-identically to the uninterrupted run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.run.engine import make_engine
from repro_torch.run.hooks import Hook
from repro_torch.run.spec import RunSpec

__all__ = ["RunContext", "RunResult", "run"]


@dataclasses.dataclass
class RunContext:
    """Live run state handed to every hook callback.

    ``step`` counts *completed* ticks (equals ``start_step`` until the first
    tick of this process).  ``metrics`` is the latest tick's metric dict
    (device tensors — hooks convert them only when they consume them).
    ``history`` and ``records`` are shared scratch: LogHook appends history
    rows; BenchHook and EvalHook file theirs under ``records[name]``.
    """

    spec: RunSpec
    engine: Any
    state: Any
    step: int = 0
    start_step: int = 0
    metrics: dict | None = None
    history: list = dataclasses.field(default_factory=list)
    records: dict = dataclasses.field(default_factory=dict)

    @property
    def is_last(self) -> bool:
        return self.step == self.spec.num_steps


@dataclasses.dataclass
class RunResult:
    """What a run hands back: final state, history rows, bench records."""

    state: Any
    history: list
    records: dict
    step: int
    start_step: int = 0


def run(
    spec: RunSpec,
    hooks: Sequence[Hook] = (),
    *,
    resume_from: str | None = None,
    resume_step: int | None = None,
    engine: Any = None,
) -> RunResult:
    """Execute ``spec`` under the hook lifecycle.

    ``resume_from`` names a :class:`~repro_torch.run.hooks.CheckpointHook`
    directory: the latest checkpoint (or ``resume_step``) is restored into
    the engine's template — same spec, same fuse layout — on ``spec.device``
    and the loop continues from there, bit-identical to the uninterrupted run.
    """
    if engine is None:
        engine = make_engine(spec)
    start_step = 0
    if resume_from is not None:
        from repro_torch.run.ckpt import restore_checkpoint

        state, start_step = restore_checkpoint(
            resume_from, engine.build_template(), engine.pipeline, step=resume_step,
            device=spec.device,
        )
        if start_step > spec.num_steps:
            raise ValueError(
                f"checkpoint step {start_step} is beyond num_steps={spec.num_steps}")
    else:
        state = engine.build()
    if spec.refresh_every:
        engine.require_refreshable(state)
    ctx = RunContext(spec=spec, engine=engine, state=state, step=start_step,
                     start_step=start_step)
    batches = spec.batch_stream(start_step)
    for hook in hooks:
        hook.on_start(ctx)
    try:
        for i in range(start_step, spec.num_steps):
            state, metrics = engine.tick(state, next(batches))
            ctx.state, ctx.metrics, ctx.step = state, metrics, i + 1
            if spec.refresh_every and (i + 1) % spec.refresh_every == 0:
                state = ctx.state = engine.refresh(state)
                for hook in hooks:
                    hook.on_refresh(ctx)
            for hook in hooks:
                hook.on_tick(ctx)
    except BaseException:
        engine.abort()
        raise
    ctx.state = engine.finish(ctx.state)
    for hook in hooks:
        hook.on_end(ctx)
    return RunResult(state=ctx.state, history=ctx.history, records=ctx.records,
                     step=ctx.step, start_step=start_step)
