"""The One Run API: ``run(spec, hooks=...)`` (port of
``src/repro/run/orchestrator.py``, without checkpoint resume).

    state = engine.build()
    for step in 1..num_steps:
        state, metrics = engine.tick(state, batch)
        if refresh boundary: state = engine.refresh(state)   # then on_refresh
        hooks.on_tick
    state = engine.finish(state); hooks.on_end
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
    spec: RunSpec
    engine: Any
    state: Any
    step: int = 0
    metrics: dict | None = None
    history: list = dataclasses.field(default_factory=list)

    @property
    def is_last(self) -> bool:
        return self.step == self.spec.num_steps


@dataclasses.dataclass
class RunResult:
    state: Any
    history: list
    step: int


def run(spec: RunSpec, hooks: Sequence[Hook] = (), *, engine: Any = None) -> RunResult:
    """Execute ``spec`` under the hook lifecycle."""
    if engine is None:
        engine = make_engine(spec)
    state = engine.build()
    if spec.refresh_every:
        engine.require_refreshable(state)
    ctx = RunContext(spec=spec, engine=engine, state=state)
    batches = spec.batch_stream()
    for hook in hooks:
        hook.on_start(ctx)
    try:
        for i in range(spec.num_steps):
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
    return RunResult(state=ctx.state, history=ctx.history, step=ctx.step)
