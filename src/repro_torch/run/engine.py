"""Engines: one execution surface per mode (port of ``src/repro/run/engine.py``).

``build()`` makes the initial state, ``tick(state, batch)`` runs one step,
``refresh(state)`` is the host-side adaptation boundary (drain the
histogram, refit, write the new table into the same tensors), and
``finish``/``abort`` close the lifecycle.  PyTorch runs eagerly, so there is
no compile to count; the fused layout updates its buffers in place, so a
build copies any tensors it takes from the spec (``spec.params``,
``spec.adapt``) and a run never mutates them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.run.spec import RunSpec

__all__ = ["SyncEngine", "AsyncEngine", "make_engine"]


def _refresher_of(pipeline):
    from repro_torch.optim import transform as T

    link = T.staleness_link(pipeline)
    assert link is not None, "refresh requested but the pipeline has no scale_by_staleness link"
    return link


class _EngineBase:
    mode = ""

    def __init__(self, spec: RunSpec):
        self.spec = spec
        self.pipeline = spec.pipeline
        self._tick: Callable | None = None

    def _params(self):
        p = self.spec.params
        if isinstance(p, torch.Tensor):
            return p.to(self.spec.device, copy=True)
        if isinstance(p, dict):
            from repro_torch.tree import tree_map

            return tree_map(lambda t: t.to(self.spec.device, copy=True), p)
        return p

    def _adapt(self):
        a = self.spec.adapt
        return None if a is None else a.to(self.spec.device).clone()

    def build(self):
        from repro_torch.training.steps import init_train_state

        spec = self.spec
        return init_train_state(
            spec.cfg, spec.pipeline, seed=spec.seed, device=spec.device,
            async_ring=spec.ring if self.mode == "async" else 0,
            adapt=self._adapt(), params=self._params(), fuse=spec.fuse,
            ring_dtype=spec.ring_dtype,
        )

    def _make_step(self) -> Callable:
        from repro_torch.training.steps import make_step

        spec = self.spec
        return make_step(
            spec.cfg, spec.pipeline, mode=self.mode, alpha_c=spec.alpha_c,
            num_workers=spec.num_workers, fuse=spec.fuse, tau_source=spec.tau_source,
        )

    def tick(self, state, batch):
        if self._tick is None:
            self._tick = self._make_step()
        return self._tick(state, batch)

    def require_refreshable(self, state) -> None:
        _refresher_of(self.pipeline)
        assert getattr(state, "adapt", None) is not None, (
            "refresh requested but the state carries no AdaptState (RunSpec.adapt)"
        )

    def refresh(self, state):
        from repro_torch.training.adapt import host_refresh

        self.require_refreshable(state)
        host_refresh(state.adapt, _refresher_of(self.pipeline))
        return state

    def finish(self, state):
        return state

    def abort(self) -> None:
        pass


class SyncEngine(_EngineBase):
    """Synchronous engine (paper §III SyncPSGD baseline)."""

    mode = "sync"


class AsyncEngine(_EngineBase):
    """MindTheStep-AsyncPSGD engine: W-worker async-as-delay simulation."""

    mode = "async"

    def __init__(self, spec: RunSpec):
        super().__init__(spec)
        assert spec.ring > 0, "async mode needs RunSpec.ring (delayed-ring depth)"
        assert spec.adapt is not None, "async mode needs RunSpec.adapt (see make_adapt)"


_ENGINES = {"sync": SyncEngine, "async": AsyncEngine}


def make_engine(spec: RunSpec) -> Any:
    return _ENGINES[spec.mode](spec)
