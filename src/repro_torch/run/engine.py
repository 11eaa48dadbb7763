"""Engines: one execution surface per mode (port of ``src/repro/run/engine.py``).

``build()`` makes the initial state, ``tick(state, batch)`` runs one step,
``refresh(state)`` is the host-side adaptation boundary (drain the
histogram, refit, write the new table into the same tensors), and
``finish``/``abort``/``liveness`` close the lifecycle (no-ops here: no engine
of the port runs live machinery yet).  ``build_template()`` is the resume
path's shape-only state: its tensors live on ``meta``, so restoring a
full-width checkpoint never builds the state it is about to overwrite.

PyTorch runs eagerly, so there is no compile to count: ``retraces`` is None
and :class:`~repro_torch.run.hooks.BenchHook` leaves out its retrace row,
as the reference does for a precompiled :class:`PrebuiltEngine`.  The fused
layout updates its buffers in place, so a build copies any tensors it takes
from the spec (``spec.params``, ``spec.adapt``) and a run never mutates them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.run.spec import RunSpec

__all__ = ["SyncEngine", "AsyncEngine", "ShardedAsyncEngine", "PrebuiltEngine", "make_engine"]


def _refresher_of(pipeline):
    """The refresh-capable handle of ``pipeline``; shares
    :func:`repro_torch.run.ckpt.refresh_link_of`'s resolution, so the
    checkpointed host state and the object a refresh mutates are the same."""
    from repro_torch.run.ckpt import refresh_link_of

    link = refresh_link_of(pipeline)
    assert link is not None, "refresh requested but the pipeline has no scale_by_staleness link"
    return link


class _EngineBase:
    mode = ""
    retraces = None  # eager PyTorch: nothing is traced, so nothing to count

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

    def _build(self, params, adapt):
        from repro_torch.training.steps import init_train_state

        spec = self.spec
        return init_train_state(
            spec.cfg, spec.pipeline, seed=spec.seed, device=spec.device,
            async_ring=spec.ring if self.mode == "async" else 0,
            adapt=adapt, params=params, fuse=spec.fuse, ring_dtype=spec.ring_dtype,
        )

    def build(self):
        return self._build(self._params(), self._adapt())

    def build_template(self):
        """The state's structure, shapes and dtypes with nothing allocated:
        every tensor on ``meta``, the generator (which cannot be) on the
        run's device.  The resume path restores into it."""
        from repro_torch.models import model as M
        from repro_torch.tree import tree_map

        spec = self.spec
        if spec.params is None:
            params = M.init_model(None, spec.cfg, "meta")
        else:
            params = tree_map(lambda t: torch.empty_like(t, device="meta"), spec.params)
        adapt = None if spec.adapt is None else spec.adapt.to("meta")
        return self._build(params, adapt)

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

    def liveness(self) -> dict:
        return {}


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


class ShardedAsyncEngine(_EngineBase):
    """The W-worker simulation with per-worker rings and samplers, the
    workers split over the processes of ``spec.mesh``."""

    mode = "sharded_async"

    def __init__(self, spec: RunSpec):
        super().__init__(spec)
        assert spec.ring > 0, "sharded_async mode needs RunSpec.ring"
        assert spec.adapt is not None, (
            "sharded_async mode needs RunSpec.adapt (a WorkerAdaptState; see make_worker_adapt)")
        self.mesh = spec.mesh
        if self.mesh is None:
            from repro_torch.launch.mesh import make_workers_mesh

            self.mesh = make_workers_mesh(device=spec.device)

    def _build(self, params, adapt):
        from repro_torch.training.steps import init_sharded_async_state

        spec = self.spec
        return init_sharded_async_state(
            spec.cfg, spec.pipeline, ring=spec.ring, adapt=adapt, seed=spec.seed,
            device=spec.device, params=params, mesh=self.mesh, fuse=spec.fuse,
            ring_dtype=spec.ring_dtype,
        )

    def _make_step(self) -> Callable:
        from repro_torch.training.steps import make_step

        spec = self.spec
        return make_step(spec.cfg, spec.pipeline, mode=self.mode, alpha_c=spec.alpha_c,
                         fuse=spec.fuse, tau_source=spec.tau_source, mesh=self.mesh)

    def refresh(self, state):
        from repro_torch.training.adapt import worker_host_refresh

        self.require_refreshable(state)
        worker_host_refresh(state.adapt, _refresher_of(self.pipeline), group=self.mesh.group)
        return state


class PrebuiltEngine(_EngineBase):
    """Adapter for a hand-built ``(step_fn, state)`` pair: ``build()`` and
    ``build_template()`` return that state, ``tick`` calls ``step_fn``."""

    def __init__(self, step_fn: Callable, state: Any, *, pipeline=None,
                 spec: RunSpec | None = None):
        super().__init__(spec if spec is not None else RunSpec())
        self.pipeline = pipeline
        self._state = state
        self._tick = step_fn

    def build(self):
        return self._state

    def build_template(self):
        return self._state


_ENGINES = {"sync": SyncEngine, "async": AsyncEngine, "sharded_async": ShardedAsyncEngine}


def make_engine(spec: RunSpec) -> Any:
    return _ENGINES[spec.mode](spec)
