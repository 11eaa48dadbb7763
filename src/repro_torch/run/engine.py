"""Engines: one execution surface per mode (port of ``src/repro/run/engine.py``).

``build()`` makes the initial state, ``tick(state, batch)`` runs one step,
``refresh(state)`` is the host-side adaptation boundary (drain the
histogram, refit, write the new table into the same tensors), and
``finish``/``abort``/``liveness`` close the lifecycle (no-ops for the
engines here; the live parameter server's
:class:`~repro_torch.distributed.engine.DistributedAsyncEngine` runs them).
:class:`Engine` is the protocol all of them satisfy.  ``build_template()``
is the resume path's shape-only state: its tensors live on ``meta``, so
restoring a full-width checkpoint never builds the state it is about to
overwrite.  Under a running sharded mesh (a rank of a multi-process run)
it is the rank's, and ``checkpoint_layout()`` says where it sits in the
one-process state, which a checkpoint holds (:mod:`repro_torch.run.ckpt`).

PyTorch runs eagerly, so there is no compile to count: ``retraces`` is None
and :class:`~repro_torch.run.hooks.BenchHook` leaves out its retrace row,
as the reference does for a precompiled :class:`PrebuiltEngine`.  The fused
layout updates its buffers in place, so a build copies any tensors it takes
from the spec (``spec.params``, ``spec.adapt``) and a run never mutates them.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.run.spec import RunSpec

__all__ = ["Engine", "SyncEngine", "AsyncEngine", "ShardedAsyncEngine", "PrebuiltEngine",
           "make_engine"]


@runtime_checkable
class Engine(Protocol):
    """The execution surface of one run.  The orchestrator calls every one
    of these without ``hasattr`` probing::

        build (or build_template + checkpoint restore)   # once
        tick*                                            # the training loop
        refresh*                                         # at refresh_every
        finish | abort                                   # exactly one, at exit

    ``finish(state)`` is the success path: an engine running live machinery
    (worker threads or processes, a trace capture) drains outstanding work
    and returns the fully applied state.  ``abort()`` is the failure path
    (any exception escaping the loop): tear down WITHOUT draining, leaving
    crash evidence (a ``.part`` trace) salvageable.  ``liveness()`` reports
    the live machinery's health (``{}`` where nothing lives).
    """

    pipeline: Any

    def build(self) -> Any: ...

    def build_template(self) -> Any: ...

    def checkpoint_layout(self) -> Any: ...

    def tick(self, state: Any, batch: Any) -> tuple[Any, dict]: ...

    def refresh(self, state: Any) -> Any: ...

    def require_refreshable(self, state: Any) -> None: ...

    def finish(self, state: Any) -> Any: ...

    def abort(self) -> None: ...

    def liveness(self) -> dict: ...


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
        run's device.  The resume path restores into it.  Under a running
        sharded mesh it is the rank's state."""
        from repro_torch.tree import tree_map

        spec = self.spec
        if spec.params is None:
            params = self._meta_params()
        else:
            params = tree_map(lambda t: torch.empty_like(t, device="meta"), spec.params)
        return self._build(params, self._meta_adapt())

    def _meta_params(self):
        from repro_torch.models import model as M

        return M.init_model(None, self.spec.cfg, "meta")

    def _meta_adapt(self):
        return None if self.spec.adapt is None else self.spec.adapt.to("meta")

    def checkpoint_layout(self):
        """None for one process.  Under a running sharded mesh, where this
        rank's state sits in the one-process state of the run
        (:func:`repro_torch.run.ckpt.tensor_parallel_layout`, given the
        leaves this engine built over the rank's param blocks,
        :func:`repro_torch.training.steps.over_params`), so that a
        checkpoint saves and restores it in the one-process layout."""
        from repro_torch.sharding.collectives import sharded_mesh
        from repro_torch.sharding.ctx import rules_in_force

        mesh = sharded_mesh()
        if mesh is None:
            return None
        from repro_torch.run.ckpt import tensor_parallel_layout
        from repro_torch.training.steps import over_params

        with rules_in_force(None):
            whole = self._build(self._meta_params(), self._meta_adapt())
        return tensor_parallel_layout(self.spec.cfg, mesh, whole,
                                      over_params(self.build_template()))

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

    def checkpoint_layout(self):
        """None for one process; over a multi-process workers mesh, where
        this rank's rings and histogram rows sit in the one-process state
        (:func:`repro_torch.run.ckpt.workers_layout`), whose template is
        this engine's state built for a mesh of one process."""
        if self.mesh.world_size == 1:
            return None
        from repro_torch.launch.mesh import WorkersMesh
        from repro_torch.run.ckpt import workers_layout
        from repro_torch.training.steps import init_sharded_async_state

        spec = self.spec
        one = WorkersMesh(group=None, rank=0, world_size=1, device=self.mesh.device)
        whole = init_sharded_async_state(
            spec.cfg, spec.pipeline, ring=spec.ring, adapt=self._meta_adapt(), seed=spec.seed,
            device=spec.device, params=self.build_template().params, mesh=one, fuse=spec.fuse,
            ring_dtype=spec.ring_dtype)
        return workers_layout(self.mesh, spec.adapt.num_workers, whole)


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

    def checkpoint_layout(self):
        """None: a hand-built state is checkpointed as one process holds it;
        under a running sharded mesh its layout is not known, so it raises."""
        from repro_torch.sharding.collectives import sharded_mesh

        if sharded_mesh() is not None:
            raise NotImplementedError(
                "a hand-built state under a running sharded mesh: its layout is not known, so "
                "it cannot be checkpointed; build the run from a RunSpec")
        return None


_ENGINES = {"sync": SyncEngine, "async": AsyncEngine, "sharded_async": ShardedAsyncEngine}


def make_engine(spec: RunSpec) -> Engine:
    """The engine for ``spec.mode``; the live parameter server's engine is
    imported only for ``mode="distributed"``."""
    if spec.mode == "distributed":
        from repro_torch.distributed.engine import DistributedAsyncEngine

        return DistributedAsyncEngine(spec)
    return _ENGINES[spec.mode](spec)
