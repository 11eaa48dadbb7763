"""DistributedAsyncEngine: live AsyncPSGD behind the Engine protocol (port
of ``src/repro/distributed/engine.py``).

The orchestrator sees a normal engine — ``build -> tick* -> refresh* ->
finish | abort`` — but a tick does no compute itself: it submits the batch
to a :class:`~repro_torch.distributed.server.ParameterServer` that owns the
state, and ``spec.num_workers`` live workers (launched BY the transport:
threads for ``inproc``, spawned processes for ``socket``) pull params,
compute gradients on ``spec.device`` and push them back with real, measured
staleness.

The tick keeps up to ``num_workers - 1`` batches in flight: tick ``t``
submits batch ``t`` and waits until at least ``t - (W-1)`` batches have been
completed, so every tick observes at least one fresh applied update.  The
pacing counts completed batches, not versions (a retried or late push
applies without completing a batch; see the server's docstring), and with
``spec.worker_timeout`` set the server reclaims a dead worker's in-flight
batch, so the awaited count always arrives (or the tick raises a diagnostic
timeout naming the dead workers).  ``spec.faults`` threads a
:class:`~repro_torch.distributed.faults.FaultPlan` through the server and
every worker; ``spec.retry`` tunes the workers' rpc timeout and backoff.

The cluster starts lazily on the FIRST tick, from that tick's incoming
state — which is how ``resume_from`` flows in: the orchestrator restores the
checkpoint into the engine's template, the server picks up from the
restored version and the trace reopens in resume mode, extending the prior
records.  ``finish`` drains every submitted batch, stops the workers,
finalizes the trace and returns the server's final state; ``abort`` (the
orchestrator's failure path) stops without draining and leaves a
salvageable ``.part`` trace.  ``liveness`` surfaces the server's per-worker
health (after the cluster stops, its last report).  A state a tick returns
is never written again (the server's copy-before-write rule), so hooks and
checkpoints see the state of their step.
"""

from __future__ import annotations

from typing import Any

from repro_torch.run.engine import _EngineBase
from repro_torch.run.spec import RunSpec

__all__ = ["DistributedAsyncEngine"]


class DistributedAsyncEngine(_EngineBase):
    """Live parameter-server engine; see module docstring."""

    mode = "distributed"
    tick_timeout_s = 120.0

    def __init__(self, spec: RunSpec):
        super().__init__(spec)
        assert spec.num_workers >= 1, "distributed mode needs num_workers >= 1"
        self._server = None
        self._transport = None
        self._workers: list = []
        self._trace_writer = None
        self._submitted = 0
        self._last_liveness: dict = {}

    # -- cluster lifecycle ---------------------------------------------------

    def _start(self, state) -> None:
        from repro_torch.distributed.server import ParameterServer
        from repro_torch.distributed.transport import make_transport

        spec = self.spec
        # reprolint: disable=RL001 — one sync per run at engine start, not per tick
        base_version = int(state.step)
        if spec.trace_path:
            from repro_torch.async_engine.events import TraceWriter

            self._trace_writer = TraceWriter(spec.trace_path, resume=base_version > 0)
        transport = make_transport(spec.transport, **(spec.transport_opts or {}))
        server = ParameterServer(
            state,
            self.pipeline,
            transport,
            fuse=spec.fuse,
            trace=self._trace_writer,
            faults=spec.faults,
            worker_timeout=spec.worker_timeout,
            num_workers=spec.num_workers,
        )
        server.start()
        workers = [
            transport.start_worker(w, spec.cfg, faults=spec.faults, retry=spec.retry,
                                   device=spec.device)
            for w in range(spec.num_workers)
        ]
        self._server, self._transport, self._workers = server, transport, workers
        self._submitted = 0

    def _stop_cluster(self, *, finalize: bool) -> None:
        self._server.request_stop()
        for w in self._workers:
            w.join(timeout=30)
        self._server.shutdown()
        self._last_liveness = self._server.liveness()
        self._transport.close()
        if self._trace_writer is not None:
            if finalize:
                self._trace_writer.finalize()
            else:
                self._trace_writer.abort()
        self._server = None
        self._transport = None
        self._workers = []
        self._trace_writer = None

    # -- Engine protocol -----------------------------------------------------

    def tick(self, state, batch) -> tuple[Any, dict]:
        if self._server is None:
            self._start(state)
        self._server.submit_batch(batch)
        self._submitted += 1
        lag = self.spec.num_workers - 1  # batches allowed in flight
        self._server.await_batches(max(1, self._submitted - lag), timeout=self.tick_timeout_s)
        return self._server.snapshot()

    def refresh(self, state):
        if self._server is None:
            return super().refresh(state)
        return self._server.call(super().refresh)

    def finish(self, state):
        """Drain every submitted batch, stop workers, finalize the trace; the
        server's final state is returned (nothing writes it any more)."""
        if self._server is None:
            return state
        self._server.await_batches(self._submitted, timeout=self.tick_timeout_s)
        state, _ = self._server.snapshot()
        self._stop_cluster(finalize=True)
        return state

    def abort(self) -> None:
        """Failure-path teardown: no drain, trace left as a ``.part``."""
        if self._server is None:
            return
        self._stop_cluster(finalize=False)

    def liveness(self) -> dict:
        """The server's per-worker health snapshot ({} before the first tick;
        after the cluster stopped, its last one)."""
        if self._server is None:
            return dict(self._last_liveness)
        return self._server.liveness()
