"""The live parameter server: serial applies, measured staleness, liveness
(port of ``src/repro/distributed/server.py``).

One loop thread owns the training state and consumes ONE message stream from
the transport (worker pulls and pushes interleaved with the engine's control
messages), so every apply is serial and the staleness stamp is exact:

    tau = applies committed between this worker's pull and its push

Each gradient runs the pipeline the simulated engines run — lowered to the
fused chain when ``fuse=True`` (one ``fused_chain`` launch per push, through
:func:`repro_torch.optim.fuse.flat_chain_step`), link by link otherwise —
with the *measured* tau as ``StepContext.tau``, so ``scale_by_staleness``
weights the update by ``alpha(tau) / alpha_c`` (the paper's Alg. 1) and
``record_taus`` feeds the histogram the refresh drains.  Measurements stream
to a :class:`~repro_torch.async_engine.events.TraceWriter` as v2 records
``(tau, worker, t_pull, t_push)``, both stamps from THIS server's clock.

**Handed-out tensors are never written.**  The fused apply updates the
params and the optimizer state in place, where the reference's arrays are
immutable.  A pull hands a worker the server's own params (over the
in-process fabric; the socket fabric serializes a host copy at once) and
``snapshot`` / ``call`` hand the orchestrator the server's own state; each
marks what it handed out, and the next apply first moves the server onto
fresh copies of the marked tensors — taken under the lock, on the device's
stream, before the apply's kernel.  So a worker computes on exactly the
version stamped on its pull, and a state returned by a tick never changes
under a hook (a checkpoint saves the state of its step).  The adaptation
tables are the exception: a refresh rewrites them in place, as every
engine's refresh does, and the orchestrator is the one that calls it.

Fault tolerance (the reference's): every pull and push is a heartbeat.  With
a ``worker_timeout`` the loop sweeps liveness and RECLAIMS the in-flight
batch of a worker that went silent after taking work; a declared-dead
worker that was merely slow is resurrected by its next message, and its
late push still applies.  A :class:`~repro_torch.distributed.faults
.FaultPlan` injects server-side faults (dropped acks, slow applies).

Batches are counted apart from versions: a push that completes its worker's
in-flight batch completes that batch, while a retried push after a dropped
ack, or the late push of a reclaimed worker, is applied (one more stale
gradient) but completes none.  The engine paces and drains by completed
batches (:meth:`await_batches`), so ``finish`` returns once every submitted
batch has been applied, whatever duplicates the faults added.

The engine talks to the loop through thread-safe calls: ``submit_batch``,
``await_batches`` / ``await_applied`` / ``snapshot`` (the tick boundary),
``call`` (refresh, run *between* applies), ``liveness`` and
``request_stop`` / ``shutdown`` (idempotent).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.optim import transform as T
from repro_torch.tree import tree_leaves

__all__ = ["ParameterServer"]

f32 = torch.float32


def _clone(tree: Any) -> Any:
    """Fresh copies of every tensor in a state tree (dicts, tuples, None)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _to_numpy(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _index_on(value: int, device: torch.device) -> torch.Tensor:
    """A ``(1,)`` int32 tensor on ``device`` holding ``value``; to the card
    through pinned memory with a non-blocking copy (no wait on the device)."""
    t = torch.tensor([value], dtype=torch.int32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ParameterServer:
    """Serial apply loop over a transport's message stream (module docstring).

    ``state`` is a :class:`~repro_torch.training.steps.TrainState` without a
    delayed ring (delay is real here) whose params are float32: the wire
    format is the packed flat ``(N,)`` f32 buffer.  ``worker_timeout``
    (seconds of silence after taking work) arms the liveness sweep;
    ``faults`` injects server-side faults; ``num_workers`` sizes the
    ``live_frac`` metric (None: it stays 1.0).  The port runs eagerly, so
    there is no retrace hook.
    """

    def __init__(
        self,
        state: Any,
        pipeline: Any,
        transport: Any,
        *,
        fuse: bool = False,
        trace: Any = None,
        poll_s: float = 0.05,
        faults: Any = None,
        worker_timeout: float | None = None,
        num_workers: int | None = None,
    ):
        from repro_torch.training.steps import _fused_form

        self._transport = transport
        self._trace = trace
        self._poll_s = float(poll_s)
        fused = _fused_form(pipeline) if fuse else None
        self._transform = fused if fused is not None else pipeline
        self._flat_native = isinstance(state.params, torch.Tensor) and state.params.dim() == 1
        self._flat_grads = fused is not None or self._flat_native
        assert all(leaf.dtype == f32 for leaf in tree_leaves(state.params)), (
            "the distributed engine needs float32 params (flat f32 wire format)")
        self._device = tree_leaves(state.params)[0].device
        self._wire = getattr(transport, "wire", "tensor")
        self._cond = threading.Condition()
        self._state = state
        self._params_out = False  # params handed to a worker since the last apply
        self._state_out = False  # the whole state handed to the orchestrator
        self._version = int(state.step)  # reprolint: disable=RL001 — once, at server start
        self._base_version = self._version
        self._completed = 0  # batches completed (see the module docstring)
        self._tau_sum = 0.0
        self._metrics: dict = {
            "loss": torch.tensor(float("nan")),
            "tau": torch.tensor(0.0),
            "tau_mean": torch.tensor(0.0),
            "alpha": torch.tensor(1.0),
            "live_frac": torch.tensor(1.0),
        }
        self._error: BaseException | None = None
        self._batches: deque = deque()
        self._parked: deque = deque()  # (worker_id, reply_fn) awaiting a batch
        self._stopping = False
        self._thread: threading.Thread | None = None
        self._shutdown_done = False
        # -- liveness bookkeeping (loop-thread writes, lock-guarded reads) ---
        self._num_workers = num_workers
        self._worker_timeout = worker_timeout
        self._faults = faults.for_server() if faults is not None else None
        self._last_seen: dict[int, float] = {}
        self._inflight: dict[int, Any] = {}  # wid -> dispatched batch
        self._dead: set[int] = set()
        self._reclaimed = 0

    # -- engine-facing API (thread-safe) ------------------------------------

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    @property
    def completed(self) -> int:
        """Batches completed since this server started."""
        with self._cond:
            return self._completed

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="param-server")
        self._thread.start()

    def submit_batch(self, batch: Any) -> None:
        """Queue one batch; the bounded transport queue is the backpressure."""
        self._transport.send(("batch", batch))

    def _await(self, ready: Callable[[], bool], what: str, timeout: float) -> None:
        with self._cond:
            ok = self._cond.wait_for(lambda: ready() or self._error is not None,
                                     timeout=timeout)
        if self._error is not None:
            raise RuntimeError("parameter server loop failed") from self._error
        if not ok:
            live = self.liveness()
            raise TimeoutError(
                f"parameter server: {what} not reached within {timeout}s "
                f"(at version {self.version}, {self.completed} batches completed; "
                f"dead workers: {live['dead'] or 'none'}, "
                f"in flight: {live['in_flight'] or 'none'} — "
                "starved batch queue, or every worker is gone?)"
            )

    def await_applied(self, target_version: int, timeout: float = 120.0) -> None:
        """Block until the state reaches ``target_version`` (or raise)."""
        self._await(lambda: self._version >= target_version,
                    f"version {target_version}", timeout)

    def await_batches(self, count: int, timeout: float = 120.0) -> None:
        """Block until ``count`` batches have been completed (or raise)."""
        self._await(lambda: self._completed >= count, f"{count} completed batches", timeout)

    def snapshot(self) -> tuple[Any, dict]:
        """Latest state + latest applied-update metrics (a consistent pair).
        The state is the server's own; the server writes none of its tensors
        again (the next apply moves onto copies)."""
        with self._cond:
            self._state_out = True
            return self._state, dict(self._metrics)

    def liveness(self) -> dict:
        """Per-worker health: last-seen stamps, declared-dead set, in-flight
        slots, batches reclaimed from dead workers so far."""
        with self._cond:
            return {
                "num_workers": self._num_workers,
                "last_seen": dict(self._last_seen),
                "dead": sorted(self._dead),
                "in_flight": sorted(self._inflight),
                "reclaimed": self._reclaimed,
                "live_frac": self._live_frac(),
            }

    def call(self, fn: Callable[[Any], Any], timeout: float = 120.0) -> Any:
        """Run ``fn(state) -> state`` inside the loop, between applies; returns
        the resulting state (handed out, like a snapshot)."""
        box: list = []
        done = threading.Event()
        self._transport.send(("call", fn, box, done))
        if not done.wait(timeout=timeout):
            raise TimeoutError("parameter server: refresh call timed out")
        if not box:
            raise RuntimeError("parameter server loop failed") from self._error
        return box[0]

    def request_stop(self) -> None:
        """Tell workers to exit at their next pull/push; applies cease."""
        self._transport.send(("stop",))

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the loop thread (after ``request_stop`` + worker joins).
        Idempotent: a second call is a no-op instead of a second send into a
        possibly-closed fabric."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self._transport.send(("shutdown",))
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- loop internals ------------------------------------------------------

    def _live_frac(self) -> float:
        if not self._num_workers:
            return 1.0
        return max(self._num_workers - len(self._dead), 0) / self._num_workers

    def _pull_params(self) -> Any:
        """The params to hand a worker: the server's own flat buffer (marked,
        so the next apply writes a copy) over the tensor wire; a host copy
        over the numpy wire."""
        with self._cond:
            if self._flat_native:
                p = self._state.params
                if self._wire == "tensor":
                    self._params_out = True
            else:
                p = T.pack_flat(self._state.params)  # already a fresh buffer
            return _to_numpy(p) if self._wire == "numpy" else p

    def _own_state(self) -> Any:
        """The state the next apply may write: fresh copies of whatever was
        handed out since the last apply (module docstring)."""
        with self._cond:
            state = self._state
            if self._state_out:
                adapt = state.adapt
                if adapt is not None:
                    adapt = dataclasses.replace(adapt, hist=adapt.hist.clone())
                state = dataclasses.replace(state, params=_clone(state.params),
                                            opt_state=_clone(state.opt_state), adapt=adapt)
            elif self._params_out:
                state = dataclasses.replace(state, params=_clone(state.params))
            self._state_out = self._params_out = False
            self._state = state
            return state

    def _apply(self, g_flat: Any, tau: int) -> torch.Tensor:
        """Apply one pushed gradient at measured staleness ``tau``; returns
        ``alpha(tau)``.  Runs under the lock: readers never see a half-applied
        state, and on the card every enqueue is ordered on one stream."""
        from repro_torch.training.adapt import alpha_lookup, record_taus

        with self._cond:
            state = self._own_state()
            taus = _index_on(tau, self._device)
            adapt = state.adapt
            alpha = torch.ones((), dtype=f32, device=self._device)
            if adapt is not None:
                record_taus(adapt, taus)
                alpha = alpha_lookup(adapt, taus)[0]
            ctx = T.StepContext(tau=taus[0], adapt=adapt, staleness_applied=False)
            g = torch.as_tensor(g_flat).to(self._device, f32)
            grads = g if self._flat_grads else T.unpack_flat(g, state.params)
            with torch.no_grad():
                new_params, new_opt = T.run_pipeline(self._transform, grads, state.opt_state,
                                                     state.params, ctx)
            self._state = dataclasses.replace(state, params=new_params, opt_state=new_opt,
                                              step=state.step + 1)
            return alpha

    def _heartbeat(self, wid: int) -> None:
        # _last_seen is read under the lock by liveness(); stamp it under the
        # same lock (Condition wraps an RLock, so lock-holding callers nest).
        with self._cond:
            self._last_seen[wid] = time.time()
            if wid in self._dead:  # merely slow, not dead: resurrect
                self._dead.discard(wid)
                self._metrics["live_frac"] = torch.tensor(self._live_frac())

    def _check_liveness(self) -> None:
        """Reclaim in-flight slots of silent workers (module docstring)."""
        if self._worker_timeout is None or self._stopping:
            return
        now = time.time()
        for wid in list(self._inflight):
            seen = self._last_seen.get(wid, now)
            if now - seen <= self._worker_timeout:
                continue
            with self._cond:
                batch = self._inflight.pop(wid)
                self._dead.add(wid)
                self._reclaimed += 1
                self._metrics["live_frac"] = torch.tensor(self._live_frac())
            self._batches.appendleft(batch)  # a live worker takes it over
        self._dispatch()

    def _dispatch(self) -> None:
        while self._batches and self._parked and not self._stopping:
            wid, reply = self._parked.popleft()
            batch = self._batches.popleft()
            if self._wire == "numpy":
                batch = _to_numpy(batch)
            t_pull = time.time()
            with self._cond:  # liveness() snapshots _inflight under the lock
                # taking work starts the silence clock: a worker parked longer
                # than the timeout must not be declared dead the moment it
                # gets a batch (its batch would then be applied twice)
                self._last_seen[wid] = t_pull
                self._inflight[wid] = batch
                version = self._version
                p = self._pull_params()
            reply(("work", version, t_pull, p, batch))

    def _park(self, wid: int, reply) -> None:
        # A re-pull (the worker timed out and retried) supersedes any parked
        # entry for the same worker: the old rpc was abandoned.
        stale = [p for p in self._parked if p[0] == wid]
        for p in stale:
            self._parked.remove(p)
        self._parked.append((wid, reply))
        self._dispatch()

    def _handle_push(self, msg, reply) -> None:
        _, wid, pull_version, t_pull, g_flat, loss = msg
        if self._stopping:
            if reply is not None:
                reply(("stop",))
            return
        self._heartbeat(wid)
        if self._faults is not None:
            slow = self._faults.fire("slow_apply", wid)
            if slow is not None:
                time.sleep(slow.seconds)
        with self._cond:
            completes = self._inflight.pop(wid, None) is not None
            tau = self._version - int(pull_version)
            alpha = self._apply(g_flat, tau)
            t_push = time.time()
            self._version += 1
            self._completed += int(completes)
            self._tau_sum += tau
            applied = self._version - self._base_version
            self._metrics = {
                "loss": torch.tensor(float(loss)),
                "tau": torch.tensor(float(tau)),
                "tau_mean": torch.tensor(self._tau_sum / max(applied, 1)),
                "alpha": alpha,
                "live_frac": torch.tensor(self._live_frac()),
            }
            self._cond.notify_all()
        if self._trace is not None:
            self._trace.append(tau, wid, t_pull=t_pull, t_push=t_push)
        if self._faults is not None and self._faults.fire("drop_reply", wid) is not None:
            return  # ack lost: the worker times out and re-pushes (dup apply)
        if reply is not None:
            reply(("ack", tau))

    def _handle(self, item) -> bool:
        """Handle one received message; False when the loop should end.  The
        message (which may hold a multi-GB gradient) dies with this frame."""
        msg, reply = item
        kind = msg[0]
        if kind == "batch":
            self._batches.append(msg[1])
            self._dispatch()
        elif kind == "pull":
            if self._stopping:
                reply(("stop",))
            else:
                self._heartbeat(msg[1])
                self._park(msg[1], reply)
        elif kind == "push":
            self._handle_push(msg, reply)
        elif kind == "call":
            _, fn, box, done = msg
            try:
                with self._cond:
                    self._state = fn(self._state)
                    self._state_out = True
                    box.append(self._state)
            finally:
                done.set()
        elif kind == "stop":
            self._stopping = True
            while self._parked:
                _, reply_fn = self._parked.popleft()
                reply_fn(("stop",))
        elif kind == "shutdown":
            return False
        else:
            raise ValueError(f"parameter server: unknown message {kind!r}")
        return True

    def _run(self) -> None:
        try:
            while True:
                item = self._transport.recv(timeout=self._poll_s)
                self._check_liveness()
                if item is None:
                    if getattr(self._transport, "closed", False):
                        return
                    continue
                if not self._handle(item):
                    return
                item = None
        except BaseException as e:  # surface loop failures at the tick boundary
            with self._cond:
                self._error = e
                self._cond.notify_all()
