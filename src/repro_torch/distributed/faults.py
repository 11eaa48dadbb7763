"""Declarative fault plans for the live parameter server (port of
``src/repro/distributed/faults.py``, pure Python: the same kinds, the same
``after`` / ``count`` semantics and the same parse errors).

A crashed or delayed contributor is, to asynchronous SGD, a very stale or a
dropped gradient, so the system layer injects those faults on purpose and
checks that the run still completes.  A :class:`FaultPlan` is an immutable,
picklable schedule of :class:`FaultSpec` entries (picklable because spawned
socket workers receive their copy as ``multiprocessing`` arguments); the
live components ask a stateful :class:`FaultInjector` view at fixed points.

Worker side (:func:`repro_torch.distributed.worker.worker_loop`):

* ``crash_before_push`` — the worker dies after computing its gradient but
  before pushing it (its batch stays in flight until the server's liveness
  sweep reclaims the slot);
* ``crash_after_push``  — the worker dies right after its push is acked
  (nothing is stranded: the pool just shrinks);
* ``delay_push``        — the worker sleeps ``seconds`` before pushing.

Server side (:class:`repro_torch.distributed.server.ParameterServer`):

* ``drop_reply``  — the push is applied but its ack is dropped, so the
  worker times out and retries: the retried gradient applies twice;
* ``slow_apply``  — the server sleeps ``seconds`` before an apply.

``worker`` selects the worker a worker-side fault arms on (``None``: all
workers; server-side faults ignore it except ``drop_reply``, which matches
the pushing worker).  ``after`` counts that scope's matching events before
the fault first fires, and ``count`` bounds how many times it fires
(``None``: every time after ``after``).  Every firing is decided by counts,
never by a clock.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "FAULT_KINDS",
    "WORKER_FAULTS",
    "SERVER_FAULTS",
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "RetryPolicy",
    "parse_faults",
]

WORKER_FAULTS = ("crash_before_push", "crash_after_push", "delay_push")
SERVER_FAULTS = ("drop_reply", "slow_apply")
FAULT_KINDS = WORKER_FAULTS + SERVER_FAULTS


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault; see the module docstring for kind semantics."""

    kind: str
    worker: int | None = None  # None: any worker (server faults: the pusher)
    after: int = 0  # matching events to let pass before firing
    count: int | None = 1  # firings allowed (None: unbounded)
    seconds: float = 0.0  # delay_push / slow_apply magnitude

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable schedule of faults; hand out injector views per scope."""

    faults: tuple[FaultSpec, ...] = ()

    def for_worker(self, worker_id: int) -> "FaultInjector":
        mine = []
        for f in self.faults:
            if f.kind in WORKER_FAULTS and f.worker in (None, worker_id):
                mine.append(f)
        return FaultInjector(tuple(mine))

    def for_server(self) -> "FaultInjector":
        return FaultInjector(tuple(f for f in self.faults if f.kind in SERVER_FAULTS))


class FaultInjector:
    """Stateful view of a plan for ONE scope (a worker, or the server).

    ``fire(kind, worker=...)`` counts one matching event and returns the
    :class:`FaultSpec` that should trigger on it (or None).  Counters are
    per-spec and local to this injector — each worker process/thread holds
    its own, so spawned socket workers need no shared state.
    """

    def __init__(self, faults: tuple[FaultSpec, ...]):
        self._faults = faults
        self._seen = [0] * len(faults)
        self._fired = [0] * len(faults)

    def fire(self, kind: str, worker: int | None = None) -> FaultSpec | None:
        hit = None
        for i, f in enumerate(self._faults):
            if f.kind != kind:
                continue
            if f.worker is not None and worker is not None and f.worker != worker:
                continue
            seen = self._seen[i]
            self._seen[i] = seen + 1
            if seen < f.after:
                continue
            if f.count is not None and self._fired[i] >= f.count:
                continue
            self._fired[i] += 1
            if hit is None:
                hit = f
        return hit


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Worker-side transport resilience: per-rpc timeout + capped
    exponential backoff.  A worker retries an rpc that raised a *transient*
    error (timeout / connection reset) up to ``max_retries`` times, sleeping
    ``backoff_base * 2**attempt`` (capped at ``backoff_max``) between tries;
    an ``EOFError`` — the server is gone — is never retried, the worker
    exits cleanly instead.  Push retries give the wire at-least-once
    semantics: a push whose ack was lost may apply twice, which async-SGD
    absorbs as one more stale gradient."""

    rpc_timeout: float = 60.0
    max_retries: int = 4
    backoff_base: float = 0.05
    backoff_max: float = 2.0


def parse_faults(text: str) -> FaultPlan:
    """Parse the ``--faults`` CLI syntax into a :class:`FaultPlan`.

    Comma-separated faults, each ``kind[:field=value]*`` with fields
    ``worker`` / ``after`` / ``count`` (ints; ``count=inf`` for unbounded)
    and ``seconds`` (float), e.g.::

        crash_before_push:worker=1:after=2
        delay_push:worker=0:seconds=0.2:count=3,slow_apply:after=5:seconds=0.1
    """
    faults = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        kind, _, rest = part.partition(":")
        kwargs: dict = {}
        for field in filter(None, rest.split(":")):
            key, sep, value = field.partition("=")
            if not sep:
                raise ValueError(f"fault field {field!r} in {part!r} is not key=value")
            if key in ("worker", "after"):
                kwargs[key] = int(value)
            elif key == "count":
                kwargs[key] = None if value == "inf" else int(value)
            elif key == "seconds":
                kwargs[key] = float(value)
            else:
                raise ValueError(
                    f"unknown fault field {key!r} in {part!r} "
                    "(worker/after/count/seconds)"
                )
        faults.append(FaultSpec(kind, **kwargs))
    if not faults:
        raise ValueError("empty fault plan (expected kind[:field=value]*, ...)")
    return FaultPlan(tuple(faults))
