"""Event-driven scheduler simulator -> realistic staleness traces.

The paper (§IV, "Applicability of geometric tau") decomposes a gradient's
staleness ``tau = tau_C + tau_S``:

* ``tau_C`` — updates applied by others *while* the worker computes its
  gradient (dominated by the compute-time distribution);
* ``tau_S`` — updates applied after the computation finishes but before the
  scheduler lets this worker commit (under a uniform fair scheduler this
  part is geometric).

This module reproduces that mechanism as a discrete-event simulation of
``m`` workers with configurable compute-time distributions and a serial
server apply time.  With ``compute_time >> apply_time`` (the deep-learning
regime) the resulting tau histogram is CMP/Poisson-shaped with mode ~ m-1;
with ``compute_time << apply_time`` it degenerates to the geometric shape —
exactly the paper's Table I / Fig 2 narrative, which `benchmarks/tau_models.py`
quantifies with Bhattacharyya distances.

Host-side numpy only (this generates *traces*; the simulators consume them).
Port of ``src/repro/async_engine/events.py``, the same code: the same seed
gives the same taus and workers in both packages, and the REPROTRC files
below are the same bytes, so a trace written by either package loads in the
other.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
import heapq
import os
import struct

import numpy as np

__all__ = [
    "EventSimConfig",
    "simulate_staleness_trace",
    "TraceError",
    "TraceWriter",
    "load_trace",
]


@dataclasses.dataclass(frozen=True)
class EventSimConfig:
    """Timing model for the event simulation.

    compute: gradient-computation time ~ Gamma(shape, mean/shape) per worker;
             heterogeneity scales each worker's mean by U[1-h, 1+h].
    apply:   server apply time (the paper's "d multiply-adds"), exponential.
    """

    m: int
    compute_mean: float = 1.0
    compute_shape: float = 16.0  # Gamma shape; larger = more deterministic
    apply_mean: float = 0.02
    heterogeneity: float = 0.1
    jitter: float = 0.0  # extra exponential scheduling delay before commit


def simulate_staleness_trace(
    cfg: EventSimConfig,
    num_updates: int,
    seed: int = 0,
    *,
    return_workers: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Run the event simulation and return the staleness of each committed
    update, in commit order (shape ``(num_updates,)``, int64).  With
    ``return_workers`` also return which worker made each commit — feed that
    to :func:`repro_torch.async_engine.exact.simulate_async_sgd` as the commit
    order to couple the exact simulator to realistic timing.

    Mechanism: each worker loops [read x at current commit count] ->
    [compute for ~Gamma time] -> [wait for the scheduler] -> [commit].
    Staleness of a commit = commits applied since that worker's read.
    """
    rng = np.random.default_rng(seed)
    m = cfg.m
    worker_speed = 1.0 + cfg.heterogeneity * (2.0 * rng.random(m) - 1.0)

    def compute_time(w: int) -> float:
        scale = cfg.compute_mean * worker_speed[w] / cfg.compute_shape
        t = rng.gamma(cfg.compute_shape, scale)
        if cfg.jitter > 0:
            t += rng.exponential(cfg.jitter)
        return t

    # Compute-finish event queue holds (finish_time, tiebreak, worker, read_count).
    events: list[tuple[float, int, int, int]] = []
    tiebreak = 0
    for w in range(m):
        heapq.heappush(events, (compute_time(w), tiebreak, w, 0))
        tiebreak += 1

    # Gradients whose computation has finished, awaiting the scheduler.
    ready: list[tuple[int, int]] = []  # (worker, read_count)
    commits = 0
    clock = 0.0
    taus = np.empty(num_updates, dtype=np.int64)
    workers = np.empty(num_updates, dtype=np.int32)

    while commits < num_updates:
        # Pull every computation that has finished by `clock` into the pool.
        while events and events[0][0] <= clock:
            _, _, w, rc = heapq.heappop(events)
            ready.append((w, rc))
        if not ready:
            # Server idles until the next gradient arrives.
            clock = max(clock, events[0][0])
            continue
        # Uniform fair stochastic scheduler (the paper's tau_S model): the
        # server picks a *random* ready gradient, not FIFO.
        w, read_count = ready.pop(rng.integers(len(ready)))
        clock += rng.exponential(cfg.apply_mean)  # the apply itself
        taus[commits] = commits - read_count
        workers[commits] = w
        commits += 1
        # Worker reads the fresh state and starts its next gradient.
        heapq.heappush(events, (clock + compute_time(w), tiebreak, w, commits))
        tiebreak += 1
    return (taus, workers) if return_workers else taus


# ---------------------------------------------------------------------------
# Trace file I/O (the on-disk "events.py format")
# ---------------------------------------------------------------------------
#
# Layout (little-endian):
#
#   header      8s magic  |  I version  |  I record size       (16 bytes)
#   v1 records  i tau     |  i worker                          (8 bytes each)
#   v2 records  i tau     |  i worker   |  d t_pull | d t_push (24 bytes each)
#
# v2 (the current writer format) adds wall-clock stamps per record: the
# server's epoch seconds at snapshot dispatch (``t_pull``) and at gradient
# apply (``t_push``) — both read from the SERVER's clock, so they are
# directly comparable (and monotone per worker) even when workers are
# separate processes.  ``t_push - t_pull`` is the round-trip latency behind
# the version-count tau, which is what tau-vs-latency studies plot.  v1
# files (no stamps) still load; their time arrays come back as None.
#
# A live capture appends to ``path + ".part"`` and flushes every record, so a
# crash loses at most one torn record; ``finalize()`` atomically renames the
# part file onto ``path``.  A finalized file is therefore always complete,
# and a ``.part`` left behind IS the crash marker — ``load_trace`` refuses it
# unless ``allow_partial=True`` (which salvages the whole records and drops a
# torn tail), so a truncated capture can never silently skew a refit.

_TRACE_MAGIC = b"REPROTRC"
_TRACE_VERSION = 2
_TRACE_HEADER = struct.Struct("<8sII")
_TRACE_RECORD_V1 = struct.Struct("<ii")
_TRACE_RECORD = struct.Struct("<iidd")
_RECORD_DTYPE_V1 = np.dtype([("tau", "<i4"), ("worker", "<i4")])
_RECORD_DTYPE = np.dtype(
    [("tau", "<i4"), ("worker", "<i4"), ("t_pull", "<f8"), ("t_push", "<f8")]
)


class TraceError(RuntimeError):
    """A staleness-trace file is missing, partial, or malformed."""


def _read_trace_file(file_path: str, *, allow_partial: bool):
    with open(file_path, "rb") as f:
        raw = f.read()
    if len(raw) < _TRACE_HEADER.size:
        raise TraceError(f"{file_path}: shorter than the trace header")
    magic, version, rec_size = _TRACE_HEADER.unpack_from(raw)
    if magic != _TRACE_MAGIC:
        raise TraceError(f"{file_path}: not a staleness trace (bad magic {magic!r})")
    if version == 1:
        expect, dtype = _TRACE_RECORD_V1.size, _RECORD_DTYPE_V1
    elif version == _TRACE_VERSION:
        expect, dtype = _TRACE_RECORD.size, _RECORD_DTYPE
    else:
        raise TraceError(
            f"{file_path}: trace version {version} unsupported (writer is v{_TRACE_VERSION})"
        )
    if rec_size != expect:
        raise TraceError(f"{file_path}: record size {rec_size} != {expect}")
    body = raw[_TRACE_HEADER.size :]
    torn = len(body) % rec_size
    if torn and not allow_partial:
        raise TraceError(
            f"{file_path}: {torn} trailing bytes are not a whole record "
            "(torn write) — pass allow_partial=True to salvage"
        )
    recs = np.frombuffer(body[: len(body) - torn], dtype=dtype)
    taus = recs["tau"].astype(np.int64)
    workers = recs["worker"].astype(np.int32)
    if version == 1:
        return taus, workers, None, None
    return taus, workers, recs["t_pull"].copy(), recs["t_push"].copy()


def load_trace(
    path: str,
    *,
    allow_partial: bool = False,
    return_workers: bool = False,
    return_times: bool = False,
):
    """Load a finalized staleness trace: taus int64 [, workers int32]
    [, t_pull float64 | None, t_push float64 | None].

    ``return_times`` appends the v2 wall-clock stamps (server epoch seconds
    at snapshot dispatch / at apply); for a v1 trace — stamps were never
    recorded — both time arrays come back as None.  A missing ``path`` with
    a leftover ``path + ".part"`` means the capture crashed before
    :meth:`TraceWriter.finalize`; that partial file is only read under
    ``allow_partial=True`` (torn trailing bytes are dropped).
    """
    part = path + ".part"
    if os.path.exists(path):
        taus, workers, t_pull, t_push = _read_trace_file(path, allow_partial=allow_partial)
    elif os.path.exists(part):
        if not allow_partial:
            raise TraceError(
                f"{path}: capture was never finalized ({part} exists) — "
                "pass allow_partial=True to salvage the partial trace"
            )
        taus, workers, t_pull, t_push = _read_trace_file(part, allow_partial=True)
    else:
        raise TraceError(f"{path}: no trace file (and no partial capture)")
    out: tuple = (taus,)
    if return_workers:
        out += (workers,)
    if return_times:
        out += (t_pull, t_push)
    return out if len(out) > 1 else taus


class TraceWriter:
    """Append-safe live staleness-trace capture (see the format note above).

    Records stream to ``path + ".part"`` with a flush per append;
    ``finalize()`` renames the part file onto ``path`` atomically.  Closing
    without finalizing (a crash, or :meth:`abort`) leaves the ``.part``
    behind as a salvageable partial capture.  ``resume=True`` seeds the new
    part file with the records of an existing finalized trace — or of a
    leftover partial one — so a resumed run extends the capture instead of
    clobbering it.
    """

    def __init__(self, path: str, *, resume: bool = False):
        self.path = str(path)
        self._part = self.path + ".part"
        prior: list[tuple] = []
        if resume:
            try:
                taus, workers, t_pull, t_push = load_trace(
                    self.path, allow_partial=True, return_workers=True, return_times=True
                )
                if t_pull is None:  # extending a v1 capture: re-stamp as 0.0
                    t_pull = t_push = np.zeros(len(taus))
                prior = list(
                    zip(taus.tolist(), workers.tolist(), t_pull.tolist(), t_push.tolist())
                )
            except TraceError:
                pass  # nothing to extend — start fresh
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self._part, "wb")
        self._f.write(_TRACE_HEADER.pack(_TRACE_MAGIC, _TRACE_VERSION, _TRACE_RECORD.size))
        self.count = 0
        for tau, worker, tp, ts in prior:
            self.append(tau, worker, t_pull=tp, t_push=ts)

    def append(
        self, tau: int, worker: int = 0, *, t_pull: float = 0.0, t_push: float = 0.0
    ) -> None:
        self._f.write(_TRACE_RECORD.pack(int(tau), int(worker), float(t_pull), float(t_push)))
        self._f.flush()
        self.count += 1

    def finalize(self) -> str:
        """Flush, fsync, and atomically publish the capture at ``path``."""
        if self._f.closed:
            return self.path
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._part, self.path)
        return self.path

    def abort(self) -> None:
        """Close WITHOUT finalizing: the ``.part`` stays as a partial capture."""
        if not self._f.closed:
            self._f.close()
