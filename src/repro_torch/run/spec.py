"""RunSpec: the declarative description of one training run (port of
``src/repro/run/spec.py``, modes ``sync``, ``async``, ``sharded_async`` and
``distributed``).

One dataclass captures everything the orchestrator needs to *reconstruct* a
run from nothing, which is what makes resume possible: ``run(spec,
resume_from=dir)`` rebuilds the same engine, restores the checkpointed state
into it and continues bit-identically to the uninterrupted run.

Data source (resolved in this order):

* ``batch_fn`` — ``step_index -> batch``; the preferred, *directly resumable*
  form (a resumed run starts calling it at the restored step).
* ``batches``  — any iterable; on resume the orchestrator fast-forwards
  ``start_step`` items (exact for the deterministic generators in
  :mod:`repro_torch.data`).
* neither      — the default LM stream
  ``lm_batches(cfg.vocab_size, batch_size, seq_len, seed=seed)`` on ``device``.

``device`` defaults to the card; tests pass ``device="cpu"``.
``tau_source`` (async modes) hands the step its workers' uniforms instead of
the state's generator, so a run can replay another's draws.  ``mesh``
(``sharded_async``) is the :class:`~repro_torch.launch.mesh.WorkersMesh`
(default: one process on ``device``); ``adapt`` is then a
``WorkerAdaptState``.  ``mode="distributed"`` runs the LIVE parameter server
(:mod:`repro_torch.distributed`): ``num_workers`` real workers over
``transport`` (``transport_opts`` go to ``make_transport``), measured
staleness streamed to ``trace_path``; ``faults`` (a FaultPlan, or a
``--faults`` style string) injects faults, ``worker_timeout`` arms the
server's liveness sweep and ``retry`` tunes the workers' rpc timeout and
backoff.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator

MODES = ("sync", "async", "sharded_async", "distributed")
# The live registry is repro_torch.distributed.transport.transport_kinds();
# this mirror only validates specs of the simulated modes without importing it.
TRANSPORTS = ("inproc", "socket")

__all__ = ["RunSpec", "MODES", "TRANSPORTS"]


@dataclasses.dataclass
class RunSpec:
    cfg: Any = None
    pipeline: Any = None
    mode: str = "sync"
    num_steps: int = 100

    # -- data source ---------------------------------------------------------
    batch_fn: Callable[[int], Any] | None = None
    batches: Iterable[Any] | None = None
    batch_size: int = 8
    seq_len: int = 128

    # -- engine knobs --------------------------------------------------------
    num_workers: int = 1
    ring: int = 0
    ring_dtype: Any = None  # torch dtype or name; None: f32 for all-f32 params
    adapt: Any = None
    mesh: Any = None
    fuse: bool = False
    alpha_c: float | None = None
    params: Any = None  # tree or packed (N,) buffer (default: init from seed)
    device: str = "cuda"
    tau_source: Callable[[], Any] | None = None

    # -- live parameter server (mode="distributed") --------------------------
    transport: str = "inproc"  # worker fabric: threads | TCP + spawned processes
    transport_opts: dict | None = None  # make_transport(**opts) extras
    trace_path: str | None = None  # stream measured staleness to this file
    faults: Any = None  # FaultPlan (or a parse_faults string)
    worker_timeout: float | None = None  # liveness: silence after taking work
    retry: Any = None  # RetryPolicy for the workers' rpc timeout/backoff

    # -- refresh policy (online adaptation boundary) -------------------------
    refresh_every: int = 0

    seed: int = 0

    def __post_init__(self):
        assert self.mode in MODES, f"mode must be one of {MODES}, got {self.mode!r}"
        if self.mode == "distributed":
            # the live registry, and a --faults string normalized to a FaultPlan
            from repro_torch.distributed.faults import parse_faults
            from repro_torch.distributed.transport import transport_kinds

            kinds = transport_kinds()
            assert self.transport in kinds, (
                f"transport must be one of {kinds}, got {self.transport!r}")
            if isinstance(self.faults, str):
                self.faults = parse_faults(self.faults)
        else:
            assert self.transport in TRANSPORTS, (
                f"transport must be one of {TRANSPORTS}, got {self.transport!r}")
        assert self.num_steps >= 0, f"num_steps must be >= 0, got {self.num_steps}"

    def batch_stream(self, start_step: int = 0) -> Iterator[Any]:
        """Batches for steps ``start_step, start_step + 1, ...`` (resolved per
        the module docstring; iterables are fast-forwarded on resume)."""
        if self.batch_fn is not None:

            def gen():
                t = start_step
                while True:
                    yield self.batch_fn(t)
                    t += 1

            return gen()
        if self.batches is not None:
            it = iter(self.batches)
        else:
            from repro_torch.data import lm_batches

            assert self.cfg is not None, (
                "RunSpec has no data source: set batch_fn/batches, or cfg for "
                "the default lm_batches stream"
            )
            it = lm_batches(self.cfg.vocab_size, self.batch_size, self.seq_len,
                            seed=self.seed, device=self.device)
        for _ in range(start_step):
            next(it)  # deterministic generators make the fast-forward exact
        return it
