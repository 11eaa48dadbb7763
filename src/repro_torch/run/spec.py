"""RunSpec: the declarative description of one training run (port of
``src/repro/run/spec.py``, modes ``sync``, ``async`` and ``sharded_async``).

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
``WorkerAdaptState``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator

MODES = ("sync", "async", "sharded_async")

__all__ = ["RunSpec", "MODES"]


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

    # -- refresh policy (online adaptation boundary) -------------------------
    refresh_every: int = 0

    seed: int = 0

    def __post_init__(self):
        assert self.mode in MODES, f"mode must be one of {MODES}, got {self.mode!r}"
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
