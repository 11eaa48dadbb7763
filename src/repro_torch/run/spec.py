"""RunSpec: the declarative description of one training run (port of
``src/repro/run/spec.py``, modes ``sync`` and ``async``).

Data: the ``lm_batches(cfg.vocab_size, batch_size, seq_len, seed=seed)``
stream on ``device`` (the reference's default source).  ``device`` defaults to the card;
tests pass ``device="cpu"``.  ``tau_source`` (async) hands the step its
workers' uniforms instead of the state's generator, so a run can replay
another's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

MODES = ("sync", "async")

__all__ = ["RunSpec", "MODES"]


@dataclasses.dataclass
class RunSpec:
    cfg: Any = None
    pipeline: Any = None
    mode: str = "sync"
    num_steps: int = 100

    # -- data ------------------------------------------------------------------
    batch_size: int = 8
    seq_len: int = 128

    # -- engine knobs --------------------------------------------------------
    num_workers: int = 1
    ring: int = 0
    ring_dtype: Any = None  # torch dtype or name; None: f32 for all-f32 params
    adapt: Any = None
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

    def batch_stream(self) -> Iterator[Any]:
        from repro_torch.data import lm_batches

        assert self.cfg is not None, "RunSpec needs cfg for its lm_batches stream"
        return lm_batches(self.cfg.vocab_size, self.batch_size, self.seq_len,
                          seed=self.seed, device=self.device)
