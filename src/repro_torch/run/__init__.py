"""The One Run API: ``run(RunSpec(...), hooks=...)``."""

from repro_torch.run.engine import AsyncEngine, SyncEngine, make_engine
from repro_torch.run.hooks import Hook, LogHook
from repro_torch.run.orchestrator import RunContext, RunResult, run
from repro_torch.run.spec import RunSpec

__all__ = [
    "AsyncEngine",
    "SyncEngine",
    "make_engine",
    "Hook",
    "LogHook",
    "RunContext",
    "RunResult",
    "run",
    "RunSpec",
]
