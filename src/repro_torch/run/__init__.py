"""The One Run API: ``run(RunSpec(...), hooks=...)``.

    spec = RunSpec(cfg=cfg, pipeline=chain(...), mode="async", num_steps=200,
                   num_workers=8, ring=16, adapt=adapt, refresh_every=20)
    result = run(spec, hooks=[LogHook(20), CheckpointHook("ckpt", every=50)])
    # later, after an interruption:
    result = run(spec, hooks=[LogHook(20)], resume_from="ckpt")
"""

from repro_torch.run.ckpt import refresh_link_of, restore_checkpoint, save_checkpoint
from repro_torch.run.engine import (
    AsyncEngine,
    Engine,
    PrebuiltEngine,
    ShardedAsyncEngine,
    SyncEngine,
    make_engine,
)
from repro_torch.run.hooks import BenchHook, CheckpointHook, EvalHook, Hook, LogHook
from repro_torch.run.orchestrator import RunContext, RunResult, run
from repro_torch.run.spec import MODES, RunSpec

__all__ = [
    "RunSpec",
    "MODES",
    "Engine",
    "AsyncEngine",
    "ShardedAsyncEngine",
    "SyncEngine",
    "PrebuiltEngine",
    "make_engine",
    "Hook",
    "LogHook",
    "BenchHook",
    "EvalHook",
    "CheckpointHook",
    "RunContext",
    "RunResult",
    "run",
    "save_checkpoint",
    "restore_checkpoint",
    "refresh_link_of",
]
