"""The server update: composable transform links and the fusion compiler."""

from repro_torch.optim import transform
from repro_torch.optim.base import (
    Optimizer,
    adam,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    momentum,
    pack_flat,
    sgd,
    unpack_flat,
)
from repro_torch.optim.fuse import flat_chain_step, flat_tick_step, fuse_pipeline, plan_fusion
from repro_torch.optim.mindthestep import MindTheStep, mindthestep

__all__ = ["transform", "flat_chain_step", "flat_tick_step", "fuse_pipeline", "plan_fusion",
           # legacy shims (the chainable clip is transform.clip_by_global_norm)
           "Optimizer", "sgd", "momentum", "adam", "apply_updates", "global_norm",
           "clip_by_global_norm", "pack_flat", "unpack_flat", "MindTheStep", "mindthestep"]
