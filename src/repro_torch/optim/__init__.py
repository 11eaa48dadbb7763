"""The server update: composable transform links and the fusion compiler."""

from repro_torch.optim import transform
from repro_torch.optim.fuse import flat_chain_step, flat_tick_step, fuse_pipeline, plan_fusion

__all__ = ["transform", "flat_chain_step", "flat_tick_step", "fuse_pipeline", "plan_fusion"]
