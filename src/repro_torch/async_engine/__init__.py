from repro_torch.async_engine.events import EventSimConfig, simulate_staleness_trace
from repro_torch.async_engine.exact import AsyncTrace, simulate_async_sgd, uniform_commit_order
from repro_torch.async_engine.delayed import (
    DelayedGradients,
    delayed_combine,
    flat_size,
    init_delayed,
    init_flat_delayed,
    ring_dtype_for,
    staleness_cdf,
)

__all__ = [
    "EventSimConfig",
    "simulate_staleness_trace",
    "AsyncTrace",
    "simulate_async_sgd",
    "uniform_commit_order",
    "DelayedGradients",
    "delayed_combine",
    "flat_size",
    "init_delayed",
    "init_flat_delayed",
    "ring_dtype_for",
    "staleness_cdf",
]
