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
    "DelayedGradients",
    "delayed_combine",
    "flat_size",
    "init_delayed",
    "init_flat_delayed",
    "ring_dtype_for",
    "staleness_cdf",
]
