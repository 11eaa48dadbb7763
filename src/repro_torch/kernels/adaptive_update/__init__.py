from repro_torch.kernels.adaptive_update.cuda import (
    LAUNCHES,
    build_library,
    fused_chain,
    fused_combine,
    fused_tick,
    fused_update,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "build_library",
    "fused_chain",
    "fused_combine",
    "fused_tick",
    "fused_update",
    "reset_launches",
]
