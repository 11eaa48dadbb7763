from repro_torch.kernels.rg_lru.cuda import LAUNCHES, reset_launches, rg_lru
from repro_torch.kernels.rg_lru.ref import rg_lru_ref

__all__ = ["LAUNCHES", "reset_launches", "rg_lru", "rg_lru_ref"]
