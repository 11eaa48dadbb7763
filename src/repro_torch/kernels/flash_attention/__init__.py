from repro_torch.kernels.flash_attention.cuda import LAUNCHES, flash_attention, reset_launches
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention", "reset_launches"]
