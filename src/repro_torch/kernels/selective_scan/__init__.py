from repro_torch.kernels.selective_scan.cuda import LAUNCHES, reset_launches, selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["LAUNCHES", "reset_launches", "selective_scan", "selective_scan_ref"]
