"""Wrapper of the hand-written Hopper RG-LRU kernel.

The kernel lives in ``csrc/rg_lru.cu`` (CUDA C++ for ``sm_90a``,
``rg_lru_forward``) and replaces the Pallas kernel
``src/repro/kernels/rg_lru/kernel.py::rg_lru_call``; its source note gives
the design and its byte bound.  The reference's wrapper
(``ops.py::rg_lru``) pads width and time to its tiles; this kernel takes any
``(B, S, W)`` and needs no padding.

On a CPU tensor the wrapper runs the plain version, :func:`.ref.rg_lru_ref`;
on a CUDA tensor it launches the kernel or raises.  There is no other
fallback.  :data:`LAUNCHES` counts the kernel's launches (the CPU path counts
nothing).  The module is ``cuda.py``, not ``kernel.py``: the repository's
lint (RL004) claims ``kernels/<family>/(kernel|fused).py``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import compile_libraries, ptr, raise_on, stream
from repro_torch.kernels.rg_lru.ref import rg_lru_ref

__all__ = ["LAUNCHES", "reset_launches", "rg_lru", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rg_lru.cu"

LAUNCHES = {"rg_lru": 0}
_lib = None


def reset_launches() -> None:
    LAUNCHES["rg_lru"] = 0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(compile_libraries([SOURCE])[0]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru_forward.argtypes = [P, P, P, I, I, I, P]
        lib.rg_lru_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def rg_lru(log_a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + x_t from h_0 = 0: (B, S, W) f32 -> (B, S, W) f32."""
    if log_a.device.type == "cpu":
        return rg_lru_ref(log_a, x_in)
    if log_a.dim() != 3 or x_in.shape != log_a.shape:
        raise ValueError(f"log_a and x_in must be one (B, S, W) shape; got "
                         f"{tuple(log_a.shape)}, {tuple(x_in.shape)}")
    for name, t in (("log_a", log_a), ("x_in", x_in)):
        if t.device != log_a.device:
            raise ValueError(f"{name} is on {t.device}, log_a on {log_a.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, S, W = log_a.shape
    y = torch.empty_like(log_a)
    err = _load().rg_lru_forward(ptr(log_a), ptr(x_in), ptr(y), B, S, W, stream(log_a.device))
    raise_on(err, "rg_lru_forward")
    LAUNCHES["rg_lru"] += 1
    return y
