"""Wrapper of the hand-written Hopper selective-scan kernel.

The kernel lives in ``csrc/selective_scan.cu`` (CUDA C++ for ``sm_90a``,
``selective_scan_forward``) and replaces the Pallas kernel
``src/repro/kernels/selective_scan/kernel.py::selective_scan_call``; its
source note gives the design and its bound.  The reference's wrapper
(``ops.py::selective_scan``) pads channels and time to its tiles and returns
``y`` alone; this kernel takes any ``(B, S, D)`` and ``N <= 16`` (Mamba-1's
16 states) with no padding, casts a bf16 ``u`` itself (a cast here would be
one more pass over ``u``), and also returns the final state, so the prefill
takes its output and its decode cache from one scan.

On a CPU tensor the wrapper runs the plain version,
:func:`.ref.selective_scan_ref`; on a CUDA tensor it launches the kernel or
raises.  There is no other fallback.  :data:`LAUNCHES` counts the kernel's
launches (the CPU path counts nothing).  The module is ``cuda.py``, not
``kernel.py``: the repository's lint (RL004) claims
``kernels/<family>/(kernel|fused).py``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import compile_libraries, ptr, raise_on, stream
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["LAUNCHES", "reset_launches", "selective_scan", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATES = 16  # the states a kernel thread holds in registers

LAUNCHES = {"selective_scan": 0}
_lib = None


def reset_launches() -> None:
    LAUNCHES["selective_scan"] = 0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(compile_libraries([SOURCE])[0]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_forward.argtypes = [P, I, P, P, P, P, P, P, I, I, I, I, P]
        lib.selective_scan_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(u, delta, A, Bm, Cm) -> None:
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"u and delta must be one (B, S, D) shape; got {tuple(u.shape)}, "
                         f"{tuple(delta.shape)}")
    B, S, D = u.shape
    if A.dim() != 2 or A.shape[0] != D or not 1 <= A.shape[1] <= MAX_STATES:
        raise ValueError(f"A must be (D={D}, N) with 1 <= N <= {MAX_STATES}; got {tuple(A.shape)}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (B, S, A.shape[1]):
            raise ValueError(f"{name} must be {(B, S, A.shape[1])}; got {tuple(t.shape)}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"u has dtype {u.dtype}, expected float32 or bfloat16")
    for name, t in (("u", u), ("delta", delta), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if name != "u" and t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def selective_scan(u, delta, A, Bm, Cm) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 scan from h_0 = 0 -> ``(y (B, S, D) f32, hT (B, D, N) f32)``.

    u: (B, S, D) bf16 or f32; delta: (B, S, D), A: (D, N), Bm/Cm: (B, S, N)
    f32.  ``y`` leaves out ``d_skip``, as the reference's kernel does.
    """
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, Bm, Cm)
    _check(u, delta, A, Bm, Cm)
    B, S, D = u.shape
    N = A.shape[1]
    y = torch.empty((B, S, D), dtype=torch.float32, device=u.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    err = _load().selective_scan_forward(
        ptr(u), 1 if u.dtype == torch.bfloat16 else 0, ptr(delta), ptr(A), ptr(Bm), ptr(Cm),
        ptr(y), ptr(hT), B, S, D, N, stream(u.device))
    raise_on(err, "selective_scan_forward")
    LAUNCHES["selective_scan"] += 1
    return y, hT
