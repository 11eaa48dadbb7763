"""Wrapper of the hand-written Hopper flash-attention kernel.

The kernel lives in ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``,
``fa_forward``) and replaces the Pallas kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_call``; its
source note gives the design and what bounds it.  It has two bodies:

* bf16: the products on the tensor cores (``wgmma``), K/V tiles by TMA into a
  2-stage ring in shared memory, a producer warpgroup and one or two
  consumer warpgroups of 64 query rows per block (by head width), P split
  into two bf16 terms for the PV product so the result stays within one
  bf16 rounding of the f32 reference.  TMA needs
  16-byte aligned bases and strides: the wrapper refuses an input that lacks
  them (no copy, no fallback).
* f32: the products on the CUDA cores in f32 (the tensor cores would take
  f32 only as TF32, which would break the reference's 3e-5 gate).

:func:`flash_attention` takes the model's ``(B, S, N, H)`` layout, as the
reference's ``ops.py::flash_attention`` does, but needs none of its
transposes or padding: the kernel reads q, k and v through their strides and
masks the ragged ends itself.

On a CPU tensor the wrapper runs the plain version,
:func:`.ref.attention_ref`; on a CUDA tensor it launches the kernel of its
dtype or raises.  There is no other fallback.  The kernel is forward-only,
as the reference's is (no VJP): an input that requires a gradient is
refused.

:data:`LAUNCHES` counts the kernel's launches (the CPU path counts nothing).
The module is ``cuda.py``, not ``kernel.py``: the repository's lint (RL004)
claims ``kernels/<family>/(kernel|fused).py`` for Pallas modules.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.nvcc import compile_libraries, ptr, raise_on, stream

__all__ = ["LAUNCHES", "reset_launches", "flash_attention", "SOURCE", "HEAD_DIMS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)  # the kernel's template instances

LAUNCHES = {"flash_attention": 0}
_lib = None


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(compile_libraries([SOURCE])[0]))
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.fa_forward.argtypes = [I, I, P, P, P, P, I, I, I, I, I,
                                   L, L, L, L, L, L, L, L, L, I, I, F, F, P]
        lib.fa_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v) -> None:
    B, S, Nq, H = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != H:
        raise ValueError(f"k and v must be (B, T, Nkv, {H}); got {tuple(k.shape)}, {tuple(v.shape)}")
    Nkv = k.shape[2]
    if Nq % Nkv:
        raise ValueError(f"{Nq} query heads do not group over {Nkv} KV heads")
    if H not in HEAD_DIMS:
        raise ValueError(f"head_dim {H} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"q, k, v must share a dtype in (float32, bfloat16); {name} is {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over head_dim")
        if t.requires_grad:
            raise ValueError("flash_attention is forward-only (no VJP, as in the reference)")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(t.stride(d) % 8 for d in range(3) if t.shape[d] > 1)):
            raise ValueError(f"{name}: the bf16 kernel loads tiles by TMA, which needs a 16-byte "
                             f"aligned base and strides (multiples of 8 elements); got strides "
                             f"{t.stride()}")


def flash_attention(
    q: torch.Tensor,  # (B, S, Nq, H) — model layout
    k: torch.Tensor,  # (B, T, Nkv, H)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention -> ``(B, S, Nq, H)`` in ``v``'s dtype."""
    H = q.shape[3]
    scale = H**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    _check(q, k, v)
    B, S, Nq, _ = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    out = torch.empty((B, S, Nq, H), dtype=v.dtype, device=q.device)
    err = _load().fa_forward(
        q.dtype == torch.bfloat16, H, ptr(q), ptr(k), ptr(v), ptr(out), B, S, T, Nq, Nkv,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), causal, window or 0, softcap or 0.0, scale,
        stream(q.device),
    )
    raise_on(err, "fa_forward")
    LAUNCHES["flash_attention"] += 1
    return out
