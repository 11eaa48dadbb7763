"""Wrappers of the hand-written Hopper kernels of the adaptive_update family.

The kernels live in ``csrc/adaptive_update.cu`` (CUDA C++ for ``sm_90a``):
``au_fused_tick`` (push + slot-folded combine + scalars + body + apply),
``au_fused_chain`` (scalars + body + apply), ``au_fused_combine`` (push +
combine) and ``au_fused_update`` (the ``fused_apply`` link).  They replace the
Pallas kernels of ``src/repro/kernels/adaptive_update/`` (``fused.py`` and
``kernel.py``); the source note names each one and its byte bound.

Build and binding: ``nvcc`` compiles the source into
``build/repro_torch_kernels/libadaptive_update.so`` at the repository root the
first time a wrapper sees a CUDA tensor (or when :func:`build_library` is called),
and ``ctypes`` loads it.  Every pointer and the stream pass as
``c_void_p``; each kernel launches on ``torch.cuda.current_stream()`` and the
C entry returns ``cudaGetLastError()``, which the wrapper raises on.

Semantics: every wrapper updates its buffers IN PLACE (params, optimizer
state, ring) — the full-width ring does not fit twice on one card.  On a CPU
tensor the wrapper runs the plain version from :mod:`.ref` and copies the
result into the buffers; on a CUDA tensor it launches the kernel or raises.
There is no other fallback.

Launch counts: :data:`LAUNCHES` holds one plain integer per kernel, raised by
one where the wrapper launches its kernel and nowhere else (the CPU path
counts nothing), so a run can show that its main path went through the
kernels.

Naming: this module is ``cuda.py``, not ``kernel.py`` or ``fused.py``, because
the repository's lint (reprolint RL004) claims every
``kernels/<family>/(kernel|fused).py`` as a Pallas module that needs a
``pallas``-marked parity test.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.async_engine.delayed import slot_live
from repro_torch.kernels.adaptive_update import ref
from repro_torch.kernels.nvcc import compile_libraries, library_path, ptr, raise_on, stream

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "build_library",
    "fused_tick",
    "fused_chain",
    "fused_combine",
    "fused_update",
    "SOURCE",
    "LIBRARY",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "adaptive_update.cu"
LIBRARY = library_path(SOURCE)

LAUNCHES = {"fused_tick": 0, "fused_chain": 0, "fused_combine": 0, "fused_update": 0}

_FAMILY = {"sgd": 0, "momentum": 1, "adam": 2}
_VEC = 8  # the tick and combine kernels' vector path wants n % _VEC == 0
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library(*, force: bool = False, verbose: bool = False) -> Path:
    """Compile the kernels with nvcc unless an up-to-date library exists;
    returns the library path."""
    return compile_libraries([SOURCE], force=force, verbose=verbose)[0]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.au_fused_tick.argtypes = [I, I, I, P, P, P, P, P, I, L, P, P, P, I, P, P]
        lib.au_fused_combine.argtypes = [I, I, P, P, P, I, L, P, P, P, I, P]
        lib.au_fused_chain.argtypes = [I, I, P, P, P, P, L, P, P, P]
        lib.au_fused_update.argtypes = [I, P, P, P, L, P, P, P]
        for fn in (lib.au_fused_tick, lib.au_fused_combine, lib.au_fused_chain,
                   lib.au_fused_update):
            fn.restype = ctypes.c_int
        lib.au_max_k.argtypes = []
        lib.au_max_k.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Argument checks (the kernels take exactly this and nothing else)
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _family_bufs(kind: str, bufs) -> tuple:
    """The kernel's view of the family state: () / (v,) / (m, v)."""
    if kind not in _FAMILY:
        raise ValueError(f"unknown fused-chain kind {kind!r}")
    if kind == "sgd":
        return ()
    if kind == "momentum":
        return (bufs,)
    return (bufs["m"], bufs["v"])


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


_COUNTERS: dict[tuple, torch.Tensor] = {}


def _chunk_counter(device) -> torch.Tensor:
    """The u64 from which the chain and update kernels' blocks draw chunks:
    one per device and stream, made 0 once.  Every launch leaves it at 0 (the
    block that draws the launch's last index resets it), so launches in
    order on one stream share it and launches on two streams never do."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return counter


def pack_scalars(scalars: dict, order, device) -> torch.Tensor:
    """The scalar bundle as one f32 device vector in kernel order, without a
    host sync: host values go through pinned memory with a non-blocking copy,
    device values are copied in on the stream."""
    host = torch.empty(len(order), dtype=torch.float32, pin_memory=True)
    on_device = []
    for i, key in enumerate(order):
        v = scalars[key]
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            host[i] = 0.0
            on_device.append((i, v))
        else:
            host[i] = v
    vec = host.to(device, non_blocking=True)
    for i, v in on_device:
        vec[i:i + 1].copy_(v.reshape(1))
    return vec


def _tick_operands(p, g, ring, step, taus, weights):
    dev = p.device
    n = p.shape[0]
    _check(p, "p", torch.float32, dev, (n,))
    _check(g, "g", torch.float32, dev, (n,))
    if ring.dim() != 2 or ring.shape[1] != n:
        raise ValueError(f"ring must be (K, {n}), got {tuple(ring.shape)}")
    _check(ring, "ring", (torch.float32, torch.bfloat16), dev)
    K, max_k = ring.shape[0], _load().au_max_k()
    if not 1 <= K <= max_k:
        raise ValueError(f"ring depth K={K} outside [1, {max_k}]")
    _check(step, "step", torch.int32, dev, ())
    if taus.dim() != 1:
        raise ValueError("taus must be 1-D")
    _check(taus, "taus", torch.int32, dev)
    _check(weights, "weights", torch.float32, dev, tuple(taus.shape))
    return n, K


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def fused_tick(kind: str, p, g, bufs, scalars, ring, step, taus, weights) -> torch.Tensor:
    """One whole async tick in place: push ``g`` into ring slot ``step % K``,
    combine the W delayed gradients, apply the scalars and the ``kind`` body
    to ``p`` and ``bufs``.  Returns the (W,) live mask."""
    fam = _family_bufs(kind, bufs)
    if p.device.type == "cpu":
        p_new, b_new, r_new, live = ref.fused_tick_ref(kind, p, g, bufs, scalars, ring, step, taus, weights)
        _write_back(kind, p, bufs, p_new, b_new)
        ring.copy_(r_new)
        return live
    n, K = _tick_operands(p, g, ring, step, taus, weights)
    for i, b in enumerate(fam):
        _check(b, f"state[{i}]", torch.float32, p.device, (n,))
    s = pack_scalars(scalars, ref.SCALAR_ORDER[kind], p.device)
    vec = 1 if n % _VEC == 0 and _aligned(p, g, ring, *fam) else 0
    s0 = fam[0] if fam else None
    s1 = fam[1] if len(fam) > 1 else None
    err = _load().au_fused_tick(
        _FAMILY[kind], int(ring.dtype == torch.bfloat16), vec, ptr(p), ptr(g), ptr(s0),
        ptr(s1), ptr(ring), K, n, ptr(step), ptr(taus), ptr(weights), taus.shape[0],
        ptr(s), stream(p.device),
    )
    raise_on(err, "au_fused_tick")
    LAUNCHES["fused_tick"] += 1
    return slot_live(step, taus, K)[1]


def fused_combine(g, ring, step, taus, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """Push ``g`` into the ring in place and return ``(g_eff, live)``."""
    if g.device.type == "cpu":
        g_eff, live, r_new = ref.fused_combine_ref(g, ring, step, taus, weights)
        ring.copy_(r_new)
        return g_eff, live
    n, K = _tick_operands(g, g, ring, step, taus, weights)
    g_eff = torch.empty_like(g)
    vec = 1 if n % _VEC == 0 and _aligned(g, ring, g_eff) else 0
    err = _load().au_fused_combine(
        int(ring.dtype == torch.bfloat16), vec, ptr(g), ptr(ring), ptr(g_eff), K, n,
        ptr(step), ptr(taus), ptr(weights), taus.shape[0], stream(g.device),
    )
    raise_on(err, "au_fused_combine")
    LAUNCHES["fused_combine"] += 1
    return g_eff, slot_live(step, taus, K)[1]


def fused_chain(kind: str, p, g, bufs, scalars) -> None:
    """Scalars + ``kind`` body + apply on flat buffers, in place."""
    fam = _family_bufs(kind, bufs)
    if p.device.type == "cpu":
        p_new, b_new = ref.fused_chain_ref(kind, p, g, bufs, scalars)
        _write_back(kind, p, bufs, p_new, b_new)
        return
    n = p.shape[0]
    _check(p, "p", torch.float32, p.device, (n,))
    _check(g, "g", torch.float32, p.device, (n,))
    for i, b in enumerate(fam):
        _check(b, f"state[{i}]", torch.float32, p.device, (n,))
    s = pack_scalars(scalars, ref.SCALAR_ORDER[kind], p.device)
    counter = _chunk_counter(p.device)
    # aligned: 16-byte vectors over n - n % 4 elements, then a scalar tail
    vec = 1 if _aligned(p, g, *fam) else 0
    s0 = fam[0] if fam else None
    s1 = fam[1] if len(fam) > 1 else None
    err = _load().au_fused_chain(
        _FAMILY[kind], vec, ptr(p), ptr(g), ptr(s0), ptr(s1), n, ptr(s), ptr(counter),
        stream(p.device),
    )
    raise_on(err, "au_fused_chain")
    LAUNCHES["fused_chain"] += 1


def fused_update(p, g, v, alpha, mu) -> None:
    """``v <- mu v - alpha g; p <- p + v`` on flat f32 buffers, in place."""
    if p.device.type == "cpu":
        p_new, v_new = ref.adaptive_update_ref(p, g, v, alpha, mu)
        p.copy_(p_new)
        v.copy_(v_new)
        return
    n = p.shape[0]
    for name, t in (("p", p), ("g", g), ("v", v)):
        _check(t, name, torch.float32, p.device, (n,))
    s = pack_scalars({"alpha": alpha, "mu": mu}, ("alpha", "mu"), p.device)
    counter = _chunk_counter(p.device)
    vec = 1 if _aligned(p, g, v) else 0
    err = _load().au_fused_update(vec, ptr(p), ptr(g), ptr(v), n, ptr(s), ptr(counter),
                                  stream(p.device))
    raise_on(err, "au_fused_update")
    LAUNCHES["fused_update"] += 1


def _write_back(kind, p, bufs, p_new, b_new) -> None:
    p.copy_(p_new)
    if kind == "momentum":
        bufs.copy_(b_new)
    elif kind == "adam":
        bufs["m"].copy_(b_new["m"])
        bufs["v"].copy_(b_new["v"])
