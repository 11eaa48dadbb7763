"""Build and bind the port's CUDA C++ sources (shared by every kernel family).

Each family keeps one source, ``kernels/<family>/csrc/<name>.cu``, with a
plain C interface.  :func:`compile_libraries` compiles sources with ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>.so`` at the
repository root — one ``nvcc`` process per source, all started together —
and skips a library newer than its source.  A family's wrapper loads its
library with ``ctypes`` at its first CUDA call, never at import: the CPU
tests import every module on a machine without ``nvcc``.

The ctypes helpers pass every pointer and the stream as ``c_void_p`` (a bare
Python int would be cut to 32 bits) and turn the ``cudaGetLastError()`` that
each C entry returns into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "compile_libraries", "ptr", "stream",
           "raise_on"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (needed to build the port's CUDA kernels)")
    return found


def compile_libraries(sources, *, force: bool = False, verbose: bool = False) -> list[Path]:
    """Compile each source into its library unless an up-to-date one exists.

    One ``nvcc`` per source, all running at once; each writes to a temporary
    name that is renamed when it succeeds, so a half-written library is never
    loaded.  Waits for every process it started, then raises if any failed.
    Returns the library paths in the order of ``sources``.
    """
    sources = [Path(s) for s in sources]
    started = []
    for src in sources:
        lib = library_path(src)
        if not force and lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        started.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for src, lib, tmp, proc in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out}{err}")
            continue
        if verbose:
            print(f"[nvcc {src.name}]\n{out}{err}", end="")
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [library_path(s) for s in sources]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
