#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package, and fails
(non-zero exit, no result line) without a card or outside a checkout.

Phases, each fatal on failure:

1. build — ``nvcc`` compiles the four CUDA sources for sm_90a, one process
   per source, all at once: ``adaptive_update.cu``, ``flash_attention.cu``,
   ``rg_lru.cu`` and ``selective_scan.cu``; prints ``ptxas -v`` (registers,
   shared memory and spills of every kernel).
2. kernels — every adaptive_update kernel's wrapper against its plain
   PyTorch version on the card, at the full-width shapes of stablelm-1.6b
   (N = 1,438,846,976 f32 params, K = 8 ring slots, W = 8 workers): the tick
   for sgd / momentum / adam with f32 and bf16 rings, the chain, the combine
   and fused_update.  Tolerance |kernel - plain| <= 1e-6 + 1e-6 |plain|
   (1e-5 with a bf16 ring: the slot-folded sum differs from the
   worker-by-worker one in rounding); the ring's bits and the live mask
   exactly equal.  The momentum / bf16 tick runs again with NaN in ring
   slots 5 and 7, which no worker maps to at step 11: p and v must come out
   finite and match the plain version (the tick reads only live slots).
   Prints each kernel's time, the plain version's, the byte bound at
   3.35 TB/s (the tick moves exactly those bytes) and the errors.
3. main path — ``run(RunSpec(mode="async", fuse=True, ...))`` on full-width
   stablelm-1.6b (24 layers, momentum, W = 8, ring 8 in bf16, batch 4 x seq
   512, refresh every 5) for 12 ticks, launch counts zeroed just before and
   read just after; checks finite losses, one fused_tick launch per tick, a
   refresh that rewrote the alpha table in place, and prints peak memory and,
   per tick, the ring slots the tick read (replayed from that tick's taus)
   and so its bytes.
   Then the same fused async run on reduced stablelm on the card against the
   plain CPU path on the same params, batches and uniforms.
4. other paths — sync (fused_chain), clip (fused_combine + fused_chain) and
   ``fused_apply`` (fused_update) at full width and 2 layers, each with its
   counts zeroed before and read after.
5. serving kernels — the flash-attention kernel against its plain version at
   the recurrentgemma-9b local-layer shape (B 4, S = T = 4096, Nq 16, Nkv 1,
   H 256, window 2048, causal, bf16, and the same in f32 at B 1), the
   stablelm-1.6b shape (B 4, S 512, Nq = Nkv = 32, H 64, causal, bf16), a
   gemma2-27b-like shape the serving path does not reach (Nq 32, Nkv 16,
   H 128, window 64, softcap 50, S = 1000, f32 and bf16, causal and not) and
   S != T (S 77, T 150, H 256, window 40, non-causal, bf16), so every bf16
   head width of the tensor-core body runs; the RG-LRU kernel at B 4,
   S 4096, W 4096.  Tolerance |kernel - plain| <= 3e-5 +
   3e-5 |plain| in f32, the reference's; in bf16 1e-4 + 1e-2 |plain|, one
   bf16 rounding of the output (both sides compute in f32 and round once),
   tighter than the reference's 3e-2, which at S = 4096 is as large as a
   typical output and would pass a band edge one key tile off.  Prints each
   time, the plain version's, the bound (the larger of bytes / 3.35 TB/s and
   the band's QK^T + PV FLOPs over the peak for the input type: 989 TFLOP/s
   bf16, 67 TFLOP/s f32) and, for attention, the achieved TFLOP/s of band
   work, the share of the bound and ``scaled_dot_product_attention``'s time
   at the same shape (timed only).
   The selective-scan kernel at the falcon-mamba-7b shape (B 4, S 4096,
   D 8192, N 16, u in bf16) with the model's A = -(1..N) and with A drawn
   per (d, n) as -exp(randn), and at odd sizes with u in f32 (B 2, S 1000,
   D 1000): y and the final state within 3e-5 + 3e-5 |plain|, the
   reference's tolerance; its bound is the largest of the bytes over
   3.35 TB/s, the exponentials over the SFU rate (16 a clock per SM, 132
   SMs, 1.98 GHz) and 6 f32 operations per (b, t, d, n) over 67 TFLOP/s;
   prints the exponentials per second it reached beside that SFU peak.
6. serving — the training state freed, full-width recurrentgemma-9b (38
   layers, 9.4e9 f32 params) through ``repro_torch.launch.serve``: batch 4,
   prompt 4096, 32 greedy steps, with the counts zeroed just before and read
   just after: 12 flash and 26 RG-LRU launches (one per recurrent layer:
   its output and its cache come from one recurrence), finite logits,
   ids in range.  Then full-width stablelm-1.6b: batch 4, prompt 512, 32
   steps, 24 flash launches.  Then full-width falcon-mamba-7b (64 Mamba
   layers, 7.27e9 f32 params): batch 4, prompt 4096, 32 steps, 64
   selective-scan launches (one per layer: its output and its cache come
   from one scan).  Every serve counts all three serving kernels.  Prints
   prefill s, decode ms per step, tok/s and peak memory.  Then reduced
   recurrentgemma and reduced falcon-mamba served on the card (the kernels)
   against the plain CPU path, same params: prompt 160, 4 steps, logits
   within 1e-4, ids equal.

7. resume — the configuration of phase 3 with 6 ticks and a refresh every 2:
   run A uninterrupted, checkpointing at step 3 (``CheckpointHook``; its
   histogram is partial) into a temporary directory under ``build/``; run B,
   a fresh pipeline and adapt, ``run(spec, resume_from=dir,
   resume_step=3)``, crossing the step-4 refresh.  B's losses must equal A's
   steps 4-6 and every leaf of B's final state (params, momentum, ring bits,
   ring step, adapt tables and histogram, step, generator state) A's, bit for
   bit; the host estimators must agree; fused_tick launches 6 + 3.  Prints
   the checkpoint's GB on disk, save and restore seconds, the disk's free
   space and peak memory.  The directory is removed at the end of the phase.
8. exact simulator — the paper's Fig.-3 problem (noisy quadratic, d 16,
   m 16, T 3000; constant and eq.-26 geometric-momentum tables) through
   ``async_engine.exact`` on the card and on the CPU: taus and alphas
   exactly equal, losses and x within 1e-5 relative (max |d| / max |CPU|),
   and the adaptive table at loss 1.5 in no more commits than the constant
   one.  Prints both commit counts and the phase's seconds.
9. sharded async — ``run(RunSpec(mode="sharded_async", fuse=True, ...))`` on
   full-width stablelm-1.6b: momentum, W = 2 workers of K = 4 bf16 ring
   slots each (worker 0 draws from a geometric CDF, worker 1 replays an
   event-simulator trace), the eq.-26 table, batch 4 x seq 512, 6 ticks, a
   refresh every 3; counts zeroed just before and read just after.  Checks
   6 ``fused_chain`` launches and no ``fused_tick``, finite losses, a
   refresh that rewrote the alpha table in place, and that each refresh
   drained a merged histogram of exactly W x 3 taus.  Prints the median
   tick, peak memory and the ring's GB.  Then the same fused sharded run on
   reduced stablelm (W 2 and 4) on the card against the plain CPU path (same
   params, batches and uniforms): with an f32 ring, as phase 3's reduced
   check, max |dp| <= 1e-5; with a bf16 ring the difference is printed
   (a bf16 rounding flip moves p by up to 2^-8 of a step); histograms and
   tables equal in both.
10. the paper's CNN — the Fig.-1 CNN at 32x32x3, batch 16, m 16, the
   constant table at alpha 0.01, through the exact simulator on the card and
   on the CPU over the first 100 commits of the heterogeneous event order:
   taus and alphas exactly equal; in float64 the losses within 1e-4
   relative (max |d| / max |CPU|); in f32 the same bound over the commits
   before the CPU's own f32 run leaves its f64 run by 1e-5 relative (the
   trajectory amplifies round-off; the horizon is measured in this run).
   Then ``experiments.convergence`` at m 16, one repeat, T 2500, printing its
   row (not gated on speedup: the paper's claim is a trend), and the CNN
   example's constant and MindTheStep runs at 600 commits, printing both
   iterations-to-threshold and seconds.

Then one JSON object with every kernel (launches on its path, max_abs_err,
ms, plain_ms, bound_ms, library_ms, ...), the card's name and power limit,
and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SM_CLOCK_HZ = 1.98e9  # H100 SXM maximum SM clock (NVIDIA data sheet)
SFU_EXP_PER_S = 16 * 132 * SM_CLOCK_HZ  # exponentials: 16 a clock per SM, 132 SMs
PEAK_FLOPS = {  # H100 SXM peaks by input type (NVIDIA data sheet)
    "bfloat16": 989e12,  # dense bf16 tensor cores
    "float32": 67e12,  # f32 outside the tensor cores
}
SOURCE = "src/repro_torch/kernels/adaptive_update/csrc/adaptive_update.cu"
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rg_lru": "src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
    "selective_scan": "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
}
REPLACES = {
    "fused_tick": "src/repro/kernels/adaptive_update/fused.py:301",
    "fused_chain": "src/repro/kernels/adaptive_update/fused.py:137",
    "fused_combine": "src/repro/kernels/adaptive_update/fused.py:349",
    "fused_update": "src/repro/kernels/adaptive_update/kernel.py:46",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
    "rg_lru": "src/repro/kernels/rg_lru/kernel.py:46",
    "selective_scan": "src/repro/kernels/selective_scan/kernel.py:57",
}
K_RING, W_WORKERS, STEP = 8, 8, 11
TAUS = [0, 2, 5, 2, 9, 1, 3, 7]  # two workers share a slot; tau 9 >= K is dead
CHUNK = 1 << 26


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Fail(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# Phase 2 helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters=5, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def stash(t):
    """An untouched copy of ``t``: on the card when it fits, else on the host."""
    import torch

    free, _ = torch.cuda.mem_get_info()
    if free > t.numel() * t.element_size() + (6 << 30):
        return t.clone()
    return t.cpu()


def slot_checksums(ring):
    import torch

    bits = ring.view(torch.int16 if ring.dtype == torch.bfloat16 else torch.int32)
    n = ring.shape[1]
    return [sum(int(bits[k, lo:lo + CHUNK].sum(dtype=torch.int64)) for lo in range(0, n, CHUNK))
            for k in range(ring.shape[0])]


def live_slots(step, taus, weights, K):
    """Ring slots the tick must read (live worker, nonzero folded weight,
    not the slot the fresh gradient replaces) — this run's data."""
    w_slot = [0.0] * K
    for tau, w in zip(taus, weights):
        src = step - tau
        if src >= 0 and tau < K:
            w_slot[src % K] += w
    return sum(1 for k in range(K) if w_slot[k] != 0.0 and k != step % K)


def tick_bytes(kind, n, ring_item, step, taus, weights, K):
    state = {"sgd": 0, "momentum": 1, "adam": 2}[kind]
    return n * (8 + 4 + 8 * state + ring_item * (1 + live_slots(step, taus, weights, K)))


def kernel_scalars(kind):
    import torch

    s = {"f_stale": 1.3, "f_keep": 1.0, "f_clip": 0.7, "m_scale": -0.05, "mu": 0.9,
         "b1": 0.9, "omb1": 0.1, "b2": 0.999, "omb2": 0.001, "eps": 1e-8, "c1": 10.0, "c2": 1000.0}
    from repro_torch.kernels.adaptive_update.ref import SCALAR_ORDER

    return {k: torch.tensor(s[k], dtype=torch.float32) for k in SCALAR_ORDER[kind]}


def make_state(kind, n, gen, dev):
    """Random optimizer state.  Adam's second moment is kept away from 0 (in
    [0.1, 1.1); tests/test_fuse.py uses 0.2): as v -> 0 the adam body
    divides by sqrt(v) and amplifies the combine's one-ulp association
    difference without bound, which would test conditioning, not the kernel."""
    import torch

    if kind == "sgd":
        return ()
    if kind == "momentum":
        return torch.randn(n, generator=gen, device=dev)
    return {"m": torch.randn(n, generator=gen, device=dev),
            "v": torch.rand(n, generator=gen, device=dev) + 0.1}


def state_list(kind, bufs):
    return [] if kind == "sgd" else ([bufs] if kind == "momentum" else [bufs["m"], bufs["v"]])


def err_update(errs, got, want, tol):
    """Track max |got - want| and fail past |d| <= tol + tol |want|."""
    d = (got - want).abs()
    errs["max_abs_err"] = max(errs["max_abs_err"], float(d.max()))
    bad = int((d > tol + tol * want.abs()).sum())
    check(bad == 0, f"{bad} elements past tolerance {tol}")


DEAD_SLOTS = (5, 7)  # no worker's source slot at STEP with TAUS


def check_tick(kind, ring_dtype, n, dev, *, nan_dead=False):
    """Tick kernel vs plain at full width; returns the numbers for the JSON.
    ``nan_dead`` fills the slots no worker maps to with NaN: a tick that read
    them would turn p and the state to NaN (0 * NaN); it is not timed."""
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    bufs = make_state(kind, n, gen, dev)
    ring = torch.randn(K_RING, n, generator=gen, device=dev, dtype=ring_dtype)
    if nan_dead:
        for k in DEAD_SLOTS:
            ring[k] = float("nan")
    step = torch.tensor(STEP, dtype=torch.int32, device=dev)
    taus = torch.tensor(TAUS, dtype=torch.int32, device=dev)
    weights = torch.rand(W_WORKERS, generator=gen, device=dev) + 0.1
    s = kernel_scalars(kind)
    p0, bufs0 = stash(p), [stash(b) for b in state_list(kind, bufs)]
    sums0 = slot_checksums(ring)
    live = C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights)
    torch.cuda.synchronize()
    for x in [p] + state_list(kind, bufs):
        check(all(bool(torch.isfinite(x[lo:lo + CHUNK]).all()) for lo in range(0, n, CHUNK)),
              "the tick produced non-finite values" + (" (it read a dead slot)" if nan_dead else ""))
    sums1 = slot_checksums(ring)
    push = STEP % K_RING
    check(all(a == b for k, (a, b) in enumerate(zip(sums0, sums1)) if k != push),
          "tick kernel wrote a ring slot other than the pushed one")
    tol = 1e-5 if ring_dtype == torch.bfloat16 else 1e-6
    errs = {"max_abs_err": 0.0}
    plain_ms = 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc = p0[lo:hi].to(dev)
        bc = [x[lo:hi].to(dev) for x in bufs0]
        bufs_c = () if kind == "sgd" else (bc[0] if kind == "momentum" else {"m": bc[0], "v": bc[1]})
        rc = ring[:, lo:hi].contiguous()
        a.record()
        pr, br, rr, lr = ref.fused_tick_ref(kind, pc, g[lo:hi], bufs_c, s, rc, step, taus, weights)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, p[lo:hi], pr, tol)
        for got, want in zip([x[lo:hi] for x in state_list(kind, bufs)], state_list(kind, br)):
            err_update(errs, got, want, tol)
        check(torch.equal(ring[push, lo:hi], rr[push]), "pushed ring slot differs from the plain push")
        check(torch.equal(live, lr), "live mask differs")
        del pc, bc, bufs_c, rc, pr, br, rr
    del p0, bufs0
    item = ring.element_size()
    nbytes = tick_bytes(kind, n, item, STEP, TAUS, weights.tolist(), K_RING)
    if nan_dead:
        return dict(max_abs_err=errs["max_abs_err"], plain_ms=plain_ms, bytes=nbytes)
    ms = cuda_ms(lambda: C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights))
    # the kernel reads only the live slots: it moves exactly the bound's bytes
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, kernel_bytes=nbytes)


def check_chain(kind, n, dev):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(2)
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    bufs = make_state(kind, n, gen, dev)
    s = kernel_scalars(kind)
    p0, bufs0 = stash(p), [stash(b) for b in state_list(kind, bufs)]
    C.fused_chain(kind, p, g, bufs, s)
    torch.cuda.synchronize()
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc = p0[lo:hi].to(dev)
        bc = [x[lo:hi].to(dev) for x in bufs0]
        bufs_c = () if kind == "sgd" else (bc[0] if kind == "momentum" else {"m": bc[0], "v": bc[1]})
        a.record()
        pr, br = ref.fused_chain_ref(kind, pc, g[lo:hi], bufs_c, s)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, p[lo:hi], pr, 1e-6)
        for got, want in zip([x[lo:hi] for x in state_list(kind, bufs)], state_list(kind, br)):
            err_update(errs, got, want, 1e-6)
    del p0, bufs0
    ms = cuda_ms(lambda: C.fused_chain(kind, p, g, bufs, s))
    nbytes = n * (8 + 4 + 8 * len(state_list(kind, bufs)))
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)


def check_combine(n, dev):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(n, generator=gen, device=dev)
    ring = torch.randn(K_RING, n, generator=gen, device=dev, dtype=torch.bfloat16)
    step = torch.tensor(STEP, dtype=torch.int32, device=dev)
    taus = torch.tensor(TAUS, dtype=torch.int32, device=dev)
    weights = torch.rand(W_WORKERS, generator=gen, device=dev) + 0.1
    sums0 = slot_checksums(ring)
    g_eff, live = C.fused_combine(g, ring, step, taus, weights)
    torch.cuda.synchronize()
    push = STEP % K_RING
    check(all(a == b for k, (a, b) in enumerate(zip(sums0, slot_checksums(ring))) if k != push),
          "combine kernel wrote a ring slot other than the pushed one")
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        rc = ring[:, lo:hi].contiguous()
        a.record()
        gr, lr, rr = ref.fused_combine_ref(g[lo:hi], rc, step, taus, weights)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, g_eff[lo:hi], gr, 1e-5)
        check(torch.equal(ring[push, lo:hi], rr[push]), "pushed ring slot differs")
        check(torch.equal(live, lr), "live mask differs")
    ms = cuda_ms(lambda: C.fused_combine(g, ring, step, taus, weights))
    nbytes = n * (4 + 4 + 2 * (1 + live_slots(STEP, TAUS, weights.tolist(), K_RING)))
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)


def check_update(n, dev):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    p, g, v = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    alpha, mu = torch.tensor(0.05), torch.tensor(0.9)
    p0, v0 = stash(p), stash(v)
    C.fused_update(p, g, v, alpha, mu)
    torch.cuda.synchronize()
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc, vc = p0[lo:hi].to(dev), v0[lo:hi].to(dev)
        a.record()
        pr, vr = ref.adaptive_update_ref(pc, g[lo:hi], vc, alpha, mu)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, p[lo:hi], pr, 1e-6)
        err_update(errs, v[lo:hi], vr, 1e-6)
    del p0, v0
    ms = cuda_ms(lambda: C.fused_update(p, g, v, alpha, mu))
    nbytes = n * 20
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 3 and 4: the paths, through the port's entry points
# ---------------------------------------------------------------------------

class TickLog:
    """Per-tick host line (synchronizes to time each tick: measurement only).

    With ``replay`` (the fused async main path) it also replays each tick's
    taus: it keeps the workers' generator state and the tables in force
    before the tick, draws the same uniforms again and looks them up, so it
    can count the ring slots the tick kernel read (``live_slots``) and so
    its bytes."""

    def __init__(self, name, workers=W_WORKERS, replay=False):
        import torch

        self.name, self.rows, self._torch, self.workers = name, [], torch, workers
        self._t = None
        self._snap = None
        self._replay_on = replay

    def _snapshot(self, state):
        if not self._replay_on or state.adapt is None or state.delayed is None:
            self._snap = None
            return
        self._snap = (state.rng.get_state(), state.adapt.tau_cdf.clone(),
                      state.adapt.alpha_table.clone(), int(state.delayed.step))

    def _replay(self, ctx):
        """(taus, slots read) of the tick just run, from the snapshot."""
        from repro_torch.training.adapt import sample_taus

        torch = self._torch
        rng_state, cdf, table, step = self._snap
        dev = cdf.device
        gen = torch.Generator(device=dev)
        gen.set_state(rng_state)
        taus = sample_taus(torch.rand(self.workers, generator=gen, device=dev), cdf)
        alphas = table[taus.long().clamp(0, table.shape[0] - 1)]
        check(abs(float(taus.float().mean()) - float(ctx.metrics["tau_mean"])) == 0.0,
              f"[{self.name}] the replayed taus disagree with the tick's tau_mean")
        K = _leaves(ctx.state.delayed.ring)[0].shape[0]
        return taus.tolist(), live_slots(step, taus.tolist(), alphas.tolist(), K)

    def on_start(self, ctx):
        self._snapshot(ctx.state)
        self._torch.cuda.synchronize()
        self._t = time.perf_counter()
        adapt = ctx.state.adapt
        self.table_ptr = adapt.alpha_table.data_ptr() if adapt is not None else None

    def on_refresh(self, ctx):
        pass

    def on_tick(self, ctx):
        self._torch.cuda.synchronize()
        now = time.perf_counter()
        m = {k: v.item() for k, v in ctx.metrics.items()}
        row = dict(step=ctx.step, ms=(now - self._t) * 1e3, loss=m["loss"],
                   tau_mean=m.get("tau_mean"), alpha_mean=m.get("alpha_mean"),
                   table=ctx.state.adapt.alpha_table.clone() if ctx.state.adapt is not None else None)
        self._t = now
        t0 = time.perf_counter()
        if self._snap is not None:
            row["taus"], row["slots_read"] = self._replay(ctx)
        self._snapshot(ctx.state)
        self._torch.cuda.synchronize()
        self._t += time.perf_counter() - t0  # the replay is not the next tick's time
        self.rows.append(row)
        extra = "" if row["tau_mean"] is None else (
            f"  tau_mean {row['tau_mean']:.3f}  alpha_mean {row['alpha_mean']:.6f}")
        if "slots_read" in row:
            extra += f"  taus {row['taus']}  ring slots read {row['slots_read']}"
        log(f"[{self.name}] tick {ctx.step:3d}  loss {row['loss']:.4f}{extra}  {row['ms']:.1f} ms")

    def on_end(self, ctx):
        pass


def lm_pipeline(lr, workers, ring, *, clip=None, fused_apply=False, async_mode=True):
    """The launcher's MindTheStep chain (momentum 0.9) and its AdaptState,
    built on the host; the engine moves the tables to the run's device."""
    from repro_torch.optim import transform as T
    from repro_torch.training import default_adapt_setup

    base = (T.fused_apply(lr, 0.9),) if fused_apply else (T.scale(-lr), T.trace(0.9))
    if clip is not None:
        base = (T.clip_by_global_norm(clip),) + base
    if not async_mode:
        return T.chain(*base), None
    sched, _, adapt = default_adapt_setup(lr, workers, ring, device="cpu")
    link = T.scale_by_staleness(sched, lr, m=workers, tau_max=adapt.tau_max)
    return T.chain(link, *base), adapt


def main_path(cfg, n_expected):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.run import RunSpec, run

    pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING)
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=12, batch_size=4, seq_len=512,
                   num_workers=W_WORKERS, ring=K_RING, ring_dtype="bfloat16", adapt=adapt,
                   fuse=True, refresh_every=5, seed=0, device="cuda")
    hook = TickLog("main", replay=True)
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t0 = time.perf_counter()
    result = run(spec, hooks=[hook])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state = result.state
    n = state.params.numel()
    log(f"[main] N={n} params  ring {tuple(state.delayed.ring.shape)} {state.delayed.ring.dtype}  "
        f"wall {wall:.2f}s  peak memory {peak / 1e9:.2f} GB  launches {counts}")
    check(n == n_expected, f"unexpected parameter count {n}")
    check(all(math.isfinite(r["loss"]) for r in hook.rows), "non-finite loss on the main path")
    check(counts["fused_tick"] == spec.num_steps, f"fused_tick launched {counts['fused_tick']} times")
    check(counts["fused_chain"] == counts["fused_combine"] == counts["fused_update"] == 0,
          "the clip-less fused async tick launched another kernel")
    check(state.adapt.alpha_table.data_ptr() == hook.table_ptr,
          "the refresh replaced the alpha table tensor instead of writing into it")
    check(not torch.equal(hook.rows[4]["table"], hook.rows[3]["table"])
          or not torch.equal(hook.rows[9]["table"], hook.rows[8]["table"]),
          "no refresh changed the alpha table")
    steady = [r["ms"] for r in hook.rows[1:]]
    ring_item = state.delayed.ring.element_size()
    tick_gb = [n * (8 + 4 + 8 + ring_item * (1 + r["slots_read"])) / 1e9 for r in hook.rows]
    log(f"[main] ring slots read per tick {[r['slots_read'] for r in hook.rows]}; tick kernel "
        f"bytes per tick (GB) {[round(b, 3) for b in tick_gb]}, {sum(tick_gb):.2f} GB over "
        f"{len(tick_gb)} ticks, {sum(tick_gb) / HBM_BYTES_PER_S * 1e12:.3f} ms at 3.35 TB/s")
    summary = dict(ticks=spec.num_steps, first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2], peak_gb=peak / 1e9,
                   losses=[r["loss"] for r in hook.rows], launches=counts,
                   slots_read=[r["slots_read"] for r in hook.rows], tick_kernel_gb=tick_gb)
    return summary, counts


def other_paths(cfg):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.run import RunSpec, run

    paths = {
        "sync_fuse": (dict(mode="sync", fuse=True), dict(async_mode=False), ("fused_chain",)),
        "async_fuse_clip": (dict(mode="async", fuse=True), dict(clip=1.0),
                            ("fused_combine", "fused_chain")),
        "async_fused_apply": (dict(mode="async", fuse=False), dict(fused_apply=True),
                              ("fused_update",)),
    }
    out = {}
    for name, (kw, pkw, expect) in paths.items():
        pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING, **pkw)
        spec = RunSpec(cfg=cfg, pipeline=pipe, num_steps=3, batch_size=4, seq_len=512,
                       num_workers=W_WORKERS, ring=K_RING if kw["mode"] == "async" else 0,
                       ring_dtype="bfloat16", adapt=adapt, seed=0, device="cuda", **kw)
        hook = TickLog(name)
        C.reset_launches()
        run(spec, hooks=[hook])
        torch.cuda.synchronize()
        counts = dict(C.LAUNCHES)
        log(f"[{name}] launches {counts}")
        check(all(math.isfinite(r["loss"]) for r in hook.rows), f"non-finite loss on {name}")
        for k in expect:
            check(counts[k] == 3, f"{name}: {k} launched {counts[k]} times, expected 3")
        out[name] = counts
        del spec, hook, pipe, adapt
        free_cuda()
    return out


def small_agreement():
    """Reduced stablelm, 4 fused async ticks: the card (kernels) against the
    CPU (plain versions) on the same params, batches and uniforms."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.run import RunSpec, run
    from repro_torch.training import init_params
    from repro_torch.optim import transform as T

    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, 4)).astype(np.float32)
    finals = {}
    for device in ("cpu", "cuda"):
        it = iter(draws)
        pipe, adapt = lm_pipeline(0.05, 4, 4)
        spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=4, batch_size=2,
                       seq_len=64, num_workers=4, ring=4, adapt=adapt, fuse=True, params=flat,
                       refresh_every=2, seed=0, device=device,
                       tau_source=lambda: torch.from_numpy(next(it)))
        finals[device] = run(spec).state.params.cpu()
    d = (finals["cuda"] - finals["cpu"]).abs().max().item()
    log(f"[agreement] reduced stablelm, 4 fused async ticks: card vs CPU max |dp| = {d:.3e}")
    check(d <= 1e-5, f"card and CPU disagree by {d}")
    return d


# ---------------------------------------------------------------------------
# Phases 5 and 6: serving
# ---------------------------------------------------------------------------

def band_pairs(S, T, causal, window):
    """(query, key) pairs inside the causal / window band — this run's work."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = min(T, q + 1) if causal else T
        total += max(0, hi - lo)
    return total


def band_mask(S, T, causal, window, dev):
    import torch

    q = torch.arange(S, device=dev)[:, None]
    k = torch.arange(T, device=dev)[None, :]
    valid = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        valid &= k <= q
    if window:
        valid &= (q - k) < window
    return valid


def check_flash(B, S, T, Nq, Nkv, H, causal, window, softcap, dtype, dev):
    """Flash kernel vs its plain version; SDPA timed beside it where one call
    computes the same function (no softcap)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as FA

    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, S, Nq, H, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, Nkv, H, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, Nkv, H, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = FA.flash_attention(q, k, v, **kw)
    want = FA.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    # f32: the reference's 3e-5; bf16: one rounding of the output (rtol, atol)
    rtol, atol = (3e-5, 3e-5) if dtype == torch.float32 else (1e-2, 1e-4)
    tol = f"{atol} + {rtol}|plain|"
    bad = int(((out.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum())
    check(bad == 0, f"flash {B, S, T, Nq, Nkv, H, causal, window, softcap, dtype}: "
                    f"{bad} elements past {tol} (max |d| {err})")
    del out, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: FA.attention_ref(q, k, v, **kw), iters=2)
    library_ms = None
    if softcap is None:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            sdpa_kw = dict(is_causal=causal)
        else:
            sdpa_kw = dict(attn_mask=band_mask(S, T, causal, window, dev))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw))
    pairs = band_pairs(S, T, causal, window)
    flops = 4 * H * pairs * B * Nq
    nbytes = q.element_size() * (2 * B * S * Nq * H + 2 * B * T * Nkv * H)
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
    by = "operations" if t_ops >= nbytes / HBM_BYTES_PER_S else "bytes"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=by, flops=flops, bytes=nbytes, tol=tol,
                tflops=flops / ms / 1e9)


def check_rg_lru(B, S, W, dev):
    import torch

    from repro_torch.kernels.rg_lru import cuda as RG

    gen = torch.Generator(device=dev).manual_seed(6)
    log_a = -torch.nn.functional.softplus(torch.randn(B, S, W, generator=gen, device=dev))
    x = torch.randn(B, S, W, generator=gen, device=dev)
    y = RG.rg_lru(log_a, x)
    want = RG.rg_lru_ref(log_a, x)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    check(bool(((y - want).abs() <= 3e-5 + 3e-5 * want.abs()).all()),
          f"rg_lru past 3e-5 (max |d| {err})")
    del y, want
    ms = cuda_ms(lambda: RG.rg_lru(log_a, x), iters=20)
    plain_ms = cuda_ms(lambda: RG.rg_lru_ref(log_a, x), iters=2)
    nbytes = 12 * B * S * W
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes)


def check_selective_scan(B, S, D, N, u_dtype, dev, a_init="model"):
    """The selective-scan kernel against its plain version: y and hT.
    ``a_init``: "model" is the init's A = -(1..N) on every row, "random" A
    drawn per (d, n) as -exp(randn)."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.randn(B, S, D, generator=gen, device=dev).to(u_dtype)
    delta = torch.nn.functional.softplus(torch.randn(B, S, D, generator=gen, device=dev) - 2.0)
    if a_init == "model":
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(D, 1)
    else:
        A = -torch.exp(torch.randn(D, N, generator=gen, device=dev))
    Bm = torch.randn(B, S, N, generator=gen, device=dev)
    Cm = torch.randn(B, S, N, generator=gen, device=dev)
    args = (u, delta, A, Bm, Cm)
    y, hT = SS.selective_scan(*args)
    want_y, want_h = SS.selective_scan_ref(*args)
    torch.cuda.synchronize()
    err = max(float((y - want_y).abs().max()), float((hT - want_h).abs().max()))
    for got, want, what in ((y, want_y, "y"), (hT, want_h, "hT")):
        bad = int(((got - want).abs() > 3e-5 + 3e-5 * want.abs()).sum())
        check(bad == 0, f"selective_scan {B, S, D, N, u_dtype} {what}: {bad} elements past 3e-5 "
                        f"(max |d| {err})")
    if a_init == "random":
        scan_witness(f"{B, S, D, N, u_dtype}", args, y, hT, want_y, want_h)
    del y, hT, want_y, want_h
    ms = cuda_ms(lambda: SS.selective_scan(*args), iters=20)
    plain_ms = cuda_ms(lambda: SS.selective_scan_ref(*args), iters=2)
    nbytes = (u.element_size() + 4 + 4) * B * S * D + 4 * D * N + 8 * B * S * N + 4 * B * D * N
    exps = B * S * D * N
    flops = 6 * exps  # delta*A, the h update (3: mul, mul, add), y (2)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "exponentials": exps / SFU_EXP_PER_S,
             "f32 operations": flops / PEAK_FLOPS["float32"]}
    what = max(times, key=times.get)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=times[what] * 1e3, bound_by="bytes" if what == "bytes" else "operations",
                bound_set_by=what, bound_terms_ms={k: v * 1e3 for k, v in times.items()},
                bytes=nbytes, exps=exps, flops=flops, sm_clock_hz=SM_CLOCK_HZ,
                exps_per_s=exps / (ms * 1e-3))


def scan_witness(tag, args, y, hT, want_y, want_h):
    """The kernel's and the f32 plain version's y and hT, each against the
    plain scan in f64, a witness of the f32 rounding: elements past 3e-5 +
    3e-5 |f64| and the largest |d| / (3e-5 + 3e-5 |f64|).  A reading, not a
    gate: where y cancels, the f32 plain version misses it too."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    exact = dict(zip(("y", "hT"), SS.selective_scan_ref(*args, dtype=torch.float64)))
    parts = []
    for what, got, want in (("y", y, want_y), ("hT", hT, want_h)):
        tol = 3e-5 + 3e-5 * exact[what].abs()
        for who, v in (("kernel", got), ("f32 plain", want)):
            d = (v.double() - exact[what]).abs()
            parts.append(f"{what} {who} {int((d > tol).sum())} past, max |d|/tol "
                         f"{float((d / tol).max()):.3f}")
            del d
    log(f"[witness] selective_scan {tag} against the f64 plain scan: " + "; ".join(parts))


def witness_delta_ranges(dev):
    """``scan_witness`` over 3000 steps with A = -exp(randn) and delta near
    30 (decays underflow, y cancels 16 terms) or log-uniform from 1e-4 to 30,
    as the card test ``test_selective_scan_kernel_holds_over_delta_ranges``."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    B, S, D, N = 1, 3000, 64, 16
    for rng in ("large", "mixed"):
        for u_dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(11)
            u = torch.randn(B, S, D, generator=gen, device=dev).to(u_dtype)
            A = -torch.exp(torch.randn(D, N, generator=gen, device=dev))
            Bm = torch.randn(B, S, N, generator=gen, device=dev)
            Cm = torch.randn(B, S, N, generator=gen, device=dev)
            r = torch.rand(B, S, D, generator=gen, device=dev)
            delta = 20.0 + 10.0 * r if rng == "large" else torch.exp(-9.2 + 12.6 * r)
            args = (u, delta, A, Bm, Cm)
            y, hT = SS.selective_scan(*args)
            scan_witness(f"{B, S, D, N, u_dtype} delta {rng}", args, y, hT,
                         *SS.selective_scan_ref(*args))


def serve_full(arch, batch, prompt, gen, expect):
    """Serve ``arch`` at full width through the launcher, counts zeroed just
    before and read just after; check them against ``expect``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.launch import serve

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    RG.reset_launches()
    SS.reset_launches()
    result = serve.main(["--arch", arch, "--batch", str(batch), "--prompt_len", str(prompt),
                         "--gen", str(gen), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {"flash_attention": FA.LAUNCHES["flash_attention"], "rg_lru": RG.LAUNCHES["rg_lru"],
              "selective_scan": SS.LAUNCHES["selective_scan"]}
    peak = torch.cuda.max_memory_allocated()
    vocab = get_config(arch).vocab_size
    check(bool(torch.isfinite(result["prefill_logits"]).all())
          and bool(torch.isfinite(result["logits"]).all()), f"{arch}: non-finite logits")
    toks = result["tokens"]
    check(tuple(toks.shape) == (batch, gen), f"{arch}: generated ids of shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < vocab)).all()), f"{arch}: generated ids out of range")
    check(counts == expect, f"{arch}: launches {counts}, expected {expect} per prefill")
    row = dict(arch=arch, batch=batch, prompt=prompt, gen=gen, prefill_s=result["prefill_s"],
               decode_ms_per_step=result["decode_s"] / gen * 1e3, tok_per_s=result["tok_per_s"],
               peak_gb=peak / 1e9, launches=counts)
    log(f"[serve] {json.dumps(row)}")
    del result
    free_cuda()
    return row


def serve_agreement(arch):
    """Reduced ``arch`` served on the card (the kernels) against the plain
    CPU path, same params and prompts."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.training import init_params
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=2, seq=160, seed=0)
    want = serve(cfg, params, batch, gen=4)
    got = serve(dataclasses.replace(cfg, use_pallas=True),
                tree_map(lambda t: t.to("cuda"), params),
                {k: v.to("cuda") for k, v in batch.items()}, gen=4)
    d = max(float((got["prefill_logits"].cpu() - want["prefill_logits"]).abs().max()),
            float((got["logits"].cpu() - want["logits"]).abs().max()))
    log(f"[agreement] reduced {arch}, prefill 160 + 4 steps: card vs CPU max |dlogits| "
        f"= {d:.3e}, ids {got['tokens'][0].tolist()}")
    check(d <= 1e-4, f"{arch}: served logits: card and CPU disagree by {d}")
    check(torch.equal(got["tokens"].cpu(), want["tokens"]),
          f"{arch}: served ids differ between card and CPU")
    return d


# ---------------------------------------------------------------------------
# Phase 7: checkpoint and resume on the main path; phase 8: the exact simulator
# ---------------------------------------------------------------------------

def _bits(t):
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(host, dev_leaf):
    """``host`` (a CPU copy) and the card's ``dev_leaf`` hold the same bits,
    compared on the card a chunk at a time."""
    import torch

    if isinstance(dev_leaf, torch.Generator):
        return torch.equal(host, dev_leaf.get_state())
    a, b = host.reshape(-1), dev_leaf.reshape(-1)
    if a.dtype != b.dtype or a.numel() != b.numel():
        return False
    return all(torch.equal(_bits(a[i:i + CHUNK].to(b.device)), _bits(b[i:i + CHUNK]))
               for i in range(0, a.numel(), CHUNK))


def resume_path(cfg, n_expected, ckpt_root):
    """Run A: 6 uninterrupted fused async ticks (refresh every 2) with a
    checkpoint at step 3, whose histogram is partial.  Run B: a fresh
    pipeline and adapt resumed from it at step 3, crossing the step-4
    refresh.  B's losses and every leaf of B's final state must equal A's
    bit for bit, and the host estimators must agree."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import key_paths
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, Hook, RunSpec, run

    class Losses(Hook):
        def __init__(self):
            self.losses, self.t_start = [], None

        def on_start(self, ctx):
            torch.cuda.synchronize()
            self.t_start = time.perf_counter()

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())

    class TimedCheckpoint(CheckpointHook):
        """``CheckpointHook(every=3)`` timed, and stopped after its first save:
        a save at step 6 would write another 34.5 GB that nothing reads."""

        def _save(self, ctx):
            if self.saved_steps:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._save(ctx)
            self.seconds = time.perf_counter() - t0

    def spec():
        pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING)
        return RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=6, batch_size=4,
                       seq_len=512, num_workers=W_WORKERS, ring=K_RING, ring_dtype="bfloat16",
                       adapt=adapt, fuse=True, refresh_every=2, seed=0, device="cuda")

    with tempfile.TemporaryDirectory(dir=ckpt_root) as d:
        free_disk = shutil.disk_usage(d).free
        torch.cuda.reset_peak_memory_stats()
        spec_a, track_a, saver = spec(), Losses(), TimedCheckpoint(d, every=3)
        C.reset_launches()
        res_a = run(spec_a, hooks=[track_a, saver])
        torch.cuda.synchronize()
        launches_a = C.LAUNCHES["fused_tick"]
        check(saver.saved_steps == [3], f"checkpoints at {saver.saved_steps}")
        n = res_a.state.params.numel()
        check(n == n_expected, f"unexpected parameter count {n}")
        files = [f for f in os.listdir(d) if f.startswith("step_00000003")]
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in files)
        hist = np.load(os.path.join(d, "step_00000003.npz"))[".adapt.hist"]
        check(int(hist.sum()) > 0, "the step-3 checkpoint holds no partial histogram")
        # run A's final state leaves the card (34.5 GB beside run B's 46 GB would not fit)
        final_a = {k: (v.get_state() if isinstance(v, torch.Generator) else v.cpu())
                   for k, v in key_paths(res_a.state)}
        est_a = T.staleness_link(spec_a.pipeline).estimator
        del res_a
        free_cuda()

        spec_b, track_b = spec(), Losses()
        C.reset_launches()
        t0 = time.perf_counter()
        res_b = run(spec_b, hooks=[track_b], resume_from=d, resume_step=3)
        restore_s = track_b.t_start - t0
        torch.cuda.synchronize()
        launches_b = C.LAUNCHES["fused_tick"]
        peak = torch.cuda.max_memory_allocated()
        final_b = dict(key_paths(res_b.state))
        check(res_b.start_step == 3, f"resumed at {res_b.start_step}")
        check(track_b.losses == track_a.losses[3:],
              f"resumed losses {track_b.losses} != uninterrupted {track_a.losses[3:]}")
        check(sorted(final_a) == sorted(final_b), "the final states' leaves differ in name")
        differ = [k for k in final_a if not same_bits(final_a[k], final_b[k])]
        check(not differ, f"resumed state differs from the uninterrupted one in {differ}")
        est_b = T.staleness_link(spec_b.pipeline).estimator
        check(est_a.n_seen == est_b.n_seen and np.array_equal(est_a.counts, est_b.counts),
              "the host estimators differ after the resume")
        check(launches_a == 6 and launches_b == 3,
              f"fused_tick launched {launches_a} + {launches_b} times, expected 6 + 3")
        row = dict(n_params=n, leaves=sorted(final_a), checkpoint_gb=ckpt_bytes / 1e9,
                   save_s=saver.seconds, restore_s=restore_s, free_disk_gb=free_disk / 1e9,
                   peak_gb=peak / 1e9, losses=track_a.losses, launches=[launches_a, launches_b],
                   est_n_seen=est_b.n_seen)
        log(f"[resume] full-width stablelm-1.6b, fused async, checkpoint at 3 of 6 (refresh "
            f"every 2): checkpoint {row['checkpoint_gb']:.2f} GB on disk ({free_disk / 1e9:.1f} "
            f"GB free before it), save {saver.seconds:.2f} s, restore {restore_s:.2f} s, peak "
            f"memory {peak / 1e9:.2f} GB; resumed losses {track_b.losses} equal run A's steps "
            f"4-6; {len(final_a)} leaves bitwise equal ({', '.join(sorted(final_a))}); "
            f"estimator n_seen {est_b.n_seen} equal; fused_tick launches {launches_a} + "
            f"{launches_b}")
        del res_b, final_a, final_b
    free_cuda()
    return row


def exact_simulator():
    """The paper's Fig.-3 problem through the exact simulator: a noisy
    quadratic, d 16, m 16, T 3000, the constant table and the eq.-26
    normalised geometric-momentum table, on the card and on the CPU."""
    import numpy as np
    import torch

    from repro_torch.async_engine import simulate_async_sgd, uniform_commit_order
    from repro_torch.core import staleness as S
    from repro_torch.core import step_size as SS

    d, m, T, alpha_c, eps = 16, 16, 3000, 0.05, 1.5
    rng = np.random.default_rng(0)
    batches = (0.3 * rng.standard_normal((T, d))).astype(np.float32)
    eig = np.linspace(0.5, 3.0, d).astype(np.float32)
    order = uniform_commit_order(T, m, seed=3)

    def iters_to(losses):
        idx = np.nonzero(losses < eps)[0]
        return int(idx[0]) if idx.size else T + 1

    def on(device):
        e = torch.from_numpy(eig).to(device)

        def loss(x, b):
            return 0.5 * torch.sum(e * (x - b) ** 2)

        x0 = torch.full((d,), 2.0, device=device)
        bt = torch.from_numpy(batches).to(device)
        probe = simulate_async_sgd(loss, x0, bt, order, np.full(256, alpha_c, np.float32), m)
        pmf = S.empirical_pmf(probe.taus.cpu().numpy(), tau_max=255)
        adaptive = SS.make_schedule("geometric_momentum", alpha_c,
                                    S.Geometric(p=max(float(pmf[0]), 1e-3)), mu_star=0.0,
                                    tau_max=255, normalize_pmf=pmf)
        out = {}
        for name, sched in (("constant", SS.constant(alpha_c, tau_max=255)),
                            ("adaptive", adaptive)):
            tr = simulate_async_sgd(loss, x0, bt, order, sched.table, m)
            out[name] = {k: getattr(tr, k).cpu().numpy()
                         for k in ("params", "taus", "losses", "alphas")}
        return out

    t0 = time.perf_counter()
    card = on("cuda")
    card_s = time.perf_counter() - t0
    cpu = on("cpu")
    row = {"card_s": card_s, "phase_s": time.perf_counter() - t0}
    for name in ("constant", "adaptive"):
        a, b = card[name], cpu[name]
        check(np.array_equal(a["taus"], b["taus"]) and np.array_equal(a["alphas"], b["alphas"]),
              f"exact simulator ({name}): taus or alphas differ between card and CPU")
        for k in ("losses", "params"):
            rel = float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
            check(rel <= 1e-5, f"exact simulator ({name}): {k} differ by {rel:.3e} relative")
            row[f"{name}_{k}_rel"] = rel
        row[f"{name}_iters"] = iters_to(a["losses"])
    check(row["adaptive_iters"] <= row["constant_iters"],
          f"adaptive table reached eps {eps} after {row['adaptive_iters']} commits, "
          f"constant after {row['constant_iters']}")
    log(f"[exact] Fig.-3 quadratic d {d}, m {m}, T {T}: iterations to loss < {eps}: adaptive "
        f"{row['adaptive_iters']}, constant {row['constant_iters']}; card vs CPU taus and alphas "
        f"equal, losses / x within {max(v for k, v in row.items() if k.endswith('_rel')):.3e} "
        f"relative; card {card_s:.2f} s, phase {row['phase_s']:.2f} s")
    return row



# ---------------------------------------------------------------------------
# Phase 9: the sharded async engine; phase 10: the paper's CNN
# ---------------------------------------------------------------------------

SHARDED_W, SHARDED_K = 2, 4


def sharded_setup(lr, W, K, device):
    """The eq.-26 MindTheStep chain (momentum 0.9) and a WorkerAdaptState
    with heterogeneous workers: worker 0 a geometric CDF, worker 1 an
    event-simulator trace, any further ones Poisson CDFs."""
    from repro_torch.async_engine import EventSimConfig, simulate_staleness_trace
    from repro_torch.core.staleness import Geometric, Poisson
    from repro_torch.optim import transform as T
    from repro_torch.training import default_adapt_setup, make_worker_adapt

    sched, _, adapt = default_adapt_setup(lr, W, K, device="cpu")
    samplers = [Geometric(p=1.0 / (1.0 + W)),
                simulate_staleness_trace(EventSimConfig(m=W), num_updates=64, seed=0)]
    samplers += [Poisson(float(W))] * (W - 2)
    wadapt = make_worker_adapt(sched.table[:adapt.tau_max + 1], samplers, cdf_support=K,
                               device=device)
    link = T.scale_by_staleness(sched, lr, m=W, tau_max=adapt.tau_max)
    return T.chain(link, T.scale(-lr), T.trace(0.9)), wadapt


def sharded_path(cfg, n_expected):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.run import Hook, RunSpec, run
    from repro_torch.training import merge_worker_hist

    W, K = SHARDED_W, SHARDED_K
    pipe, adapt = sharded_setup(0.01, W, K, "cpu")
    est = T.staleness_link(pipe).estimator

    class Drains(Hook):
        """Per tick (measurement only, it waits for the device): the merged
        histogram's count; per refresh, the taus the estimator took in."""

        def __init__(self):
            self.hist, self.drained, self._seen = [], [], 0

        def on_refresh(self, ctx):
            self.drained.append(est.n_seen - self._seen)
            self._seen = est.n_seen

        def on_tick(self, ctx):
            self.hist.append(int(merge_worker_hist(ctx.state.adapt).sum()))

    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=6, batch_size=4,
                   seq_len=512, ring=K, ring_dtype="bfloat16", adapt=adapt, fuse=True,
                   refresh_every=3, seed=0, device="cuda")
    hook, drains = TickLog("sharded", workers=W), Drains()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t0 = time.perf_counter()
    result = run(spec, hooks=[hook, drains])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state = result.state
    n = state.params.numel()
    ring = state.delayed.ring
    ring_gb = ring.numel() * ring.element_size() / 1e9
    log(f"[sharded] N={n} params  ring {tuple(ring.shape)} {ring.dtype} ({ring_gb:.2f} GB)  "
        f"wall {wall:.2f}s  peak memory {peak / 1e9:.2f} GB  launches {counts}")
    check(n == n_expected, f"unexpected parameter count {n}")
    check(tuple(ring.shape[:2]) == (W, K), f"ring shape {tuple(ring.shape)}")
    check(all(math.isfinite(r["loss"]) for r in hook.rows), "non-finite loss on the sharded path")
    check(counts["fused_chain"] == spec.num_steps and counts["fused_tick"] == 0,
          f"sharded path launched fused_chain {counts['fused_chain']} and fused_tick "
          f"{counts['fused_tick']} times, expected {spec.num_steps} and 0")
    check(counts["fused_combine"] == counts["fused_update"] == 0,
          "the sharded path launched the combine or update kernel")
    check(state.adapt.alpha_table.data_ptr() == hook.table_ptr,
          "the refresh replaced the alpha table tensor instead of writing into it")
    check(not torch.equal(hook.rows[2]["table"], hook.rows[1]["table"])
          or not torch.equal(hook.rows[5]["table"], hook.rows[4]["table"]),
          "no refresh changed the alpha table")
    check(drains.drained == [W * 3, W * 3],
          f"the refreshes drained {drains.drained} taus, expected {W * 3} each")
    check(drains.hist == [W, 2 * W, 0, W, 2 * W, 0],
          f"merged histogram counts per tick {drains.hist}")
    steady = [r["ms"] for r in hook.rows[1:]]
    summary = dict(ticks=spec.num_steps, first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2], peak_gb=peak / 1e9,
                   ring_gb=ring_gb, losses=[r["loss"] for r in hook.rows], launches=counts,
                   drained=drains.drained)
    log(f"[sharded] losses {summary['losses']}; median tick {summary['median_tick_ms']:.1f} ms "
        f"(first {summary['first_tick_ms']:.1f} ms); refreshes drained {drains.drained} taus")
    return summary, counts


def sharded_agreement(W):
    """Reduced stablelm, 4 fused sharded ticks (refresh every 2): the card
    against the CPU on the same params, batches and uniforms, with an f32
    ring (phase 3's reduced check and tolerance) and, printed, a bf16 one:
    there a 1e-7 difference in a gradient element can flip its bf16
    rounding (2^-8 of it), so the two devices part by up to
    lr x weight x |g| x 2^-8 a tick, which no f32 bound describes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import init_params

    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, W)).astype(np.float32)
    out = {}
    for ring_dtype in (None, "bfloat16"):
        finals = {}
        for device in ("cpu", "cuda"):
            it = iter(draws)
            pipe, adapt = sharded_setup(0.05, W, 4, "cpu")
            spec = RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=4,
                           batch_size=2, seq_len=64, ring=4, ring_dtype=ring_dtype, adapt=adapt,
                           fuse=True, params=flat, refresh_every=2, seed=0, device=device,
                           tau_source=lambda: torch.from_numpy(next(it)))
            s = run(spec).state
            finals[device] = (s.params.cpu(), s.adapt.hist.cpu(), s.adapt.alpha_table.cpu())
        d = (finals["cuda"][0] - finals["cpu"][0]).abs().max().item()
        check(torch.equal(finals["cuda"][1], finals["cpu"][1])
              and torch.equal(finals["cuda"][2], finals["cpu"][2]),
              f"histograms or alpha tables differ between card and CPU (ring {ring_dtype})")
        out[ring_dtype or "float32"] = d
    log(f"[sharded agreement] reduced stablelm, W {W}, 4 fused sharded ticks: card vs CPU "
        f"max |dp| = {out['float32']:.3e} with an f32 ring (gate 1e-5), {out['bfloat16']:.3e} "
        f"with a bf16 ring (not gated); histograms and tables equal")
    check(out["float32"] <= 1e-5, f"card and CPU disagree by {out['float32']}")
    return out


def cnn_agreement():
    """The Fig.-1 CNN at 32x32x3, batch 16, m 16, through the exact simulator
    on the card and on the CPU, over the first 100 commits, in f64 and f32."""
    import numpy as np
    import torch

    from repro_torch.async_engine import simulate_async_sgd
    from repro_torch.experiments.async_vs_sync_cnn import cnn_batches
    from repro_torch.experiments.common import event_order
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.tree import tree_map

    T_, m, alpha = 100, 16, 0.01
    _, order = event_order(m, T_, seed=1)
    params = init_cnn(torch.Generator().manual_seed(0), image=32, device="cpu")
    batches = cnn_batches(T_, 16, 32, "cpu")
    table = np.full(256, alpha, np.float32)
    out, secs = {}, {}
    for dtype in (torch.float64, torch.float32):
        for device in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(device, dtype), params)
            b = {"images": batches["images"].to(device, dtype), "labels": batches["labels"].to(device)}
            t0 = time.perf_counter()
            tr = simulate_async_sgd(cnn_loss, p, b, order, table, m)
            out[dtype, device] = {k: getattr(tr, k).cpu().numpy()
                                  for k in ("taus", "alphas", "losses")}
            secs[dtype, device] = time.perf_counter() - t0

    def rel(a, b):
        return np.abs(a - b) / np.abs(b).max()

    row = {}
    for dtype in (torch.float64, torch.float32):
        a, b = out[dtype, "cuda"], out[dtype, "cpu"]
        check(np.array_equal(a["taus"], b["taus"]) and np.array_equal(a["alphas"], b["alphas"]),
              f"CNN ({dtype}): taus or alphas differ between card and CPU")
        check(np.isfinite(a["losses"]).all(), f"CNN ({dtype}): non-finite loss on the card")
        row[str(dtype).split(".")[-1]] = rel(a["losses"], b["losses"])
    f64, f32 = row["float64"], row["float32"]
    check(f64.max() <= 1e-4, f"CNN f64 losses differ card vs CPU by {f64.max():.3e} relative")
    drift = rel(out[torch.float32, "cpu"]["losses"], out[torch.float64, "cpu"]["losses"])
    past = np.nonzero(drift > 1e-5)[0]
    horizon = int(past[0]) if past.size else T_
    check(horizon > 0 and f32[:horizon].max() <= 1e-4,
          f"CNN f32 losses differ card vs CPU by {f32[:horizon].max():.3e} relative within the "
          f"first {horizon} commits")
    f32_past = np.nonzero(f32 > 1e-4)[0]
    res = dict(commits=T_, alpha=alpha, f64_max_rel=float(f64.max()),
               f32_max_rel_within_horizon=float(f32[:horizon].max()), horizon=horizon,
               f32_max_rel=float(f32.max()),
               f32_first_past_1e4=int(f32_past[0]) if f32_past.size else None,
               seconds={f"{str(k[0]).split('.')[-1]}/{k[1]}": v for k, v in secs.items()},
               commits_per_s={f"{str(k[0]).split('.')[-1]}/{k[1]}": T_ / v for k, v in secs.items()})
    log(f"[cnn] Fig.-1 CNN 32x32x3, batch 16, m 16, alpha {alpha}, {T_} commits: card vs CPU "
        f"taus and alphas equal; f64 losses within {res['f64_max_rel']:.3e} relative; f32 "
        f"within {res['f32_max_rel_within_horizon']:.3e} over the first {horizon} commits (the "
        f"CPU's f32 run leaves its f64 run by 1e-5 at commit {horizon}), {res['f32_max_rel']:.3e} "
        f"over all; commits/s " + ", ".join(f"{k} {v:.1f}" for k, v in res["commits_per_s"].items()))
    return res


def cnn_experiments():
    import torch

    from repro_torch.experiments import async_vs_sync_cnn, convergence

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = convergence.run(T=2500, repeats=1, workers=(16,), device="cuda")
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    convergence.print_table(conv, logger=log)
    row = {k: v for k, v in conv["rows"][0].items() if k != "losses"}
    log(f"[convergence] m 16, T 2500, one repeat, 5 strategies: {conv_s:.2f} s on the card "
        f"({5 * 2500 / conv_s:.1f} commits/s)")
    ex = async_vs_sync_cnn.run(steps=600, device="cuda")
    async_vs_sync_cnn.print_report(ex, logger=log)
    example = {tag: {k: v for k, v in ex[tag].items() if k != "losses"}
               for tag in ("const", "mindthestep")}
    for tag in ("const", "mindthestep"):
        check(math.isfinite(example[tag]["final_smoothed"]), f"CNN example ({tag}): non-finite loss")
    return dict(convergence=row, convergence_s=conv_s, example=example)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.kernels.nvcc import compile_libraries
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.training import param_template

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}  torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build (one nvcc per source, all at once) -----------------------
    t0 = time.perf_counter()
    libs = compile_libraries([C.SOURCE, FA.SOURCE, RG.SOURCE, SS.SOURCE], force=True, verbose=True)
    log(f"[build] nvcc sm_90a {time.perf_counter() - t0:.1f}s -> "
        + ", ".join(str(lib.relative_to(root)) for lib in libs))

    # -- phase 2: each kernel against its plain version, full-width shapes ----
    n = sum(math.prod(shape) for shape, _ in _leaves(param_template(get_config("stablelm-1.6b"))))
    check(n == 1_438_846_976, f"full-width N is {n}")
    results = {}
    for kind in ("sgd", "momentum", "adam"):
        for ring_dtype in (torch.float32, torch.bfloat16):
            r = check_tick(kind, ring_dtype, n, dev)
            tag = f"fused_tick/{kind}/{str(ring_dtype).split('.')[-1]}"
            results[tag] = r
            log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  plain "
                f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bytes'] / 1e9:.2f} GB)")
            free_cuda()
    r = check_tick("momentum", torch.bfloat16, n, dev, nan_dead=True)
    results["fused_tick/momentum/bfloat16/nan-dead-slots"] = r
    log(f"[kernel] fused_tick/momentum/bfloat16 with NaN in dead slots {DEAD_SLOTS}: p and v "
        f"finite, max_abs_err {r['max_abs_err']:.3e} against the plain version")
    free_cuda()
    for kind in ("sgd", "momentum", "adam"):
        r = check_chain(kind, n, dev)
        results[f"fused_chain/{kind}"] = r
        log(f"[kernel] fused_chain/{kind}: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  "
            f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms")
        free_cuda()
    results["fused_combine/bfloat16"] = r = check_combine(n, dev)
    log(f"[kernel] fused_combine/bfloat16: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  "
        f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms")
    free_cuda()
    results["fused_update"] = r = check_update(n, dev)
    log(f"[kernel] fused_update: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  "
        f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms")
    free_cuda()
    log(f"[kernels] all {len(results)} variants hold against their plain versions")

    # -- phase 3: the main path, full width -------------------------------------
    full = get_config("stablelm-1.6b")
    check(full.num_layers == 24 and full.d_model == 2048, "not the full-width config")
    summary, main_counts = main_path(full, n)
    log("[main] " + json.dumps({k: v for k, v in summary.items() if k != "losses"}))
    free_cuda()
    small_agreement()
    free_cuda()

    # -- phase 4: the other kernels through their own paths ---------------------
    path_counts = other_paths(dataclasses.replace(full, num_layers=2))
    free_cuda()

    # -- phase 5: the serving kernels against their plain versions --------------
    flash_shapes = {  # B, S, T, Nq, Nkv, H, causal, window, softcap, dtype
        "flash_attention/recurrentgemma-9b": (4, 4096, 4096, 16, 1, 256, True, 2048, None,
                                              torch.bfloat16),
        "flash_attention/recurrentgemma-9b/f32": (1, 4096, 4096, 16, 1, 256, True, 2048, None,
                                                  torch.float32),
        "flash_attention/stablelm-1.6b": (4, 512, 512, 32, 32, 64, True, None, None,
                                          torch.bfloat16),
        "flash_attention/gemma2-like/causal": (2, 1000, 1000, 32, 16, 128, True, 64, 50.0,
                                               torch.float32),
        "flash_attention/gemma2-like/noncausal": (2, 1000, 1000, 32, 16, 128, False, 64, 50.0,
                                                  torch.float32),
        "flash_attention/gemma2-like/causal/bf16": (2, 1000, 1000, 32, 16, 128, True, 64, 50.0,
                                                    torch.bfloat16),
        "flash_attention/gemma2-like/noncausal/bf16": (2, 1000, 1000, 32, 16, 128, False, 64,
                                                       50.0, torch.bfloat16),
        "flash_attention/s-ne-t/bf16": (1, 77, 150, 4, 4, 256, False, 40, None, torch.bfloat16),
    }
    for tag, shape in flash_shapes.items():
        results[tag] = r = check_flash(*shape, dev)
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']})  "
            f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}: {r['flops'] / 1e9:.1f} GFLOP, {r['bytes'] / 1e6:.1f} MB)  "
            f"{r['tflops']:.1f} TFLOP/s of band work, {100 * r['bound_ms'] / r['ms']:.1f} % of "
            f"the bound  sdpa {lib}")
        free_cuda()
    log("[kernel] flash_attention/recurrentgemma-9b: the earlier CUDA-core bf16 body took "
        "36.978 ms at this shape (PERF.md section 6, row 5; not measured in this run)")
    results["rg_lru"] = r = check_rg_lru(4, 4096, 4096, dev)
    log(f"[kernel] rg_lru: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  plain "
        f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bytes'] / 1e6:.1f} MB)")
    free_cuda()
    scan_shapes = {  # B, S, D, N, u dtype
        "selective_scan/falcon-mamba-7b": (4, 4096, 8192, 16, torch.bfloat16, "model"),
        "selective_scan/falcon-mamba-7b/random-A": (4, 4096, 8192, 16, torch.bfloat16, "random"),
        "selective_scan/odd/f32": (2, 1000, 1000, 16, torch.float32, "model"),
    }
    for tag, (*shape, a_init) in scan_shapes.items():
        results[tag] = r = check_selective_scan(*shape, dev, a_init=a_init)
        terms = ", ".join(f"{k} {v:.3f} ms" for k, v in r["bound_terms_ms"].items())
        log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e} (tol 3e-5 + 3e-5|plain|)  "
            f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms, set "
            f"by the {r['bound_set_by']} ({terms}; SM clock {SM_CLOCK_HZ / 1e9:.2f} GHz)  "
            f"{r['exps_per_s'] / 1e12:.3f} T exponentials/s of the SFU's "
            f"{SFU_EXP_PER_S / 1e12:.3f} T/s ({100 * r['exps_per_s'] / SFU_EXP_PER_S:.1f} %)")
        free_cuda()
    witness_delta_ranges(dev)

    # -- phase 6: serving at full width, through the launcher --------------------
    serving = [
        serve_full("recurrentgemma-9b", 4, 4096, 32,
                   {"flash_attention": 12, "rg_lru": 26, "selective_scan": 0}),
        serve_full("stablelm-1.6b", 4, 512, 32,
                   {"flash_attention": 24, "rg_lru": 0, "selective_scan": 0}),
        serve_full("falcon-mamba-7b", 4, 4096, 32,
                   {"flash_attention": 0, "rg_lru": 0, "selective_scan": 64}),
    ]
    for arch in ("recurrentgemma-9b", "falcon-mamba-7b"):
        serve_agreement(arch)
        free_cuda()

    # -- phase 7: checkpoint and resume on the main path, full width ------------
    (root / "build").mkdir(exist_ok=True)
    resume = resume_path(full, n, root / "build")

    # -- phase 8: the exact simulator on the card against the CPU ----------------
    exact = exact_simulator()

    # -- phase 9: the sharded async engine at full width --------------------------
    free_cuda()
    sharded, sharded_counts = sharded_path(full, n)
    log("[sharded] " + json.dumps({k: v for k, v in sharded.items() if k != "losses"}))
    free_cuda()
    sharded["agreement"] = {W: sharded_agreement(W) for W in (2, 4)}
    free_cuda()

    # -- phase 10: the paper's CNN and its experiments ----------------------------
    cnn = cnn_agreement()
    cnn.update(cnn_experiments())
    free_cuda()

    launches = {
        "fused_tick": ("main", main_counts["fused_tick"]),
        "fused_chain": ("sharded_async (phase 9)", sharded_counts["fused_chain"]),
        "fused_combine": ("async_fuse_clip", path_counts["async_fuse_clip"]["fused_combine"]),
        "fused_update": ("async_fused_apply", path_counts["async_fused_apply"]["fused_update"]),
    }
    on_path = {
        "fused_tick": "fused_tick/momentum/bfloat16",
        "fused_chain": "fused_chain/momentum",
        "fused_combine": "fused_combine/bfloat16",
        "fused_update": "fused_update",
    }
    rg_path = "serve recurrentgemma-9b (one prefill)"
    launches.update({
        "flash_attention": (rg_path, serving[0]["launches"]["flash_attention"]),
        "rg_lru": (rg_path, serving[0]["launches"]["rg_lru"]),
    })
    on_path.update({"flash_attention": "flash_attention/recurrentgemma-9b", "rg_lru": "rg_lru"})
    launches["selective_scan"] = ("serve falcon-mamba-7b (one prefill)",
                                  serving[2]["launches"]["selective_scan"])
    on_path["selective_scan"] = "selective_scan/falcon-mamba-7b"
    kernels = []
    for name, key in on_path.items():
        r = results[key]
        path, count = launches[name]
        check(count > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES.get(name, SOURCE), replaces=REPLACES[name],
            launches=count, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r.get("bound_by", "bytes"),
            bound_set_by=r.get("bound_set_by", r.get("bound_by", "bytes")),
            library_ms=r.get("library_ms"), variant=key, path=path,
        ))
    kernels[[k["name"] for k in kernels].index("fused_chain")]["launches_by_path"] = {
        "sharded_async": sharded_counts["fused_chain"],
        "sync_fuse": path_counts["sync_fuse"]["fused_chain"],
        "async_fuse_clip": path_counts["async_fuse_clip"]["fused_chain"]}
    log(json.dumps({"variants": results, "main": summary, "serving": serving, "resume": resume,
                    "exact": exact, "sharded": sharded, "cnn": cnn}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


if __name__ == "__main__":
    sys.exit(main())
