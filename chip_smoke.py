#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package, and fails
(non-zero exit, no result line) without a card or outside a checkout.

Phases, each fatal on failure:

1. build — ``nvcc`` compiles ``csrc/adaptive_update.cu`` for sm_90a.
2. kernels — every kernel's wrapper against its plain PyTorch version on the
   card, at the full-width shapes of stablelm-1.6b (N = 1,438,846,976 f32
   params, K = 8 ring slots, W = 8 workers): the tick for sgd / momentum /
   adam with f32 and bf16 rings, the chain, the combine and fused_update.
   Tolerance |kernel - plain| <= 1e-6 + 1e-6 |plain| (1e-5 with a bf16 ring:
   the slot-folded sum differs from the worker-by-worker one in rounding);
   the ring's bits and the live mask exactly equal.  Prints each kernel's
   time, the plain version's, the byte bound at 3.35 TB/s and the errors.
3. main path — ``run(RunSpec(mode="async", fuse=True, ...))`` on full-width
   stablelm-1.6b (24 layers, momentum, W = 8, ring 8 in bf16, batch 4 x seq
   512, refresh every 5) for 12 ticks, launch counts zeroed just before and
   read just after; checks finite losses, one fused_tick launch per tick, a
   refresh that rewrote the alpha table in place, and prints peak memory.
   Then the same fused async run on reduced stablelm on the card against the
   plain CPU path on the same params, batches and uniforms.
4. other paths — sync (fused_chain), clip (fused_combine + fused_chain) and
   ``fused_apply`` (fused_update) at full width and 2 layers, each with its
   counts zeroed before and read after.

The line before the last is one JSON object with every kernel (launches,
max_abs_err, ms, plain_ms, bound_ms, ...); the one before it the card's name
and power limit; the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SOURCE = "src/repro_torch/kernels/adaptive_update/csrc/adaptive_update.cu"
REPLACES = {
    "fused_tick": "src/repro/kernels/adaptive_update/fused.py:301",
    "fused_chain": "src/repro/kernels/adaptive_update/fused.py:137",
    "fused_combine": "src/repro/kernels/adaptive_update/fused.py:349",
    "fused_update": "src/repro/kernels/adaptive_update/kernel.py:46",
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


def check_tick(kind, ring_dtype, n, dev):
    """Tick kernel vs plain at full width; returns the numbers for the JSON."""
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    bufs = make_state(kind, n, gen, dev)
    ring = torch.randn(K_RING, n, generator=gen, device=dev, dtype=ring_dtype)
    step = torch.tensor(STEP, dtype=torch.int32, device=dev)
    taus = torch.tensor(TAUS, dtype=torch.int32, device=dev)
    weights = torch.rand(W_WORKERS, generator=gen, device=dev) + 0.1
    s = kernel_scalars(kind)
    p0, bufs0 = stash(p), [stash(b) for b in state_list(kind, bufs)]
    sums0 = slot_checksums(ring)
    live = C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights)
    torch.cuda.synchronize()
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
    ms = cuda_ms(lambda: C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights))
    item = ring.element_size()
    nbytes = tick_bytes(kind, n, item, STEP, TAUS, weights.tolist(), K_RING)
    # what this simple kernel moves: it reads every non-pushed slot, dead or not
    moved = n * (12 + 8 * len(state_list(kind, bufs)) + item * K_RING)
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, kernel_bytes=moved)


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
    """Per-tick host line (synchronizes to time each tick: measurement only)."""

    def __init__(self, name):
        import torch

        self.name, self.rows, self._torch = name, [], torch
        self._t = None

    def on_start(self, ctx):
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
        self.rows.append(row)
        extra = "" if row["tau_mean"] is None else (
            f"  tau_mean {row['tau_mean']:.3f}  alpha_mean {row['alpha_mean']:.6f}")
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
    hook = TickLog("main")
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
    summary = dict(ticks=spec.num_steps, first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2], peak_gb=peak / 1e9,
                   losses=[r["loss"] for r in hook.rows], launches=counts)
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
    from repro_torch.training import param_template

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}  torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    C.build_library(force=True)
    log(f"[build] nvcc sm_90a {time.perf_counter() - t0:.1f}s -> {C.LIBRARY.relative_to(root)}")

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

    launches = {
        "fused_tick": ("main", main_counts["fused_tick"]),
        "fused_chain": ("sync_fuse", path_counts["sync_fuse"]["fused_chain"]),
        "fused_combine": ("async_fuse_clip", path_counts["async_fuse_clip"]["fused_combine"]),
        "fused_update": ("async_fused_apply", path_counts["async_fused_apply"]["fused_update"]),
    }
    on_path = {
        "fused_tick": "fused_tick/momentum/bfloat16",
        "fused_chain": "fused_chain/momentum",
        "fused_combine": "fused_combine/bfloat16",
        "fused_update": "fused_update",
    }
    kernels = []
    for name, key in on_path.items():
        r = results[key]
        path, count = launches[name]
        check(count > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name], launches=count,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=None, variant=key, path=path,
        ))
    log(json.dumps({"variants": {k: {kk: vv for kk, vv in v.items()} for k, v in results.items()},
                    "main": summary}))
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
