"""The H100 planner: what one step of an (arch x input shape) costs on a
layout of 1 or 4 cards, without a card (the port's counterpart of the
reference's TPU dry run, ``src/repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --cards 4 --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --small_mesh --out build/dryrun

The reference lowers and compiles the partitioned program and reads XLA's
analyses.  The port has no compiler to ask, so the planner RUNS the step, on
``meta`` tensors (shapes only, nothing allocated), at two depths and
extrapolates every count linearly to the full depth, as the reference's
``--extrapolate`` mode does from depth P and 2P (P = ``cfg.pattern_period``).
The port takes 2P and 3P: its first layer reads the step's arguments where
every later one reads a fresh activation, so the live bytes at depth P carry
a term that later periods do not add, and a line through P and 2P
overstates the peak (by 3 % on a 6-layer reduced stablelm prefill).  From
2P on each period adds the same counts, and the line is exact
(``tests/test_torch_dryrun.py``).  The layers keep the config's stacked
layout (the port loops over layers in Python either way, so nothing is
counted once per loop as XLA counts a scan body).  From each run it reads:

* FLOPs, with ``torch.utils.flop_counter.FlopCounterMode`` (it counts the
  products: matmuls, batched matmuls, convolutions; elementwise work counts
  0), backward included when training;
* HBM bytes: every op's tensor inputs read once and outputs written once,
  with no fusion assumed (views move nothing).  An UPPER BOUND: a fused or
  cached kernel moves less;
* the peak of the bytes held by live tensors (arguments included).

The serving kernels run as planning ops with shape-only bodies: flash
attention counts the FLOPs of its causal / window band (4 H per (query,
key) pair inside the band, per query head: QK^T and PV), which is what the
hand-written kernel computes, not the full square the plain version's
matmuls would show; the selective scan counts its ``y`` contraction (2 N per
(b, t, d)), as FlopCounterMode counts the plain scan's; the RG-LRU is
elementwise (0).  Training plans the trainer's own path, the plain
attention, which computes whole blocks.  The fused optimizer kernels become
one planning op each that updates its operands in place, as the kernels
do: elementwise, so no FLOPs, and no temporaries.

To these the record adds, for the layout: the argument bytes per card from
the sharding specs (:mod:`repro_torch.sharding.specs`), the per-card peak
(arguments per card plus the step's other live bytes split evenly over the
cards, an estimate), whether that fits the card's memory, the collective
bytes the layout implies (:func:`repro_torch.launch.analysis.collective_bytes`)
and the three roofline terms at the H100's figures.  "Fits" holds the
per-card peak to one constant, ``HARDWARE["hbm_bytes"]`` (80 GB), on and off
the card alike; on a card the record also gives the card's own
``total_memory``.  Layouts: ``--cards 1``
(one card), ``--cards 4`` (one node, data 1 x model 4), ``--small_mesh``
(data 2 x model 2).  The reference's ``--multi_pod`` TPU layout has no
counterpart.

The multi-card layouts plan the PORT's layout for every registered arch:
Megatron-style tensor parallelism over ``model`` (heads, d_ff, vocab, the
experts, the Mamba and RG-LRU layers' inner width) and the reference's FSDP
storage over ``data`` (the argument bytes per card from
:func:`~repro_torch.sharding.specs.storage_spec_for`; ``--repl_params``, the
reference's flag, plans the serving layout instead, every weight whole over
``data``), and as collective term the all-reduces and FSDP all-gathers a
port rank runs
(:func:`repro_torch.launch.analysis.port_collective_bytes`, the count its
byte counter is held to); the step's temporaries are split evenly over the
cards (an estimate).  ``--seq_shard_cache``, the reference's flag, plans its
decode layout: an attention cache whose kv heads do not split over
``model``, or of a batch of one row, splits its capacity over ``model`` or
``data`` (:func:`~repro_torch.sharding.specs.capacity_split`), in the
argument bytes per card and, as ``kv_gather`` / ``kv_combine``, in the
collective term.  ``--tag`` appends ``_TAG`` to the record names, and every
record carries the ``spec_options`` it was planned under.  ``--set KEY=VALUE`` overrides a config field, as the
reference's flag does (``--set sequence_parallel=true``: Megatron sequence
parallelism, whose gathers and reduce-scatters over ``model`` the
collective term counts; ``--set moe_weights_stationary=true``: the MoE's
expert stacks over ``model`` x d_ff over ``data``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.analysis import (
    collective_bytes,
    model_flops,
    peak_flops_for,
    port_collective_bytes,
    roofline_terms,
)
from repro_torch.launch.input_specs import specs_for_cfg, step_for_cfg
from repro_torch.launch.mesh import (
    HARDWARE,
    hbm_bytes,
    make_mesh,
    make_production_mesh,
    make_small_mesh,
)
from repro_torch.sharding.specs import (
    auto_spec_for,
    batch_shape_structs,
    leaf_paths,
    local_shape,
    SPEC_OPTIONS,
    storage_spec_for,
)

__all__ = ["SKIPS", "measure_step", "argument_bytes", "plan_extrapolated", "dryrun_extrapolated",
           "plan_run", "plan_serve", "band_pairs", "planning_kernels", "main"]

SKIPS: dict[tuple[str, str], str] = {
    # long_500k needs sub-quadratic attention: pure full-attention archs skip it
    ("codeqwen1.5-7b", "long_500k"): "pure full attention (O(S^2) at 500k)",
    ("stablelm-1.6b", "long_500k"): "pure full attention",
    ("internvl2-2b", "long_500k"): "full-attention LM backbone",
    ("qwen2-moe-a2.7b", "long_500k"): "full attention",
    ("qwen3-moe-235b-a22b", "long_500k"): "full attention",
    ("whisper-large-v3", "long_500k"): "enc-dec, full-attention decoder",
}


# ---------------------------------------------------------------------------
# Counting one run
# ---------------------------------------------------------------------------

def _tensors(tree) -> list[torch.Tensor]:
    return [t for _, t in leaf_paths(tree) if isinstance(t, torch.Tensor)]


class _ByteCounter(TorchDispatchMode):
    """Bytes every op reads and writes, and the peak of live storage bytes.

    Live bytes are tracked per storage (views share their base's); a
    storage counts from the op that creates it until its last tensor dies.
    """

    def __init__(self, args):
        super().__init__()
        self.moved = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list] = {}
        self._seen: set[int] = set()
        for t in _tensors(args):
            self._track(t)
        self.peak = self.live

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen:
            return
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        self._seen.discard(tid)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [a for a in tree_flatten((args, kwargs or {}))[0] if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            in_ids = {id(a) for a in ins}
            self.moved += sum(a.numel() * a.element_size() for a in ins)
            self.moved += sum(o.numel() * o.element_size() for o in outs if id(o) not in in_ids)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out


def measure_step(step, args, *, flop_mapping: dict | None = None) -> dict:
    """Run ``step(*args)`` once on shape-only tensors; return its FLOPs, the
    bytes its ops move (no fusion) and its peak live bytes, arguments
    included."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _ByteCounter(args)
    fc = FlopCounterMode(display=False, custom_mapping=flop_mapping or {})
    with fc, counter:
        out = step(*args)
        del out
    return {"flops": float(fc.get_total_flops()), "hbm_bytes": float(counter.moved),
            "peak_bytes": float(counter.peak)}


_BATCH_LEAVES = ("k", "v", "conv", "h", "logits", "next_token", "tokens", "labels",
                 "prefix_embeds", "enc_embeds")


def argument_bytes(args, mesh, batch: int, cfg=None) -> tuple[int, int]:
    """``(per card, total)`` bytes of the step's argument tensors under the
    layout's specs (a non-tensor leaf, such as a TrainState's generator,
    holds no device memory).  With ``cfg``, the port's layout: parameter
    leaves (and the optimizer state and ring shaped like them) by
    :func:`~repro_torch.sharding.specs.storage_spec_for`."""
    per_card = total = 0
    for path, t in leaf_paths(args):
        if not isinstance(t, torch.Tensor):
            continue
        shape = tuple(t.shape)
        total += math.prod(shape) * t.element_size()
        spec = auto_spec_for(path, shape, mesh, batch)
        if cfg is not None and path.rsplit("/", 1)[-1] not in _BATCH_LEAVES:
            spec = storage_spec_for(path, shape, mesh, cfg)
        per_card += math.prod(local_shape(shape, spec, mesh)) * t.element_size()
    return per_card, total


# ---------------------------------------------------------------------------
# Planning stand-ins of the kernels
# ---------------------------------------------------------------------------

def band_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs inside the causal / window band, queries and keys
    at positions 0.. (the flash kernel's work)."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = np.minimum(T, q + 1) if causal else np.full_like(q, T)
    # reprolint: disable=RL001 — host-side planning arithmetic on numpy ints, no tensor
    return int(np.maximum(0, hi - lo).sum())


_PLAN_OPS: dict = {}


def _plan_ops() -> dict:
    """The planning ops (defined once, on first use): shape-only bodies and
    the FLOP formulas of the kernels they stand for."""
    if _PLAN_OPS:
        return _PLAN_OPS
    lib = "repro_torch_plan"

    @torch.library.custom_op(f"{lib}::flash_attention", mutates_args=())
    def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int) -> torch.Tensor:
        raise RuntimeError("a planning op runs on meta tensors only")

    @flash.register_fake
    def _(q, k, v, causal, window):
        return q.new_empty(q.shape[:3] + (v.shape[3],), dtype=v.dtype)

    @torch.library.custom_op(f"{lib}::selective_scan", mutates_args=())
    def scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        raise RuntimeError("a planning op runs on meta tensors only")

    @scan.register_fake
    def _(u, delta, A, Bm, Cm):
        B, S, D = u.shape
        return (u.new_empty((B, S, D), dtype=torch.float32),
                u.new_empty((B, D, A.shape[1]), dtype=torch.float32))

    @torch.library.custom_op(f"{lib}::rg_lru", mutates_args=())
    def lru(log_a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
        raise RuntimeError("a planning op runs on meta tensors only")

    @lru.register_fake
    def _(log_a, x_in):
        return torch.empty_like(log_a)

    @torch.library.custom_op(f"{lib}::in_place", mutates_args=("writes",))
    def in_place(reads: list[torch.Tensor], writes: list[torch.Tensor]) -> None:
        raise RuntimeError("a planning op runs on meta tensors only")

    @in_place.register_fake
    def _(reads, writes):
        return None

    def _shape(x):
        return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)

    def flash_flops(q, k, v, causal, window, *args, out_shape=None, **kw):
        B, S, Nq, H = _shape(q)
        return B * Nq * band_pairs(S, _shape(k)[1], causal, window or None) * 4 * H

    def scan_flops(u, delta, A, Bm, Cm, *args, out_shape=None, **kw):
        B, S, D = _shape(u)
        return 2 * B * S * D * _shape(A)[1]

    def lru_flops(*args, out_shape=None, **kw):
        return 0

    ops = torch.ops.repro_torch_plan
    _PLAN_OPS.update(
        flash=flash, scan=scan, lru=lru, in_place=in_place,
        mapping={ops.flash_attention: flash_flops, ops.selective_scan: scan_flops,
                 ops.rg_lru: lru_flops})
    return _PLAN_OPS


def _flash_stand_in(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    return _plan_ops()["flash"](q, k, v, bool(causal), int(window or 0))


def _scan_stand_in(u, delta, A, Bm, Cm):
    return _plan_ops()["scan"](u, delta, A, Bm, Cm)


def _lru_stand_in(log_a, x_in):
    return _plan_ops()["lru"](log_a, x_in)


def _optimizer_stand_in(name):
    """A shape-only stand-in for an adaptive_update wrapper: one planning op
    that reads the kernel's operands and writes its outputs in place, as the
    kernel does, with no temporaries (the plain versions would materialise
    the f32 ring).  Its bytes count every operand once as read and the
    written ones once more: an upper bound (the tick writes one ring slot)."""
    from repro_torch.async_engine.delayed import slot_live
    from repro_torch.kernels.adaptive_update.cuda import _family_bufs

    def apply(reads, writes):
        with torch.no_grad():
            _plan_ops()["in_place"]([t for t in reads if isinstance(t, torch.Tensor)],
                                    [t for t in writes if isinstance(t, torch.Tensor)])

    def fused_tick(kind, p, g, bufs, scalars, ring, step, taus, weights):
        fam = list(_family_bufs(kind, bufs))
        apply([p, g, ring, step, taus, weights, *fam], [p, ring, *fam])
        return slot_live(step, taus, ring.shape[0])[1]

    def fused_combine(g, ring, step, taus, weights):
        g_eff = torch.empty_like(g)
        apply([g, ring, step, taus, weights], [g_eff, ring])
        return g_eff, slot_live(step, taus, ring.shape[0])[1]

    def fused_chain(kind, p, g, bufs, scalars):
        fam = list(_family_bufs(kind, bufs))
        apply([p, g, *fam], [p, *fam])

    def fused_update(p, g, v, alpha, mu):
        apply([p, g, v], [p, v])

    return {"fused_tick": fused_tick, "fused_combine": fused_combine,
            "fused_chain": fused_chain, "fused_update": fused_update}[name]


@contextlib.contextmanager
def planning_kernels():
    """Route every kernel wrapper to its planning stand-in for the duration
    (the model modules look the serving wrappers up by name; the fused
    optimizer imports its wrappers at call time)."""
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.models import attention as A
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM

    patches = [(A, "flash_attention", _flash_stand_in), (SSM, "selective_scan", _scan_stand_in),
               (RG, "rg_lru", _lru_stand_in)]
    patches += [(C, n, _optimizer_stand_in(n)) for n in ("fused_tick", "fused_combine",
                                                          "fused_chain", "fused_update")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield _plan_ops()["mapping"]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# Depth extrapolation
# ---------------------------------------------------------------------------

def _reduced_depth(cfg, num_layers: int):
    upd = {"num_layers": num_layers}
    if cfg.is_encoder_decoder:
        upd["num_encoder_layers"] = num_layers
    return dataclasses.replace(cfg, **upd)


def _extrapolate(v1: float, v2: float, L1: int, L2: int, Lf: int) -> float:
    slope = (v2 - v1) / (L2 - L1)
    return max(v1 + slope * (Lf - L1), 0.0)


def plan_extrapolated(cfg, build) -> dict:
    """Run ``build(cfg_L) -> (step, args)`` at depth 2P and 3P and extrapolate
    FLOPs, bytes and peak to ``cfg.num_layers`` (module docstring); exact for
    counts linear in the depth (per-layer costs, plus embeddings and logits
    in the intercept)."""
    P = cfg.pattern_period
    points = []
    t0 = time.perf_counter()
    with planning_kernels() as mapping:
        for L in (2 * P, 3 * P):
            step, args = build(_reduced_depth(cfg, L))
            points.append((L, measure_step(step, args, flop_mapping=mapping)))
    (L1, c1), (L2, c2) = points
    Lf = cfg.num_layers
    out = {k: _extrapolate(c1[k], c2[k], L1, L2, Lf) for k in c1}
    out["plan_s"] = time.perf_counter() - t0
    out["method"] = f"two-point depth extrapolation (L={L1},{L2} -> {Lf}) on meta tensors"
    return out


def _mesh_for(*, cards: int = 4, small_mesh: bool = False):
    if small_mesh:
        return make_small_mesh(device="meta"), "small"
    return make_production_mesh(cards=cards, device="meta"), f"card{cards}"


def _serving(cfg, kind):
    """Serving plans the card's configuration: the launcher sets
    ``use_pallas`` there (the kernels)."""
    return cfg if kind == "train" else dataclasses.replace(cfg, use_pallas=True)


def dryrun_extrapolated(arch: str, shape_name: str, *, cards: int = 4,
                        small_mesh: bool = False, overrides: dict | None = None) -> dict:
    """The record of one (arch, input shape) on the layout; ``overrides``
    replaces config fields (the ``--set`` flag)."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    cfg_full = _serving(dataclasses.replace(get_config(arch), **(overrides or {})), kind)
    mesh, _ = _mesh_for(cards=cards, small_mesh=small_mesh)
    core = plan_extrapolated(
        cfg_full, lambda c: (step_for_cfg(c, shape_name), specs_for_cfg(c, shape_name)))
    with planning_kernels():  # whisper's decode cache runs the encoder
        args = specs_for_cfg(cfg_full, shape_name)
    args_card, args_total = argument_bytes(args, mesh, batch, cfg_full)
    return finish_record(arch, cfg_full, shape_name, mesh, core, args_card, args_total)


def plan_run(spec, mesh=None) -> dict:
    """Plan one tick of a training run as ``run(spec)`` builds it: the state
    is the engine's own shape-only template
    (:meth:`~repro_torch.run.engine.AsyncEngine.build_template`, the same
    constructors as the run) and the step the engine's.  The record's
    argument bytes are the STATE's (the batch is made per tick), on one
    card, or with ``mesh`` (a layout: its sizes are read) one rank's state
    under ``use_sharding_rules``: built from its blocks
    (:func:`~repro_torch.sharding.specs.local_template`), so its flat
    buffers, optimizer state and ring are ``N_local`` long."""
    from repro_torch.run.engine import make_engine

    spec = dataclasses.replace(spec, device="cpu", mesh=None)  # shapes only
    one_card = make_mesh((1, 1), ("data", "model"), device="meta")

    def build(cfg):
        engine = make_engine(dataclasses.replace(spec, cfg=cfg))
        batch = batch_shape_structs(cfg, batch=spec.batch_size, seq=spec.seq_len)
        return engine._make_step(), (engine.build_template(), batch)

    core = plan_extrapolated(spec.cfg, build)
    state = make_engine(spec).build_template()
    args_card, args_total = argument_bytes(state, one_card, spec.batch_size)
    if mesh is not None:
        from repro_torch.sharding.specs import local_template
        from repro_torch.tree import tree_map

        local = tree_map(lambda st: torch.empty(st[0], dtype=st[1], device="meta"),
                         local_template(spec.cfg, mesh))
        rank_state = make_engine(dataclasses.replace(spec, params=local)).build_template()
        args_card = argument_bytes(rank_state, one_card, spec.batch_size)[0]
    return finish_record(spec.cfg.name, spec.cfg, f"run/{spec.mode}", mesh or one_card, core,
                         args_card, args_total, batch=spec.batch_size, seq=spec.seq_len,
                         kind="train")


def plan_serve(cfg, *, batch: int, prompt: int, gen: int) -> dict:
    """Plan a serve as ``launch.serve`` runs it on one card (``use_pallas``,
    the launcher's f32 cache): FLOPs, bytes and peak of the prefill, and as
    argument bytes the state a decode step holds, params and the decode cache
    (``prompt + gen`` positions, behind a vlm's prefix)."""
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg, use_pallas=True)
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    cache_dtype = torch.float32
    n_prefix = cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0
    capacity = n_prefix + prompt + gen

    def build(c):
        def prefill_step(params, batch_d):
            logits, cache = M.prefill(params, batch_d, c, capacity, cache_dtype=cache_dtype)
            return {"logits": logits, "cache": cache}

        return prefill_step, (M.init_model(None, c, "meta"),
                              batch_shape_structs(c, batch=batch, seq=prompt))

    core = plan_extrapolated(cfg, build)
    params = M.init_model(None, cfg, "meta")
    aux = batch_shape_structs(cfg, batch=batch, seq=prompt) if cfg.is_encoder_decoder else None
    with planning_kernels():  # whisper's cache runs the encoder
        cache = M.init_decode_state(params, cfg, batch, capacity, cache_dtype=cache_dtype,
                                    batch=aux)
    args_card, args_total = argument_bytes((params, cache), mesh, batch)
    return finish_record(cfg.name, cfg, "serve/prefill", mesh, core, args_card, args_total,
                         batch=batch, seq=prompt, kind="prefill")


def finish_record(arch, cfg, shape_name, mesh, core: dict, args_card: int,
                  args_total: int, *, batch: int | None = None, seq: int | None = None,
                  kind: str | None = None) -> dict:
    """The planner's record (the reference's keys where they mean the same)."""
    s0, b0, k0 = INPUT_SHAPES[shape_name] if shape_name in INPUT_SHAPES else (None, None, None)
    seq, batch, kind = seq or s0, batch or b0, kind or k0
    n = mesh.devices.size
    card = HARDWARE["hbm_bytes"]
    temp = max(core["peak_bytes"] - args_total, 0.0)
    peak_card = args_card + temp / n
    if n == 1:
        coll = collective_bytes(cfg, kind, batch, seq, mesh)
        layout = "one card: what the port runs"
    else:
        coll = port_collective_bytes(cfg, kind, batch, seq, mesh)
        over_data = ("every weight whole over data" if SPEC_OPTIONS["replicate_params_over_data"]
                     else "FSDP storage over data (weights gathered per layer)")
        layout = ("the port's layout: tensor parallelism over model (heads, d_ff, vocab, "
                  f"experts, the SSM's and RG-LRU's inner width), {over_data}")
    flops_card, bytes_card = core["flops"] / n, core["hbm_bytes"] / n
    terms = roofline_terms(flops_card, bytes_card, coll["total"], num_chips=n,
                           peak_flops=peak_flops_for(cfg.activation_dtype))
    mf = model_flops(cfg, batch=batch, seq=seq, kind=kind)
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": list(mesh.devices.shape), "axes": list(mesh.axis_names),
        "num_chips": n, "seq": seq, "batch": batch, "status": "ok",
        "layout": layout,
        "hardware": HARDWARE["name"],
        "plan_s": core["plan_s"],
        "memory": {
            "argument_bytes": args_card,
            "argument_bytes_total": args_total,
            "temp_bytes": temp,
            "peak_bytes": core["peak_bytes"],
            "peak_bytes_per_card": peak_card,
            "card_bytes": card,
            "device_total_memory": hbm_bytes() if torch.cuda.is_available() else None,
            "fits": bool(peak_card <= card),
        },
        "collectives": coll,
        "cost": {"flops": core["flops"], "hbm_bytes": core["hbm_bytes"],
                 "hbm_bytes_is": "upper bound: every op's inputs and outputs, no fusion",
                 "flops_per_card": flops_card, "hbm_bytes_per_card": bytes_card},
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n,
        "useful_compute_fraction": (mf / n) / flops_card if flops_card else None,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "method": core["method"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="plan every combination")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=4,
                    help="1 card, or one node of 4 (data 1 x model 4)")
    ap.add_argument("--small_mesh", action="store_true", help="data 2 x model 2 (the CI layout)")
    ap.add_argument("--repl_params", action="store_true",
                    help="serving layout: params replicated over data (no FSDP storage)")
    ap.add_argument("--seq_shard_cache", action="store_true",
                    help="decode caches whose kv heads do not split over model, or of a "
                         "batch of one row, split their capacity instead (flash-decode)")
    ap.add_argument("--tag", default="", help="suffix for output record names")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. --set param_dtype=bfloat16 "
                         "--set sequence_parallel=true")
    ap.add_argument("--out", default="build/dryrun", help="output dir for json records")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    old = dict(SPEC_OPTIONS)
    SPEC_OPTIONS.update(replicate_params_over_data=args.repl_params,
                        seq_shard_cache=args.seq_shard_cache)
    try:
        return _plan_all(args)
    finally:
        SPEC_OPTIONS.update(old)


def _parse_overrides(pairs) -> dict:
    """``KEY=VALUE`` strings -> config overrides, as the reference's
    ``--set`` reads them: ``true`` / ``false`` as booleans, then an int, a
    float, else the string."""
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        for kind in (int, float):
            try:
                out[k] = kind(v)
                break
            except ValueError:
                pass
        else:
            out[k] = v
    return out


def _plan_all(args) -> int:
    """Plan the combinations ``args`` names, one JSON record each."""
    os.makedirs(args.out, exist_ok=True)
    combos = ([(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES] if args.all
              else [(args.arch, args.shape)])
    _, mesh_tag = _mesh_for(cards=args.cards, small_mesh=args.small_mesh)
    if args.repl_params:
        mesh_tag += "_repl"
    overrides = _parse_overrides(args.set)
    for key in sorted(overrides):
        mesh_tag += f"_{key}"
    if args.tag:
        mesh_tag += "_" + args.tag

    failures = 0
    for arch, shape in combos:
        tag = f"{arch}_{shape}_{mesh_tag}".replace(".", "_").replace("/", "_")
        out_path = os.path.join(args.out, tag + ".json")
        if (arch, shape) in SKIPS:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag, "status": "skip",
                   "reason": SKIPS[(arch, shape)]}
            print(f"[skip] {arch} x {shape}: {SKIPS[(arch, shape)]}")
        else:
            try:
                rec = dryrun_extrapolated(arch, shape, cards=args.cards,
                                          small_mesh=args.small_mesh, overrides=overrides)
                rec["spec_options"] = dict(SPEC_OPTIONS)
                if overrides:
                    rec["overrides"] = overrides
                r, m = rec["roofline"], rec["memory"]
                print(f"[ok]   {arch} x {shape} ({mesh_tag}): "
                      f"{m['peak_bytes_per_card'] / 1e9:.2f} GB/card "
                      f"({'fits' if m['fits'] else 'does not fit'}) "
                      f"comp {r['t_compute_s']:.3e}s mem {r['t_memory_s']:.3e}s "
                      f"coll {r['t_collective_s']:.3e}s -> {r['dominant']}-bound "
                      f"(planned in {rec['plan_s']:.1f}s)")
            except Exception as e:  # noqa: BLE001 — record the failure and go on
                rec = {"arch": arch, "shape": shape, "mesh": mesh_tag, "status": "fail",
                       "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
                failures += 1
                print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}")
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
