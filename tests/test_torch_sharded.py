"""The sharded async engine of the port (``mode="sharded_async"``: per-worker
rings, heterogeneous samplers, per-worker histograms) against itself and
against the reference, on reduced stablelm-1.6b on the CPU.

Guarantees and tolerances, each with its reason:
* one process, homogeneous workers: the sharded step IS the async step,
  bitwise (params, loss, histogram), fused and unfused — every worker's
  ring holds the same pushes and the combine runs the same ops in the same
  worker order (the port's copy of the reference's
  ``test_sharded_matches_single_shard_trajectory``);
* against the reference's sharded step, tick by tick, with geometric,
  Poisson, CMP and trace workers in one run, fused and unfused, two
  refreshes: the per-worker histograms, ``tau_mean``, ``alpha_mean`` and
  the refreshed alpha tables exactly equal (same uniforms, same f32 tables,
  float64 refit in both); loss to 1e-6 relative and params to 1e-6
  absolute (f32 round-off of matmul order, as tests/test_torch_run.py);
* two gloo processes equal one process within rtol 1e-6, atol 1e-7 (the
  reference's bound for its 2-device mesh: the cross-rank sum changes the
  association of the worker sum), with equal merged histograms;
* resume at step 3 bitwise, fused and unfused;
* the ring ops: the async push now writes in place (same storage, same
  results as the old copying push), and the worker combine equals the
  reference's on bridged rings, ring bits included.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.async_engine import delayed as JD
from repro.async_engine.events import EventSimConfig as JEventSimConfig
from repro.async_engine.events import simulate_staleness_trace as j_trace
from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import staleness as JS
from repro.core.step_size import make_schedule as j_make_schedule
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro.run.hooks import Hook as JHook
from repro.training import adapt as JA
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.async_engine import delayed as TD
from repro_torch.async_engine.events import EventSimConfig, simulate_staleness_trace
from repro_torch.checkpoint import key_paths
from repro_torch.configs import get_config, reduced
from repro_torch.core import staleness as TS
from repro_torch.core.step_size import make_schedule
from repro_torch.data import make_batch_for
from repro_torch.launch.mesh import make_workers_mesh
from repro_torch.optim import transform as T
from repro_torch.run import CheckpointHook, Hook, RunSpec, run
from repro_torch.training import adapt as TA
from repro_torch.training import (
    init_sharded_async_state,
    make_adapt,
    make_sharded_async_train_step,
    make_step,
    make_worker_adapt,
)
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, K, LR, STEPS, TAU_MAX = 4, 8, 0.05, 6, 31


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("stablelm-1.6b"), d_model=64)


def _samplers(S, trace_fn, cfg_cls):
    """One worker of each family: geometric, Poisson, CMP and a replayed
    event-simulator trace."""
    trace = trace_fn(cfg_cls(m=W, jitter=0.01), num_updates=48, seed=3)
    return [S.Geometric(0.3), S.Poisson(5.0), S.CMP.from_mode(W, 0.8), trace]


def _flat(p):
    return p.detach().clone() if isinstance(p, torch.Tensor) else T.pack_flat(p)


class _TRec(Hook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m, s = ctx.metrics, ctx.state
        self.rows.append(dict(
            loss=m["loss"].item(), tau=m["tau_mean"].item(), alpha=m["alpha_mean"].item(),
            p=_flat(s.params).numpy(), hist=s.adapt.hist.numpy().copy(),
            table=s.adapt.alpha_table.numpy().copy(),
        ))


class _JRec(JHook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m, s = ctx.metrics, ctx.state
        p = s.params if isinstance(s.params, jax.Array) else ravel_pytree(s.params)[0]
        self.rows.append(dict(
            loss=float(m["loss"]), tau=float(m["tau_mean"]), alpha=float(m["alpha_mean"]),
            p=np.array(p), hist=np.array(s.adapt.hist), table=np.array(s.adapt.alpha_table),
        ))


# ---------------------------------------------------------------------------
# One process: the sharded step is the async step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [False, True])
def test_sharded_matches_async_bitwise(cfg, fuse):
    model = TS.Poisson(4.0)
    sched = make_schedule("poisson_momentum", LR, model, K=LR, tau_max=TAU_MAX)
    a1 = make_adapt(sched, model, cdf_support=K, tau_max=TAU_MAX)
    a2 = make_worker_adapt(sched.table[:TAU_MAX + 1], [model] * W, cdf_support=K)
    # homogeneous workers share the single-shard sampler CDF row for row
    assert torch.equal(a1.tau_cdf, a2.tau_cdf[0])
    runs = {}
    for mode, adapt in (("async", a1), ("sharded_async", a2)):
        pipe = T.chain(T.scale_by_staleness(sched, LR), T.scale(-LR), T.trace(0.9))
        rec = _TRec()
        res = run(RunSpec(cfg=cfg, pipeline=pipe, mode=mode, num_steps=8, batch_size=2,
                          seq_len=16, num_workers=W, ring=K, adapt=adapt, fuse=fuse, seed=0,
                          device="cpu"), hooks=[rec])
        runs[mode] = (rec.rows, res.state)
    (r1, s1), (r2, s2) = runs["async"], runs["sharded_async"]
    for t, (a, b) in enumerate(zip(r1, r2)):
        assert a["loss"] == b["loss"], f"loss diverged at step {t}"
        np.testing.assert_array_equal(a["p"], b["p"], err_msg=f"step {t}")
        assert a["tau"] == b["tau"]
    # the per-worker histograms merge to the single-shard histogram
    assert torch.equal(TA.merge_worker_hist(s2.adapt), s1.adapt.hist)
    assert isinstance(s2.delayed.ring, torch.Tensor) == fuse
    assert {tuple(r.shape[:2]) for r in tree_leaves(s2.delayed.ring)} == {(W, K)}
    assert int(s2.delayed.step) == 8


def test_sharded_shim_is_make_step(cfg):
    sched = make_schedule("constant", LR, tau_max=TAU_MAX)
    pipe = T.chain(T.scale_by_staleness(sched, LR), T.scale(-LR))
    steps = (make_sharded_async_train_step(cfg, pipe, alpha_c=LR),
             make_step(cfg, pipe, mode="sharded_async", alpha_c=LR))
    states = [init_sharded_async_state(
        cfg, pipe, ring=K, device="cpu",
        adapt=make_worker_adapt(sched.table, [TS.Poisson(3.0)] * W, cdf_support=K))
        for _ in steps]
    batch = make_batch_for(cfg, batch=2, seq=16, seed=0, device="cpu")
    for _ in range(3):
        out = [step(state, batch) for step, state in zip(steps, states)]
        states = [o[0] for o in out]
        assert out[0][1]["loss"].item() == out[1][1]["loss"].item()
    assert torch.equal(T.pack_flat(states[0].params), T.pack_flat(states[1].params))
    assert torch.equal(states[0].adapt.hist, states[1].adapt.hist)
    assert int(states[0].adapt.hist.sum()) == 3 * W


# ---------------------------------------------------------------------------
# Against the reference's sharded step, tick by tick
# ---------------------------------------------------------------------------

def _reference_draws(steps):
    """The reference's uniforms: state.rng = split(PRNGKey(0))[1]; per tick
    rng, sub = split(rng); u = uniform(sub, (W,))."""
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    draws = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    return draws


@pytest.fixture(scope="module", params=[False, True], ids=["unfused", "fused"])
def vs_reference(request):
    fuse = request.param
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    model = JS.Poisson(4.0)
    sched = j_make_schedule("poisson_momentum", LR, model, K=LR, tau_max=TAU_MAX)
    adapt = JA.make_worker_adapt(sched.table[:TAU_MAX + 1],
                                 _samplers(JS, j_trace, JEventSimConfig), cdf_support=K)
    pipe = JT.chain(JT.scale_by_staleness(sched, LR, m=W, tau_max=TAU_MAX),
                    JT.scale(-LR), JT.trace(0.9))
    jrec = _JRec()
    j_run(JSpec(cfg=jcfg, pipeline=pipe, mode="sharded_async", num_steps=STEPS, batch_size=2,
                seq_len=16, ring=K, adapt=adapt, fuse=fuse, refresh_every=3, params=params,
                seed=0), hooks=[jrec])

    tcfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    tmodel = TS.Poisson(4.0)
    tsched = make_schedule("poisson_momentum", LR, tmodel, K=LR, tau_max=TAU_MAX)
    tadapt = make_worker_adapt(tsched.table[:TAU_MAX + 1],
                               _samplers(TS, simulate_staleness_trace, EventSimConfig),
                               cdf_support=K)
    np.testing.assert_array_equal(tadapt.tau_cdf.numpy(), np.asarray(adapt.tau_cdf))
    np.testing.assert_array_equal(tadapt.tau_trace.numpy(), np.asarray(adapt.tau_trace))
    tpipe = T.chain(T.scale_by_staleness(tsched, LR, m=W, tau_max=TAU_MAX),
                    T.scale(-LR), T.trace(0.9))
    it = iter(_reference_draws(STEPS))
    trec = _TRec()
    run(RunSpec(cfg=tcfg, pipeline=tpipe, mode="sharded_async", num_steps=STEPS, batch_size=2,
                seq_len=16, ring=K, adapt=tadapt, fuse=fuse, refresh_every=3, params=flat,
                seed=0, device="cpu", tau_source=lambda: torch.from_numpy(next(it))),
        hooks=[trec])
    return jrec.rows, trec.rows


def test_sharded_matches_reference_tick_by_tick(vs_reference):
    jrows, trows = vs_reference
    assert len(jrows) == len(trows) == STEPS
    for i, (a, b) in enumerate(zip(jrows, trows)):
        np.testing.assert_array_equal(b["hist"], a["hist"], err_msg=f"tick {i + 1}")
        assert a["tau"] == b["tau"] and a["alpha"] == b["alpha"], f"tick {i + 1}"
        np.testing.assert_array_equal(b["table"], a["table"], err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6, err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-6, err_msg=f"tick {i + 1}")
    # the trace worker replayed its trace, and the refreshes changed the table
    assert trows[1]["hist"][3].sum() == 2
    assert not np.array_equal(trows[0]["table"], trows[-1]["table"])
    assert np.abs(trows[-1]["p"] - trows[0]["p"]).max() > 1e-3


def test_worker_sampler_tables_and_draws_match_reference():
    trace = np.asarray([1, 2, 3], np.int64)
    jt = JA.worker_sampler_tables([JS.Geometric(0.5), trace, JS.Poisson(2.0)], support=8)
    tt = TA.worker_sampler_tables([TS.Geometric(0.5), trace, TS.Poisson(2.0)], support=8)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tt[0].shape == (3, 8) and tt[1].shape == (3, 3)
    np.testing.assert_array_equal(tt[2], [0, 1, 0])
    u = np.random.default_rng(0).random(3).astype(np.float32)
    for step in range(5):
        jtaus = JA.sample_worker_taus(jnp.asarray(u), *(jnp.asarray(x) for x in jt), jnp.int32(step))
        ttaus = TA.sample_worker_taus(torch.from_numpy(u), *(torch.from_numpy(x) for x in tt),
                                      torch.tensor(step, dtype=torch.int32))
        np.testing.assert_array_equal(ttaus.numpy(), np.asarray(jtaus))
        assert ttaus[1] == trace[step % 3]
    hist = torch.zeros((3, 6), dtype=torch.int32)
    TA.record_worker_taus(hist, torch.tensor([0, 9, 2], dtype=torch.int32))
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(JA.record_worker_taus(jnp.zeros((3, 6), jnp.int32),
                                                       jnp.asarray([0, 9, 2], jnp.int32))))


def test_worker_host_refresh_matches_reference():
    """Same merged counts -> the same refit table, in f32, in place."""
    from repro.optim import mindthestep as j_mindthestep
    from repro.optim import sgd as j_sgd

    counts = np.random.default_rng(1).integers(0, 5, size=(W, TAU_MAX + 1)).astype(np.int32)
    jsched = j_make_schedule("constant", LR, tau_max=TAU_MAX)
    jadapt = JA.make_worker_adapt(jsched.table, [JS.Poisson(3.0)] * W, cdf_support=K)
    jadapt = JA.WorkerAdaptState(jadapt.alpha_table, jadapt.tau_cdf, jadapt.tau_trace,
                                 jadapt.use_trace, jnp.asarray(counts))
    jmts = j_mindthestep(j_sgd(LR), jsched, LR, m=W, tau_max=TAU_MAX)
    jnew = JA.worker_host_refresh(jadapt, jmts, logger=None)

    tsched = make_schedule("constant", LR, tau_max=TAU_MAX)
    link = T.scale_by_staleness(tsched, LR, m=W, tau_max=TAU_MAX)
    tadapt = bridge.worker_adapt_from_jax(*(np.asarray(x) for x in (
        jadapt.alpha_table, jadapt.tau_cdf, jadapt.tau_trace, jadapt.use_trace, jadapt.hist)))
    ptr = tadapt.alpha_table.data_ptr()
    np.testing.assert_array_equal(TA.merge_worker_hist(tadapt).numpy(), counts.sum(axis=0))
    out = TA.worker_host_refresh(tadapt, link, logger=None)
    assert out is tadapt and tadapt.alpha_table.data_ptr() == ptr
    np.testing.assert_array_equal(tadapt.alpha_table.numpy(), np.asarray(jnew.alpha_table))
    assert int(tadapt.hist.sum()) == 0 and link.estimator.n_seen == counts.sum()
    assert not np.array_equal(tadapt.alpha_table.numpy(), np.asarray(jadapt.alpha_table))


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------

def _old_combine(ring, g, step, taus, weights):
    """The async combine as it was: a copying push, a (W, N) gather and an
    f32 copy of each row."""
    Kr = ring.shape[0]
    src = step - taus
    live = ((src >= 0) & (taus < Kr)).to(torch.float32)
    w = weights * live
    ring = ring.index_copy(0, torch.remainder(step, Kr).reshape(1).long(),
                           g.to(ring.dtype).unsqueeze(0))
    rows = ring.index_select(0, torch.remainder(src, Kr).long())
    acc = w[0] * rows[0].to(torch.float32)
    for i in range(1, rows.shape[0]):
        acc = acc + w[i] * rows[i].to(torch.float32)
    return acc, live, ring


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_push_is_in_place_and_combine_unchanged(dtype):
    gen = torch.Generator().manual_seed(0)
    ring = torch.randn((K, 1001), generator=gen).to(dtype)
    g = torch.randn(1001, generator=gen)
    taus = torch.tensor([0, 3, 9, 3, 7], dtype=torch.int32)
    weights = torch.rand(5, generator=gen)
    step = torch.tensor(11, dtype=torch.int32)
    want_g, want_live, want_ring = _old_combine(ring.clone(), g, step, taus, weights)
    ptr = ring.data_ptr()
    got_g, got_live, new = TD.delayed_combine(TD.DelayedGradients(ring=ring, step=step), g, taus,
                                              weights)
    assert new.ring is ring and ring.data_ptr() == ptr and int(new.step) == 12
    assert torch.equal(got_g, want_g) and torch.equal(got_live, want_live)
    assert torch.equal(ring.view(torch.uint8), want_ring.view(torch.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_worker_ring_combine_matches_reference(dtype):
    rng = np.random.default_rng(2)
    Wl, Kr, n, step = 3, 4, 257, 6
    ring = rng.standard_normal((Wl, Kr, n)).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    taus = np.asarray([0, 2, 5], np.int32)  # worker 2 is dead (tau >= K)
    weights = rng.random(Wl).astype(np.float32)
    jring = jnp.asarray(ring).astype(getattr(jnp, dtype))
    jg, jlive, jnew = JD.worker_ring_combine(jring, jnp.int32(step), jnp.asarray(g),
                                             jnp.asarray(taus), jnp.asarray(weights))
    tr = bridge.worker_ring_from_jax(np.asarray(jring), step)
    other = tr.ring[:, [k for k in range(Kr) if k != step % Kr]].clone()
    ptr = tr.ring.data_ptr()
    tg, tlive, tnew = TD.worker_ring_combine(tr.ring, tr.step, torch.from_numpy(g),
                                             torch.from_numpy(taus), torch.from_numpy(weights))
    assert tnew is tr.ring and tnew.data_ptr() == ptr
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tnew.view(torch.uint8).numpy(),
                                  bridge.to_torch(np.asarray(jnew)).view(torch.uint8).numpy())
    # the push touched only slot step % K
    assert torch.equal(tnew[:, [k for k in range(Kr) if k != step % Kr]], other)


def test_worker_ring_bridge_keeps_layout(cfg):
    """The reference's per-leaf and flat worker rings cross with their
    names, shapes and bf16 bits."""
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    jr = JD.init_worker_ring(params, 2, 3, dtype=jnp.bfloat16)
    jr = JD.WorkerRing(ring=jax.tree.map(lambda r: r + jnp.bfloat16(1.5), jr.ring), step=jr.step)
    keys, leaves, _ = _flatten_with_keys(jr.ring)
    tr = bridge.worker_ring_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, 5, cfg)
    assert int(tr.step) == 5
    got = dict(key_paths(tr.ring))
    assert sorted(got) == sorted(keys)
    for k, v in zip(keys, leaves):
        assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == v.shape
        assert v.shape[:2] == (3, 2) and float(got[k].float().mean()) == 1.5
    jflat = JD.init_flat_worker_ring(params, 2, 3).ring
    flat = bridge.worker_ring_from_jax(np.asarray(jflat), 0)
    assert flat.ring.dtype == torch.float32 and tuple(flat.ring.shape) == jflat.shape
    with pytest.raises(ValueError, match="missing"):
        bridge.worker_ring_from_jax({keys[0]: np.asarray(leaves[0])}, 0, cfg)


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------

def _resume_spec(cfg, fuse):
    sched = make_schedule("poisson_momentum", LR, TS.Poisson(3.0), K=1.0, tau_max=TAU_MAX)
    adapt = make_worker_adapt(sched.table[:TAU_MAX + 1],
                              [TS.Geometric(0.4), TS.Poisson(2.0), TS.CMP.from_mode(W, 1.2),
                               np.arange(7) % 5], cdf_support=K)
    pipe = T.chain(T.scale_by_staleness(sched, LR, m=W, tau_max=TAU_MAX), T.scale(-LR),
                   T.trace(0.9))
    return RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=6, batch_size=2,
                   seq_len=16, ring=K, adapt=adapt, fuse=fuse, refresh_every=2, seed=0,
                   device="cpu")


def _bits(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return leaf.reshape(-1).view(torch.uint8).clone()


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_tick(self, ctx):
        self.losses.append(ctx.metrics["loss"].item())


@pytest.mark.parametrize("fuse", [False, True])
def test_sharded_resume_is_bit_identical(cfg, tmp_path, fuse):
    spec_a, track_a = _resume_spec(cfg, fuse), _Losses()
    res_a = run(spec_a, hooks=[track_a, CheckpointHook(str(tmp_path), every=3)])
    spec_b, track_b = _resume_spec(cfg, fuse), _Losses()
    res_b = run(spec_b, hooks=[track_b], resume_from=str(tmp_path), resume_step=3)
    assert res_b.start_step == 3
    assert track_b.losses == track_a.losses[3:]
    final_a = {k: _bits(v) for k, v in key_paths(res_a.state)}
    final_b = {k: _bits(v) for k, v in key_paths(res_b.state)}
    assert {".adapt.tau_trace", ".adapt.use_trace", ".delayed.step"} <= set(final_a)
    assert list(final_a) == list(final_b)
    assert [k for k in final_a if not torch.equal(final_a[k], final_b[k])] == []
    est_a = T.staleness_link(spec_a.pipeline).estimator
    est_b = T.staleness_link(spec_b.pipeline).estimator
    assert est_a.n_seen == est_b.n_seen == 6 * W
    np.testing.assert_array_equal(est_a.counts, est_b.counts)


# ---------------------------------------------------------------------------
# Two gloo processes against one
# ---------------------------------------------------------------------------

_GLOO = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import staleness as S
    from repro_torch.core.step_size import make_schedule
    from repro_torch.launch.mesh import make_workers_mesh
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import make_worker_adapt, merge_worker_hist
    from repro_torch.tree import tree_leaves


    def one_run(mesh, fuse):
        cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
        sched = make_schedule("constant", 0.05, tau_max=31)
        adapt = make_worker_adapt(sched.table, [S.Geometric(0.3), S.Geometric(0.6),
                                                S.Poisson(2.0), S.Poisson(5.0)], cdf_support=8)
        pipe = T.chain(T.scale_by_staleness(sched, 0.05, m=4, tau_max=31), T.scale(-0.05),
                       T.trace(0.9))
        res = run(RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=5,
                          batch_size=2, seq_len=16, ring=8, adapt=adapt, fuse=fuse,
                          refresh_every=3, seed=0, device="cpu", mesh=mesh))
        p = res.state.params
        p = p if isinstance(p, torch.Tensor) else T.pack_flat(p)
        return {"p": p.numpy(), "hist": merge_worker_hist(res.state.adapt, mesh.group).numpy(),
                "table": res.state.adapt.alpha_table.numpy(),
                "w_local": [r.shape[0] for r in tree_leaves(res.state.delayed.ring)]}


    def worker(rank, store, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
        mesh = make_workers_mesh(2, device="cpu")
        assert mesh.local_workers(4) == (2 * rank, 2 * rank + 2)
        res = {f: one_run(mesh, f) for f in (False, True)}
        if rank == 0:
            np.savez(out, **{f"{k}_{f}": np.asarray(v) for f, r in res.items()
                             for k, v in r.items()})
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        torch.multiprocessing.spawn(worker, args=(sys.argv[1] + "/store", sys.argv[1] + "/out.npz"),
                                    nprocs=2, join=True)
        print("OK 2 gloo processes")
''')


def test_two_gloo_processes_match_one(cfg, tmp_path):
    script = tmp_path / "gloo_sharded.py"
    script.write_text(_GLOO)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK 2 gloo processes" in proc.stdout
    two = np.load(tmp_path / "out.npz")
    sys.path.insert(0, str(tmp_path))
    try:
        import gloo_sharded
    finally:
        sys.path.remove(str(tmp_path))
    mesh = make_workers_mesh(device="cpu")
    assert mesh.group is None and mesh.world_size == 1
    for fuse in (False, True):
        one = gloo_sharded.one_run(mesh, fuse)
        np.testing.assert_allclose(two[f"p_{fuse}"], one["p"], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(two[f"hist_{fuse}"], one["hist"])
        assert one["hist"].sum() == 2 * 4  # ticks 4-5 after the refresh at 3
        np.testing.assert_array_equal(two[f"table_{fuse}"], one["table"])
        # each of the 2 ranks held the rings of its 2 workers
        assert set(two[f"w_local_{fuse}"]) == {2} and set(one["w_local"]) == {4}
