"""The port's live parameter server (``repro_torch.distributed``) on the CPU,
mirroring tests/test_distributed.py and held to the reference where the two
can be compared.

* faults and transports — ``parse_faults`` gives the reference's fields on
  the same strings and refuses the same garbage with the same messages; the
  injector's ``after`` / ``count`` scoping; the registry; the in-process
  fabric's FIFO order, rpc routing, EOF on close and bounded-queue
  backpressure (shown with events, not sleeps);
* staleness stamping — a scripted interleaving gives taus ``[0, 1, 0]``;
  a worker's pulled params stay the version stamped on its pull after later
  applies, and a snapshot stays the state of its step (the server writes no
  tensor it has handed out); a W = 1 live run equals the port's serial
  pull/grad/apply loop bitwise and the reference's W = 1 run within 1e-6 of
  max |p|, on the same bridged params and numpy batches;
* ``run()`` with ``mode="distributed"`` — hooks and a trace, refresh inside
  the server, a checkpoint taken during a live run equal to the state of its
  step, checkpoint/resume extending the server state and the trace, abort
  leaving a salvageable ``.part``;
* faults — count-driven only: each kind injected into a live run, which
  completes; every time, the applies equal the batches submitted plus one
  per fired ``drop_reply``, each trace record's tau equals the version at
  its push less the version stamped at its pull, and the final params are
  finite;
* sockets — one run with two spawned worker processes;
* the launcher's distributed flags, and their refusal without
  ``--engine distributed``, as the reference's.

No pass here is decided by a clock: every timeout is a hang guard with wide
slack, and the torch work runs at one intra-op thread (workers through the
transports' ``threads`` option, the spawned processes too).
"""

import dataclasses
import glob
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.staleness import Poisson as JPoisson
from repro.core.step_size import make_schedule as j_make_schedule
from repro.data import make_batch_for as j_make_batch_for
from repro.distributed import parse_faults as j_parse_faults
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro.training import init_params as j_init_params
from repro.training import make_adapt as j_make_adapt
from repro_torch import bridge
from repro_torch.async_engine.events import TraceError, TraceWriter, load_trace
from repro_torch.configs import get_config, reduced
from repro_torch.core.staleness import Poisson
from repro_torch.core.step_size import make_schedule
from repro_torch.data import make_batch_for
from repro_torch.distributed import (
    FaultPlan,
    FaultSpec,
    InProcTransport,
    ParameterServer,
    RetryPolicy,
    make_grad_fn,
    make_transport,
    parse_faults,
    transport_kinds,
    worker_loop,
)
from repro_torch.distributed.transport import _TRANSPORTS, register_transport
from repro_torch.optim import transform as T
from repro_torch.optim.fuse import fuse_pipeline
from repro_torch.run import BenchHook, CheckpointHook, Hook, LogHook, RunSpec, make_engine, run
from repro_torch.run.ckpt import restore_checkpoint
from repro_torch.training import init_train_state, make_adapt
from repro_torch.training.adapt import record_taus

pytestmark = pytest.mark.distributed

TAU_MAX, RING, LR = 31, 8, 0.05
ONE_THREAD = {"threads": 1}
GUARD_S = 120.0  # hang guard only: no pass waits anywhere near it


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny_cfg():
    return reduced(get_config("stablelm-1.6b"), d_model=32)


def _sched():
    return make_schedule("poisson_momentum", LR, Poisson(3.0), K=1.0, tau_max=TAU_MAX)


def _pipeline(workers=4):
    link = T.scale_by_staleness(_sched(), LR, m=workers, tau_max=TAU_MAX)
    return T.chain(link, T.scale(-LR), T.trace(0.9))


def _adapt():
    return make_adapt(_sched(), Poisson(3.0), cdf_support=RING, tau_max=TAU_MAX)


def _batch_fn(cfg):
    return lambda t: make_batch_for(cfg, batch=2, seq=8, seed=100 + t)


def _spec(cfg, *, workers=4, num_steps=8, trace_path=None, **kw):
    kw.setdefault("transport_opts", ONE_THREAD)
    kw.setdefault("fuse", True)
    return RunSpec(cfg=cfg, pipeline=_pipeline(workers), mode="distributed", num_steps=num_steps,
                   batch_fn=_batch_fn(cfg), num_workers=workers, adapt=_adapt(),
                   trace_path=trace_path, seed=0, device="cpu", **kw)


def _state(cfg, pipeline, **kw):
    return init_train_state(cfg, pipeline, seed=0, device="cpu", adapt=_adapt(), fuse=True, **kw)


def _server_for(cfg, pipeline, trace=None, **kw):
    state = _state(cfg, pipeline)
    tr = InProcTransport()
    server = ParameterServer(state, pipeline, tr, fuse=True, trace=trace, **kw)
    server.start()
    return state, tr, server


def _stop(server, tr):
    server.request_stop()
    server.shutdown()
    tr.close()


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_tick(self, ctx):
        self.losses.append(ctx.metrics["loss"].item())


# ---------------------------------------------------------------------------
# Fault plans and the transport API
# ---------------------------------------------------------------------------

FAULT_STRINGS = [
    "crash_before_push:worker=1:after=2,delay_push:seconds=0.2:count=inf",
    "drop_reply:worker=0, slow_apply:after=5:seconds=0.1:count=3",
    "crash_after_push",
]
GARBAGE = ["segfault", "delay_push:sec=1", "delay_push:seconds", "  ,",
           "delay_push:seconds=-1", "crash_before_push:worker=x"]


class TestFaultPlan:
    @pytest.mark.parametrize("text", FAULT_STRINGS)
    def test_parse_faults_matches_reference(self, text):
        got = [dataclasses.asdict(f) for f in parse_faults(text).faults]
        want = [dataclasses.asdict(f) for f in j_parse_faults(text).faults]
        assert got == want

    @pytest.mark.parametrize("text", GARBAGE)
    def test_parse_faults_rejects_the_references_garbage(self, text):
        with pytest.raises(ValueError) as theirs:
            j_parse_faults(text)
        with pytest.raises(ValueError) as ours:
            parse_faults(text)
        assert str(ours.value) == str(theirs.value)

    def test_spec_normalizes_fault_strings(self, tiny_cfg):
        spec = _spec(tiny_cfg, faults="crash_after_push:worker=0")
        assert isinstance(spec.faults, FaultPlan)
        assert spec.faults.faults[0] == FaultSpec("crash_after_push", worker=0)

    def test_injector_scoping_after_count(self):
        plan = FaultPlan((
            FaultSpec("crash_before_push", worker=1, after=1, count=1),
            FaultSpec("slow_apply", after=2, count=None, seconds=0.1),
        ))
        assert plan.for_worker(0).fire("crash_before_push", 0) is None
        assert plan.for_server().fire("crash_before_push", 1) is None
        inj = plan.for_worker(1)
        assert inj.fire("crash_before_push", 1) is None  # after=1: the first passes
        assert inj.fire("crash_before_push", 1) is not None
        assert inj.fire("crash_before_push", 1) is None  # count=1 spent
        srv = plan.for_server()
        assert srv.fire("slow_apply", 0) is None and srv.fire("slow_apply", 1) is None
        assert all(srv.fire("slow_apply", w) is not None for w in range(5))


class TestTransportAPI:
    def test_factory_and_registry(self):
        assert set(transport_kinds()) >= {"inproc", "socket"}
        with pytest.raises(ValueError, match="unknown transport"):
            make_transport("carrier-pigeon")
        with make_transport("inproc", capacity=4) as tr:
            assert isinstance(tr, InProcTransport) and not tr.closed
        assert tr.closed
        tr.close()  # idempotent

    def test_fifo_ordering(self):
        tr = InProcTransport()
        for i in range(50):
            tr.send(("m", i))
        assert [tr.recv(timeout=GUARD_S)[0][1] for _ in range(50)] == list(range(50))

    def test_rpc_replies_route_to_the_right_endpoint(self):
        tr = InProcTransport()
        stop = threading.Event()

        def echo_server():
            while not stop.is_set():
                item = tr.recv(timeout=0.05)
                if item is not None:
                    msg, reply = item
                    reply(("echo", msg[1]))

        t = threading.Thread(target=echo_server, daemon=True)
        t.start()
        endpoints = [tr.worker_endpoint() for _ in range(3)]
        try:
            for round_ in range(5):
                for i, ep in enumerate(endpoints):
                    assert ep.rpc(("ping", (i, round_)), timeout=GUARD_S) == ("echo", (i, round_))
        finally:
            stop.set()
            t.join(timeout=GUARD_S)

    def test_backpressure_blocks_at_capacity(self):
        tr = InProcTransport(capacity=2)
        tr.send(("a",))
        tr.send(("b",))
        started, done = threading.Event(), threading.Event()

        def overflow():
            started.set()
            tr.send(("c",))  # blocks until the server consumes one
            done.set()

        t = threading.Thread(target=overflow, daemon=True)
        t.start()
        assert started.wait(GUARD_S)
        # no recv has happened: a bounded queue cannot have taken the third
        assert not done.is_set()
        assert tr.recv(timeout=GUARD_S)[0] == ("a",)
        assert done.wait(GUARD_S), "the send completes once a slot frees"
        t.join(timeout=GUARD_S)
        assert [tr.recv(timeout=GUARD_S)[0] for _ in range(2)] == [("b",), ("c",)]

    def test_inproc_rpc_raises_eof_when_transport_closes(self):
        tr = make_transport("inproc")
        ep = tr.worker_endpoint()
        tr.close()
        with pytest.raises(EOFError):
            ep.rpc(("pull", 0), timeout=GUARD_S)

    def test_server_shutdown_is_idempotent(self, tiny_cfg):
        _, tr, server = _server_for(tiny_cfg, _pipeline())
        server.shutdown()
        server.shutdown()
        tr.close()
        tr.close()


class _FlakyEndpoint:
    """Endpoint double whose every rpc raises ``exc``; counts the attempts."""

    def __init__(self, exc):
        self.exc, self.calls, self.closed = exc, 0, False

    def rpc(self, msg, timeout=None):
        self.calls += 1
        raise self.exc

    def close(self):
        self.closed = True


@pytest.mark.chaos
class TestWorkerRetry:
    @pytest.mark.parametrize("exc", [TimeoutError("no reply"), ConnectionResetError("reset")])
    def test_transient_errors_retried_then_clean_exit(self, exc):
        ep = _FlakyEndpoint(exc)
        worker_loop(ep, None, 0, retry=RetryPolicy(max_retries=3, backoff_base=0.0,
                                                   backoff_max=0.0))
        assert ep.calls == 4 and ep.closed

    def test_server_gone_exits_without_retry(self):
        ep = _FlakyEndpoint(EOFError("server gone"))
        worker_loop(ep, None, 0, retry=RetryPolicy(max_retries=5))
        assert ep.calls == 1 and ep.closed


# ---------------------------------------------------------------------------
# Staleness stamping and the server's copy-before-write rule
# ---------------------------------------------------------------------------

class TestStalenessStamping:
    def test_scripted_interleaving(self, tiny_cfg, tmp_path):
        """tau == server updates applied between this pull and this push."""
        path = str(tmp_path / "scripted.bin")
        trace = TraceWriter(path)
        state, tr, server = _server_for(tiny_cfg, _pipeline(), trace=trace)
        g = torch.zeros(state.params.shape[0])
        batch = make_batch_for(tiny_cfg, batch=1, seq=8, seed=0)
        try:
            e0, e1 = tr.worker_endpoint(), tr.worker_endpoint()
            server.submit_batch(batch)
            server.submit_batch(batch)
            w0 = e0.rpc(("pull", 0), timeout=GUARD_S)
            w1 = e1.rpc(("pull", 1), timeout=GUARD_S)
            assert w0[:2] == ("work", 0) and w1[:2] == ("work", 0)
            assert e0.rpc(("push", 0, w0[1], w0[2], g, 1.0), timeout=GUARD_S) == ("ack", 0)
            assert e1.rpc(("push", 1, w1[1], w1[2], g, 1.0), timeout=GUARD_S) == ("ack", 1)
            server.submit_batch(batch)
            w0b = e0.rpc(("pull", 0), timeout=GUARD_S)
            assert w0b[1] == 2
            assert e0.rpc(("push", 0, w0b[1], w0b[2], g, 1.0), timeout=GUARD_S) == ("ack", 0)
            server.await_applied(3, timeout=GUARD_S)
            assert server.completed == 3
        finally:
            _stop(server, tr)
        trace.finalize()
        taus, workers = load_trace(path, return_workers=True)
        np.testing.assert_array_equal(taus, [0, 1, 0])
        np.testing.assert_array_equal(workers, [0, 1, 0])

    def test_pulled_params_and_snapshots_survive_later_applies(self, tiny_cfg):
        """Two workers pull v0; worker 0's push is applied in place by the
        fused chain.  Worker 1's params are still v0, bit for bit, and a
        snapshot taken before the next apply is unchanged by it."""
        state, tr, server = _server_for(tiny_cfg, _pipeline())
        v0 = state.params.clone()
        g = torch.full_like(v0, 0.25)
        batch = make_batch_for(tiny_cfg, batch=1, seq=8, seed=0)
        try:
            e0, e1 = tr.worker_endpoint(), tr.worker_endpoint()
            for _ in range(3):
                server.submit_batch(batch)
            w0 = e0.rpc(("pull", 0), timeout=GUARD_S)
            w1 = e1.rpc(("pull", 1), timeout=GUARD_S)
            assert e0.rpc(("push", 0, w0[1], w0[2], g, 1.0), timeout=GUARD_S)[0] == "ack"
            server.await_applied(1, timeout=GUARD_S)
            assert torch.equal(w1[3], v0) and torch.equal(w0[3], v0)
            snap, _ = server.snapshot()
            assert not torch.equal(snap.params, v0)  # the apply moved the server
            kept = (snap.params.clone(), snap.opt_state["bufs"].clone(),
                    snap.adapt.hist.clone(), int(snap.step))
            assert e1.rpc(("push", 1, w1[1], w1[2], g, 1.0), timeout=GUARD_S) == ("ack", 1)
            server.await_applied(2, timeout=GUARD_S)
            assert torch.equal(snap.params, kept[0])
            assert torch.equal(snap.opt_state["bufs"], kept[1])
            assert torch.equal(snap.adapt.hist, kept[2]) and int(snap.step) == kept[3] == 1
            now, _ = server.snapshot()
            assert int(now.step) == 2 and not torch.equal(now.params, kept[0])
            assert int(now.adapt.hist.sum()) == 2
        finally:
            _stop(server, tr)

    def test_w1_matches_serial_oracle_and_reference(self, tiny_cfg, tmp_path):
        """One live worker == serial SGD: taus all 0; the final state equals
        the port's serial pull/grad/apply loop bitwise, and the reference's
        W = 1 live run within 1e-6 of max |p| (same params, same batches)."""
        steps = 5
        jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=32)
        jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
        keys, leaves, _ = _flatten_with_keys(jparams)
        flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)},
                                         tiny_cfg)

        path = str(tmp_path / "w1.bin")
        spec = _spec(tiny_cfg, workers=1, num_steps=steps, trace_path=path, params=flat)
        res = run(spec)
        np.testing.assert_array_equal(load_trace(path), np.zeros(steps, np.int64))

        # the port's serial oracle: the same grad fn and pipeline, no threads
        pipeline = _pipeline(1)
        fused = fuse_pipeline(pipeline)
        state = _state(tiny_cfg, pipeline, params=flat.clone())
        grad_fn = make_grad_fn(tiny_cfg, "cpu")
        for t in range(steps):
            _, g_flat = grad_fn(state.params, spec.batch_fn(t))
            tau = torch.zeros(1, dtype=torch.int32)
            record_taus(state.adapt, tau)
            ctx = T.StepContext(tau=tau[0], adapt=state.adapt, staleness_applied=False)
            with torch.no_grad():
                params, opt = T.run_pipeline(fused, g_flat, state.opt_state, state.params, ctx)
            state = dataclasses.replace(state, params=params, opt_state=opt, step=state.step + 1)
        assert torch.equal(res.state.params, state.params)
        assert torch.equal(res.state.opt_state["bufs"], state.opt_state["bufs"])
        assert torch.equal(res.state.adapt.hist, state.adapt.hist)
        assert int(res.state.step) == steps

        # the reference's W = 1 live run on the same params and batches
        jsched = j_make_schedule("poisson_momentum", LR, JPoisson(3.0), K=1.0, tau_max=TAU_MAX)
        jpipe = JT.chain(JT.scale_by_staleness(jsched, LR, m=1, tau_max=TAU_MAX),
                         JT.scale(-LR), JT.trace(0.9))
        jres = j_run(JSpec(
            cfg=jcfg, pipeline=jpipe, mode="distributed", num_steps=steps, num_workers=1,
            batch_fn=lambda t: j_make_batch_for(jcfg, batch=2, seq=8, seed=100 + t),
            adapt=j_make_adapt(jsched, JPoisson(3.0), cdf_support=RING, tau_max=TAU_MAX),
            params=jparams, seed=0))
        want = np.asarray(ravel_pytree(jres.state.params)[0])
        np.testing.assert_allclose(res.state.params.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_array_equal(res.state.adapt.hist.numpy(),
                                      np.asarray(jres.state.adapt.hist))


# ---------------------------------------------------------------------------
# DistributedAsyncEngine through run(...)
# ---------------------------------------------------------------------------

class _PushLog(InProcTransport):
    """The in-process fabric, logging ``(worker, pull version)`` of every
    push in the order the server receives it (the order it applies them)."""

    def __init__(self, log, **kw):
        super().__init__(**kw)
        self._log = log

    def recv(self, timeout=None):
        item = super().recv(timeout)
        if item is not None and item[0][0] == "push":
            self._log.append((item[0][1], item[0][2]))
        return item


@pytest.fixture
def push_log_transport():
    register_transport("push-log-test")(_PushLog)
    try:
        yield "push-log-test"
    finally:
        _TRANSPORTS.pop("push-log-test")


def _assert_stamped(taus, who, log, applies):
    """Record k was applied at version k; its tau must be k less the
    version its worker pulled, and its worker the pusher's."""
    assert len(log) >= applies
    for k, (wid, pull_version) in enumerate(log[:applies]):
        assert who[k] == wid and taus[k] == k - pull_version, f"record {k}"


def _assert_stamped_by_clock(taus, t_pull, t_push):
    """The same invariant from the records' own stamps (one server thread
    stamps dispatches and applies, in order): the version at a pull is the
    number of applies stamped before it."""
    assert np.all(np.diff(t_push) >= 0) and np.all(t_push >= t_pull)
    np.testing.assert_array_equal(taus, np.arange(len(taus)) - np.searchsorted(t_push, t_pull))


class _SaveAfterTheServerMoves(Hook):
    """At ``step``: keep a copy of ``ctx.state``, then wait until the server
    has completed every submitted batch (the next apply lands during the
    hooks), so a checkpoint taken after it shows whether the state moved."""

    def __init__(self, step):
        self.step, self.kept = step, None

    def on_tick(self, ctx):
        if ctx.step != self.step:
            return
        s = ctx.state
        self.kept = (s.params.clone(), s.opt_state["bufs"].clone(), s.adapt.hist.clone(),
                     int(s.step))
        ctx.engine._server.await_batches(ctx.step, timeout=GUARD_S)


class TestDistributedEngine:
    def test_live_run_with_hooks_and_trace(self, tiny_cfg, tmp_path, push_log_transport):
        path = str(tmp_path / "live.bin")
        steps, workers = 10, 4
        bench = BenchHook("live", {"workers": workers})
        log: list = []
        engine = make_engine(_spec(tiny_cfg, workers=workers, num_steps=steps, trace_path=path,
                                   transport=push_log_transport,
                                   transport_opts={"log": log, "threads": 1}))
        res = run(engine.spec, hooks=[LogHook(log_every=5, logger=lambda s: None), bench],
                  engine=engine)
        assert res.step == steps and int(res.state.step) == steps  # finish() drained
        taus, who = load_trace(path, return_workers=True)
        assert len(taus) == steps
        _assert_stamped(taus, who, log, steps)
        assert int(res.state.adapt.hist.sum()) == steps
        assert all(np.isfinite(r["value"]) for r in bench.rows)
        assert not any(r["name"].endswith("retraces") for r in bench.rows)  # eager port
        assert torch.isfinite(res.state.params).all()
        live = engine.liveness()
        assert live["num_workers"] == workers and live["dead"] == [] and live["reclaimed"] == 0

    def test_many_workers_with_fast_thread_switches(self, tiny_cfg, push_log_transport):
        """More worker threads than cores, switching every 10 us: no lost
        update — every batch applied once, every tau recorded once and
        stamped exactly, the final params finite."""
        steps, workers = 24, 12
        log: list = []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            res = run(_spec(tiny_cfg, workers=workers, num_steps=steps,
                            transport=push_log_transport,
                            transport_opts={"log": log, "threads": 1}))
        finally:
            sys.setswitchinterval(old)
        assert int(res.state.step) == steps
        assert int(res.state.adapt.hist.sum()) == steps
        taus = np.array([k - v for k, (_, v) in enumerate(log[:steps])])
        assert taus.min() >= 0
        np.testing.assert_array_equal(np.bincount(taus, minlength=TAU_MAX + 1),
                                      res.state.adapt.hist.numpy())
        assert torch.isfinite(res.state.params).all()

    @pytest.mark.parametrize("fuse", [True, False])
    def test_refresh_runs_inside_the_server(self, tiny_cfg, fuse):
        class Tables(Hook):
            def on_start(self, ctx):
                self.table = ctx.state.adapt.alpha_table
                self.before = self.table.clone()

        spec = _spec(tiny_cfg, workers=2, num_steps=6, refresh_every=3, fuse=fuse)
        tables = Tables()
        res = run(spec, hooks=[tables])
        assert res.step == 6 and int(res.state.step) == 6
        est = T.staleness_link(spec.pipeline).estimator
        # every applied tau is drained by a refresh or still in the histogram
        assert est.n_seen + int(res.state.adapt.hist.sum()) == 6 and est.n_seen >= 4
        # the refresh rewrote the server's table in place
        assert res.state.adapt.alpha_table is tables.table
        assert not torch.equal(tables.table, tables.before)
        assert torch.isfinite(res.state.params if fuse else T.pack_flat(res.state.params)).all()

    def test_checkpoint_during_a_live_run_is_the_state_of_its_step(self, tiny_cfg, tmp_path):
        ckdir = str(tmp_path / "ck")
        spec = _spec(tiny_cfg, workers=2, num_steps=4)
        keep = _SaveAfterTheServerMoves(3)
        engine = make_engine(spec)
        run(spec, hooks=[keep, CheckpointHook(ckdir, every=3)], engine=engine)
        restored, step = restore_checkpoint(ckdir, engine.build_template(), spec.pipeline,
                                            device="cpu")
        assert step == 3
        params, bufs, hist, version = keep.kept
        assert int(restored.step) == version and version in (2, 3)
        assert torch.equal(restored.params, params)
        assert torch.equal(restored.opt_state["bufs"], bufs)
        assert torch.equal(restored.adapt.hist, hist)

    def test_checkpoint_resume_extends_server_state_and_trace(self, tiny_cfg, tmp_path):
        path, ckdir = str(tmp_path / "resume.bin"), str(tmp_path / "ck")
        run(_spec(tiny_cfg, workers=4, num_steps=4, trace_path=path),
            hooks=[CheckpointHook(ckdir, every=4)])
        taus_a = load_trace(path)
        assert len(taus_a) == 4  # drained + finalized
        (ck_file,) = glob.glob(ckdir + "/step_00000004.npz")
        k = int(np.load(ck_file)[".step"])
        assert 1 <= k <= 4  # taken mid-flight: the saved version may lag the tick

        res_b = run(_spec(tiny_cfg, workers=4, num_steps=8, trace_path=path), resume_from=ckdir)
        assert res_b.start_step == 4 and res_b.step == 8
        assert int(res_b.state.step) == k + 4
        taus_all = load_trace(path)
        assert len(taus_all) == len(taus_a) + 4
        np.testing.assert_array_equal(taus_all[:len(taus_a)], taus_a)

    def test_failure_aborts_cluster_and_leaves_salvageable_trace(self, tiny_cfg, tmp_path):
        path = str(tmp_path / "crash.bin")

        class Boom(Hook):
            def on_tick(self, ctx):
                if ctx.step == 3:
                    raise RuntimeError("injected failure")

        with pytest.raises(RuntimeError, match="injected failure"):
            run(_spec(tiny_cfg, workers=2, num_steps=8, trace_path=path), hooks=[Boom()])
        with pytest.raises(TraceError, match="never finalized"):
            load_trace(path)
        assert len(load_trace(path, allow_partial=True)) >= 2


# ---------------------------------------------------------------------------
# Faults through a live run: count-driven, invariants only
# ---------------------------------------------------------------------------

# kind -> (workers, plan, extra spec fields, fired drop_reply count)
CHAOS = {
    "crash_before_push": (2, FaultPlan((FaultSpec("crash_before_push", worker=1),)),
                          {"worker_timeout": 3.0}, 0),
    "crash_after_push": (2, FaultPlan((FaultSpec("crash_after_push", worker=1),)), {}, 0),
    "delay_push": (2, FaultPlan((FaultSpec("delay_push", worker=0, after=1, count=2,
                                           seconds=0.05),)), {}, 0),
    "slow_apply": (2, FaultPlan((FaultSpec("slow_apply", after=2, count=2, seconds=0.05),)),
                   {}, 0),
    # the only worker must retry its dropped ack before it takes more work,
    # so the duplicate always lands; the rpc deadline only sets how soon
    "drop_reply": (1, FaultPlan((FaultSpec("drop_reply", worker=0, after=1),)),
                   {"retry": RetryPolicy(rpc_timeout=2.0, max_retries=8, backoff_base=0.01,
                                         backoff_max=0.05)}, 1),
}


@pytest.mark.chaos
class TestChaosMatrix:
    @pytest.mark.parametrize("kind", sorted(CHAOS))
    def test_injected_fault_keeps_the_invariants(self, tiny_cfg, tmp_path, kind,
                                                 push_log_transport):
        workers, plan, extra, drops = CHAOS[kind]
        path = str(tmp_path / f"{kind}.bin")
        steps = 6
        log: list = []
        spec = _spec(tiny_cfg, workers=workers, num_steps=steps, trace_path=path, faults=plan,
                     transport=push_log_transport, transport_opts={"log": log, "threads": 1},
                     **extra)
        losses = _Losses()
        engine = make_engine(spec)
        res = run(spec, hooks=[losses], engine=engine)
        assert res.step == steps
        taus, who = load_trace(path, return_workers=True)
        applies = int(res.state.step)
        assert applies == len(taus) == steps + drops
        assert int(res.state.adapt.hist.sum()) == applies
        _assert_stamped(taus, who, log, applies)
        assert np.isfinite(losses.losses).all()
        assert torch.isfinite(res.state.params).all()
        live = engine.liveness()
        if kind == "crash_before_push":
            assert live["reclaimed"] >= 1 and 1 in live["dead"]
            assert 1 not in set(who.tolist())  # it never pushed
        if kind == "crash_after_push":
            assert (who == 1).sum() <= 1
        if kind == "drop_reply":
            np.testing.assert_array_equal(taus, [0, 0, 1, 0, 0, 0, 0])


# ---------------------------------------------------------------------------
# Sockets: spawned worker processes; the launcher
# ---------------------------------------------------------------------------

class TestSocketTransport:
    def test_socket_run_spawns_real_processes(self, tiny_cfg, tmp_path):
        path = str(tmp_path / "sock.bin")
        spec = _spec(tiny_cfg, workers=2, num_steps=3, trace_path=path, transport="socket")
        res = run(spec)
        assert res.step == 3 and int(res.state.step) == 3
        taus, _who, t_pull, t_push = load_trace(path, return_workers=True, return_times=True)
        assert len(taus) == 3
        _assert_stamped_by_clock(taus, t_pull, t_push)
        assert torch.isfinite(res.state.params).all()


class TestLauncher:
    @pytest.mark.parametrize("flag", [["--trace_out", "t.bin"],
                                      ["--faults", "crash_after_push"],
                                      ["--worker_timeout", "1.5"]])
    def test_live_flags_need_the_distributed_engine(self, flag, capsys, monkeypatch):
        from repro.launch import train as jtrain
        from repro_torch.launch import train

        with pytest.raises(SystemExit) as ours:
            train.main(["--reduced", "--steps", "1", "--device", "cpu"] + flag)
        mine = capsys.readouterr().err.strip().splitlines()[-1]
        monkeypatch.setattr(sys, "argv", ["train.py", "--reduced", "--steps", "1"] + flag)
        with pytest.raises(SystemExit) as theirs:
            jtrain.main()
        reference = capsys.readouterr().err.strip().splitlines()[-1]
        assert ours.value.code == theirs.value.code == 2
        assert mine.split("error: ")[1] == reference.split("error: ")[1]

    def test_distributed_launch_writes_a_loadable_trace(self, tmp_path, capsys):
        from repro_torch.launch import train

        path = str(tmp_path / "live.trace")
        result = train.main(["--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
                             "--engine", "distributed", "--workers", "2", "--fuse",
                             "--device", "cpu", "--trace_out", path])
        out = capsys.readouterr().out
        assert "mode=distributed" in out and "live trace: 3 updates" in out
        taus, who = load_trace(path, return_workers=True)
        assert len(taus) == 3 and set(who.tolist()) <= {0, 1}
        assert np.isfinite(result.history[-1]["loss"])
