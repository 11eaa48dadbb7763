"""Port parity, the deprecated shims: ``repro_torch.optim.base`` (``sgd``,
``momentum``, ``adam``, ``Optimizer``), ``repro_torch.optim.mindthestep``
and ``repro_torch.training.loop.train_loop``.

* Each shim is BITWISE equal to the port's own chain, run link by link
  (``tests/test_optim.py``'s checks of the reference's shims), state
  included; ``train_loop`` is bitwise equal to ``run`` on the same step
  (``tests/test_run.py``'s).
* Each shim against the reference's shim on the same numpy tree and
  gradients: within f32 round-off (1e-6 relative, 1e-7 absolute: the two
  frameworks may round a fused multiply-add differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro.optim import base as JB
from repro.optim.mindthestep import mindthestep as j_mindthestep
from repro_torch.configs import get_config, reduced
from repro_torch.core import staleness as TS
from repro_torch.core import step_size as TSS
from repro_torch.data import lm_batches
from repro_torch.optim import base as TB
from repro_torch.optim.mindthestep import MindTheStep, mindthestep
from repro_torch.optim import transform as T
from repro_torch.run import LogHook, RunSpec, run
from repro_torch.training import init_train_state, make_adapt, make_step, train_loop
from repro_torch.tree import tree_leaves, tree_map

LR, MU = 0.05, 0.9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal(()).astype(np.float32)}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _grads(p):
    return tree_map(lambda x: x * 0.1 + 0.01, p)


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _run_opt(opt, steps=6, scale=1.0, taus=None):
    p = _t(_np_tree())
    s = opt.init(p)
    for i in range(steps):
        if taus is None:
            p, s = opt.update(_grads(p), s, p, scale=scale)
        else:
            p, s = opt.update(_grads(p), s, p, tau=taus[i])
    return p, s


def _run_pipe(pipe, steps=6, ctx_fn=lambda t: T.StepContext()):
    p = _t(_np_tree())
    s = pipe.init(p)
    for i in range(steps):
        p, s = T.run_pipeline(pipe, _grads(p), s, p, ctx_fn(i))
    return p, s


def _run_ref(opt, steps=6, scale=1.0, taus=None):
    p = jax.tree.map(jnp.asarray, _np_tree())
    s = opt.init(p)
    for i in range(steps):
        g = jax.tree.map(lambda x: x * 0.1 + 0.01, p)
        if taus is None:
            p, s = opt.update(g, s, p, scale=scale)
        else:
            p, s = opt.update(g, s, p, tau=taus[i])
    return p, s


def _close_to_ref(tp, jp):
    for path in ("a", ("b", "c"), ("b", "d")):
        t = tp[path] if isinstance(path, str) else tp[path[0]][path[1]]
        j = jp[path] if isinstance(path, str) else jp[path[0]][path[1]]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


# -- each shim bitwise to its chain ------------------------------------------

def test_sgd_equals_chain_scale():
    p1, s1 = _run_opt(TB.sgd(LR))
    p2, _ = _run_pipe(T.chain(T.scale(-LR)))
    _equal(p1, p2)
    assert s1 == ()


def test_momentum_equals_scale_then_trace():
    p1, v1 = _run_opt(TB.momentum(LR, MU))
    p2, (_, v2) = _run_pipe(T.chain(T.scale(-LR), T.trace(MU)))
    _equal(p1, p2)
    _equal(v1, v2)


def test_adam_equals_chain():
    p1, s1 = _run_opt(TB.adam(LR))
    p2, (s2, _) = _run_pipe(T.chain(T.scale_by_adam(), T.scale(-LR)))
    _equal(p1, p2)
    _equal(s1["m"], s2["m"])
    _equal(s1["v"], s2["v"])
    assert int(s1["t"]) == int(s2["t"]) == 6


def test_fused_momentum_equals_chain_fused_apply():
    """The fused shim's velocity is one flat f32 buffer (``fused_update``'s
    plain version on the CPU)."""
    p1, v1 = _run_opt(TB.momentum(LR, MU, fused=True))
    p2, (v2,) = _run_pipe(T.chain(T.fused_apply(LR, MU)))
    _equal(p1, p2)
    assert v1.dim() == 1 and torch.equal(v1, v2)


def test_runtime_scale_kwarg_parity():
    p1, _ = _run_opt(TB.momentum(LR, MU), scale=0.5)
    p2, _ = _run_pipe(T.chain(T.scale(-LR), T.trace(MU)),
                      ctx_fn=lambda t: T.StepContext(scale=0.5))
    _equal(p1, p2)


def test_mindthestep_equals_its_chain():
    sched = TSS.make_schedule("poisson_momentum", LR, TS.Poisson(3.0), K=LR, tau_max=31)
    mts = mindthestep(TB.momentum(LR, MU), sched, alpha_c=LR)
    taus = [0, 2, 1, 5, 3, 0]
    p1, v1 = _run_opt(mts, taus=taus)
    pipe = T.chain(T.scale_by_staleness(sched, LR), T.scale(-LR), T.trace(MU))
    p2, (_, _, v2) = _run_pipe(pipe, steps=len(taus),
                               ctx_fn=lambda t: T.StepContext(tau=taus[t]))
    _equal(p1, p2)
    _equal(v1, v2)
    assert [link.kind for link in mts.pipeline.links] == ["staleness", "scale", "trace"]


def test_shims_carry_their_pipelines():
    for opt in (TB.sgd(0.1), TB.momentum(0.1, 0.9), TB.momentum(0.1, 0.9, fused=True),
                TB.adam(0.1)):
        assert isinstance(opt.pipeline, T.Chain)
    from repro_torch import optim

    assert optim.sgd is TB.sgd and optim.MindTheStep is MindTheStep


# -- each shim against the reference's shim ----------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "momentum_fused", "adam"])
def test_shim_matches_reference_shim(name):
    build = {"sgd": lambda m: m.sgd(LR), "momentum": lambda m: m.momentum(LR, MU),
             "momentum_fused": lambda m: m.momentum(LR, MU, fused=True),
             "adam": lambda m: m.adam(LR)}[name]
    tp, _ = _run_opt(build(TB), scale=0.5)
    jp, _ = _run_ref(build(JB), scale=0.5)
    _close_to_ref(tp, jp)


def test_mindthestep_matches_reference_shim():
    tsched = TSS.make_schedule("poisson_momentum", LR, TS.Poisson(3.0), K=LR, tau_max=31)
    jsched = JSS.make_schedule("poisson_momentum", LR, JS.Poisson(3.0), K=LR, tau_max=31)
    np.testing.assert_array_equal(np.asarray(tsched.table), np.asarray(jsched.table))
    taus = [0, 2, 1, 5, 3, 40]
    tp, _ = _run_opt(mindthestep(TB.momentum(LR, MU), tsched, alpha_c=LR), taus=taus)
    jp, _ = _run_ref(j_mindthestep(JB.momentum(LR, MU), jsched, alpha_c=LR), taus=taus)
    _close_to_ref(tp, jp)


def test_alpha_tau_scaling_and_clip():
    sched = TSS.StepSizeSchedule(np.array([0.1, 0.05, 0.025]), name="t")
    mts = mindthestep(TB.sgd(0.1), sched, alpha_c=0.1)
    x = {"w": torch.tensor([1.0])}
    for tau, want in ((0, 0.9), (1, 0.95), (99, 0.975)):
        got, _ = mts.update({"w": torch.tensor([1.0])}, (), x, tau=tau)
        assert float(got["w"][0]) == pytest.approx(want)
    clipped = TB.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-6)


def test_online_refresh_matches_reference():
    """``observe`` then ``refresh`` refits the same table as the
    reference's wrapper from the same taus (float64 fit on both sides)."""
    taus = np.random.default_rng(0).poisson(8.0, size=5000)
    t = mindthestep(TB.sgd(0.01), TSS.constant(0.01), alpha_c=0.01, m=8)
    j = j_mindthestep(JB.sgd(0.01), JSS.constant(0.01), alpha_c=0.01, m=8)
    for m in (t, j):
        m.observe(taus[:2500])
        m.observe_counts(np.bincount(taus[2500:], minlength=64)[:64])
        m.refresh()
    assert t.schedule.name == j.schedule.name and t.schedule.name.startswith("poisson_momentum")
    np.testing.assert_allclose(np.asarray(t.schedule.table), np.asarray(j.schedule.table),
                               rtol=1e-6, atol=1e-9)
    assert t.alpha_c == 0.01 and t.estimator is t.link.estimator
    assert torch.equal(t.table().cpu(), t.schedule.device_table.cpu())


# -- train_loop over run ---------------------------------------------------------

@pytest.fixture(scope="module")
def small_cfg():
    return reduced(get_config("stablelm-1.6b"), d_model=64)


def test_train_loop_equals_run(small_cfg):
    """The shim's history rows and final state equal ``run``'s bitwise
    (async, a refresh every 3 steps)."""
    sched = TSS.make_schedule("poisson_momentum", LR, TS.Poisson(3.0), K=LR, tau_max=31)

    def build():
        link = T.scale_by_staleness(sched, LR, m=4, tau_max=31)
        return (T.chain(link, T.scale(-LR)),
                make_adapt(sched, TS.Poisson(3.0), cdf_support=4, tau_max=31, device="cpu"))

    pipe_a, adapt_a = build()
    spec = RunSpec(cfg=small_cfg, pipeline=pipe_a, mode="async", num_steps=6, batch_size=2,
                   seq_len=16, num_workers=4, ring=4, adapt=adapt_a, refresh_every=3, seed=0,
                   device="cpu")
    res = run(spec, hooks=[LogHook(log_every=3, logger=lambda s: None)])

    pipe_b, adapt_b = build()
    state = init_train_state(small_cfg, pipe_b, seed=0, device="cpu", async_ring=4,
                             adapt=adapt_b)
    step = make_step(small_cfg, pipe_b, mode="async", num_workers=4)
    lines = []
    state, history = train_loop(step, state, lm_batches(small_cfg.vocab_size, 2, 16, seed=0,
                                                        device="cpu"),
                                num_steps=6, log_every=3, logger=lines.append, pipeline=pipe_b,
                                refresh_every=3)
    assert [h["loss"] for h in history] == [h["loss"] for h in res.history]
    assert [h["step"] for h in history] == [h["step"] for h in res.history] == [3, 6]
    _equal(res.state.params, state.params)
    _equal(res.state.adapt.alpha_table, state.adapt.alpha_table)
    assert any(line.startswith("step") for line in lines)


def test_train_loop_checkpoint_fn_and_fail_fast(small_cfg):
    pipe = T.chain(T.scale(-LR))
    state = init_train_state(small_cfg, pipe, seed=0, device="cpu")
    step = make_step(small_cfg, pipe, mode="sync")
    seen = []
    train_loop(step, state, lm_batches(small_cfg.vocab_size, 2, 16, seed=0, device="cpu"),
               num_steps=4, log_every=4, logger=lambda s: None,
               checkpoint_fn=lambda st, i: seen.append(i), checkpoint_every=2)
    assert seen == [2, 4]
    with pytest.raises(AssertionError, match="scale_by_staleness"):
        train_loop(step, state, [], num_steps=1, pipeline=pipe, refresh_every=1)


def test_loop_module_is_a_shim():
    from repro_torch.training import loop

    assert "DEPRECATED" in loop.__doc__ and dataclasses.is_dataclass(TB.Optimizer)
