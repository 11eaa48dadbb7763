"""Public names of the reference that the port now has too, each held to
the reference on the CPU with injected uniforms or taus:

* ``async_engine.sample_tau`` — the same tau from the same uniform (the
  reference's ``jax.random.uniform(key, ())``, handed over as a number);
* ``async_engine.delayed_apply`` / ``delayed_apply_batch`` — per-leaf rings
  in f32 and bf16, driven through warmup, live slots and taus at or past
  the ring's depth: popped gradients, live masks and ring contents exactly
  equal (push and gather only, no arithmetic);
* ``training.make_train_step`` / ``make_async_train_step`` — three sync and
  three async ticks on reduced stablelm-1.6b from the reference's params,
  the async ones on the reference's own uniforms: loss within 1e-6
  relative, params within 1e-6 of max |p| (f32 round-off of the gradient,
  as tests/test_torch_run.py), taus equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.async_engine import delayed as JD
from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import make_batch_for as j_make_batch_for
from repro.optim import transform as JT
from repro.training import default_adapt_setup as j_adapt_setup
from repro.training import init_params as j_init_params
from repro.training import init_train_state as j_init_train_state
from repro.training import make_async_train_step as j_make_async_train_step
from repro.training import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.async_engine import (
    delayed_apply,
    delayed_apply_batch,
    init_delayed,
    sample_tau,
    staleness_cdf,
)
from repro_torch.configs import get_config, reduced
from repro_torch.core.staleness import Poisson
from repro_torch.data import make_batch_for
from repro_torch.optim import transform as T
from repro_torch.training import (
    default_adapt_setup,
    init_train_state,
    make_async_train_step,
    make_train_step,
)

W, K, LR, STEPS = 4, 4, 0.05, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_sample_tau_matches_reference():
    pmf = Poisson(3.0).pmf_table(15)
    jcdf, tcdf = JD.staleness_cdf(pmf), staleness_cdf(pmf)
    np.testing.assert_array_equal(tcdf.numpy(), np.asarray(jcdf))
    for seed in range(32):
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(key, ()))
        tau = sample_tau(torch.tensor(u), tcdf)
        assert tau.dtype == torch.int32 and tau.shape == ()
        assert int(tau) == int(JD.sample_tau(key, jcdf)), f"seed {seed}"
    gen = torch.Generator().manual_seed(0)
    assert all(0 <= int(sample_tau(gen, tcdf)) < 16 for _ in range(8))


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delayed_apply_and_batch_match_reference(dtype):
    rng = np.random.default_rng(0)
    zeros = jax.tree.map(np.zeros_like, _tree(rng))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j_single = j_batch = JD.init_delayed(zeros, K, dtype=jdt)
    t_single = init_delayed({"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}}, K, dtype=dtype)
    t_batch = init_delayed({"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}}, K, dtype=dtype)
    taus_seq = [0, 1, 3, 0, 2, 4, 5, 1]  # warmup, live, and tau >= K (dead)
    for step, tau in enumerate(taus_seq):
        g = _tree(rng)
        tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(g["b"]["c"])}}
        jd, jl, j_single = JD.delayed_apply(j_single, g, jnp.int32(tau))
        td, tl, t_single = delayed_apply(t_single, tg, torch.tensor(tau, dtype=torch.int32))
        assert float(tl) == float(jl), f"step {step}"
        for path, want in (("a", jd["a"]), ("c", jd["b"]["c"])):
            got = td["a"] if path == "a" else td["b"]["c"]
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        taus = np.array([tau, (tau + 1) % 6, 0], np.int32)
        jd, jl, j_batch = JD.delayed_apply_batch(j_batch, g, jnp.asarray(taus))
        td, tl, t_batch = delayed_apply_batch(t_batch, tg, torch.from_numpy(taus))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert td["a"].shape == (3, 3, 4)
        np.testing.assert_array_equal(td["a"].float().numpy(), np.asarray(jd["a"], np.float32))
        np.testing.assert_array_equal(td["b"]["c"].float().numpy(),
                                      np.asarray(jd["b"]["c"], np.float32))
        assert int(t_single.step) == int(j_single.step) == step + 1
    np.testing.assert_array_equal(t_batch.ring["a"].float().numpy(),
                                  np.asarray(j_batch.ring["a"], np.float32))


@pytest.fixture(scope="module")
def bridged():
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    tcfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    return jcfg, tcfg, params, flat


def _close(tp, jp, what):
    want = np.asarray(ravel_pytree(jp)[0])
    got = tp.numpy() if isinstance(tp, torch.Tensor) else T.pack_flat(tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=what)


def test_make_train_step_matches_reference(bridged):
    jcfg, tcfg, params, flat = bridged
    jpipe = JT.chain(JT.scale(-LR), JT.trace(0.9))
    tpipe = T.chain(T.scale(-LR), T.trace(0.9))
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg, jpipe, params=params)
    tstate = init_train_state(tcfg, tpipe, device="cpu", params=flat)
    jstep, tstep = j_make_train_step(jcfg, jpipe), make_train_step(tcfg, tpipe)
    for t in range(STEPS):
        jstate, jm = jstep(jstate, j_make_batch_for(jcfg, batch=2, seq=16, seed=t))
        tstate, tm = tstep(tstate, make_batch_for(tcfg, batch=2, seq=16, seed=t))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
        _close(tstate.params, jstate.params, f"sync step {t + 1}")


def test_make_async_train_step_matches_reference(bridged):
    jcfg, tcfg, params, flat = bridged
    jsched, _, jadapt = j_adapt_setup(LR, W, K)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    jpipe = JT.chain(JT.scale_by_staleness(jsched, LR, m=W, tau_max=jadapt.tau_max),
                     JT.scale(-LR))
    tpipe = T.chain(T.scale_by_staleness(tsched, LR, m=W, tau_max=tadapt.tau_max), T.scale(-LR))
    key = jax.random.PRNGKey(0)
    jstate = j_init_train_state(key, jcfg, jpipe, async_ring=K, adapt=jadapt, params=params)
    tstate = init_train_state(tcfg, tpipe, device="cpu", async_ring=K, adapt=tadapt, params=flat)
    # the reference's draws: state.rng = split(key)[1]; per tick rng, sub = split(rng)
    _, rng = jax.random.split(key)
    draws = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    it = iter(draws)
    jstep = j_make_async_train_step(jcfg, jpipe, alpha_c=LR, num_workers=W)
    tstep = make_async_train_step(tcfg, tpipe, alpha_c=LR, num_workers=W,
                                  tau_source=lambda: torch.from_numpy(next(it)))
    for t in range(STEPS):
        jstate, jm = jstep(jstate, j_make_batch_for(jcfg, batch=2, seq=16, seed=t))
        tstate, tm = tstep(tstate, make_batch_for(tcfg, batch=2, seq=16, seed=t))
        assert tm["tau_mean"].item() == float(jm["tau_mean"]), f"async step {t + 1}"
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-6)
        _close(tstate.params, jstate.params, f"async step {t + 1}")
    np.testing.assert_array_equal(tstate.adapt.hist.numpy(), np.asarray(jstate.adapt.hist))
