"""Port parity, host side: the paper core (staleness models, fits, every
step-size strategy, the online estimator) and the adaptation refresh.

All of it is numpy float64 in both packages, so the contract is IDENTICAL
float64 output (``assert_array_equal``), and identical f32 device tables
after a refresh on the same histogram.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as JE
from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro.optim import transform as JT
from repro.training import adapt as JA
from repro_torch.core import estimator as TE
from repro_torch.core import staleness as TS
from repro_torch.core import step_size as TSS
from repro_torch.optim import transform as TT
from repro_torch.training import adapt as TA


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


MODELS = [
    ("Geometric", (0.3,)),
    ("BoundedUniform", (7,)),
    ("Poisson", (6.5,)),
    ("CMP", (8.0, 1.4)),
]


@pytest.mark.parametrize("name,args", MODELS)
def test_pmf_tables_identical(name, args):
    j, t = getattr(JS, name)(*args), getattr(TS, name)(*args)
    np.testing.assert_array_equal(j.pmf_table(40), t.pmf_table(40))
    assert j.mean() == t.mean() and j.mode() == t.mode()


def test_fit_all_models_identical():
    taus = np.random.default_rng(0).poisson(6.0, size=400)
    jf, tf = JS.fit_all_models(taus, m=6), TS.fit_all_models(taus, m=6)
    assert set(jf) == set(tf)
    for k in jf:
        assert repr(jf[k][0]) == repr(tf[k][0]) and jf[k][1] == tf[k][1]
    np.testing.assert_array_equal(JS.empirical_pmf(taus), TS.empirical_pmf(taus))


@pytest.mark.parametrize("strategy", JSS.STRATEGIES)
def test_every_strategy_schedule_identical(strategy):
    assert TSS.STRATEGIES == JSS.STRATEGIES
    jm, tm = ((JS.Geometric(0.2), TS.Geometric(0.2)) if strategy == "geometric_momentum"
              else (JS.Poisson(5.0), TS.Poisson(5.0)))
    pmf = JS.Poisson(5.0).pmf_table(15)
    kw = dict(K=0.05, tau_max=63, normalize_pmf=pmf / pmf.sum())
    j = JSS.make_schedule(strategy, 0.05, jm, **kw)
    t = TSS.make_schedule(strategy, 0.05, tm, **kw)
    np.testing.assert_array_equal(j.table, t.table)
    taus = np.array([0, 3, 7, 70], np.int32)
    np.testing.assert_array_equal(np.asarray(j(jnp.asarray(taus))), t(torch.from_numpy(taus)).numpy())


def test_estimator_state_identical_after_observe_sequence():
    rng = np.random.default_rng(1)
    j, t = JE.OnlineStalenessEstimator(m=4, tau_max=40, decay=0.9), TE.OnlineStalenessEstimator(
        m=4, tau_max=40, decay=0.9)
    for _ in range(3):
        taus = rng.poisson(4.0, size=50)
        counts = np.bincount(rng.poisson(4.0, size=30), minlength=50)
        for est in (j, t):
            est.observe(taus)
            est.observe_counts(counts)
        np.testing.assert_array_equal(j.counts, t.counts)
        assert j.n_seen == t.n_seen
        for fam in ("poisson", "cmp", "geometric", "uniform"):
            assert repr(j.fit(fam)) == repr(t.fit(fam))
        np.testing.assert_array_equal(
            j.rebuild_schedule("poisson_momentum", 0.05, K=0.05).table,
            t.rebuild_schedule("poisson_momentum", 0.05, K=0.05).table,
        )


def test_default_adapt_setup_tables_identical():
    js, _, ja = JA.default_adapt_setup(0.05, 8, 8)
    ts, _, ta = TA.default_adapt_setup(0.05, 8, 8, device="cpu")
    np.testing.assert_array_equal(js.table, ts.table)
    np.testing.assert_array_equal(np.asarray(ja.alpha_table), ta.alpha_table.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tau_cdf), ta.tau_cdf.numpy())
    assert ta.hist.dtype == torch.int32 and int(ta.hist.sum()) == 0


def test_sample_taus_from_injected_uniforms_matches_reference():
    import jax

    _, _, ja = JA.default_adapt_setup(0.05, 8, 8)
    _, _, ta = TA.default_adapt_setup(0.05, 8, 8, device="cpu")
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (64,))
    j = JA.sample_taus(key, ja.tau_cdf, 64)
    t = TA.sample_taus(torch.from_numpy(np.array(u)), ta.tau_cdf)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(JA.alpha_lookup(ja, j)), TA.alpha_lookup(ta, t).numpy())
    np.testing.assert_array_equal(np.asarray(JA.record_taus(ja, j).hist),
                                  TA.record_taus(ta, t).hist.numpy())


@pytest.mark.parametrize("refresh_cdf", [False, True])
def test_host_refresh_tables_identical_and_in_place(refresh_cdf):
    """Same histogram -> the same refit f32 tables; the port writes them into
    the SAME tensors (copy_) and empties the histogram."""
    sched_j, _, ja = JA.default_adapt_setup(0.05, 8, 8)
    sched_t, _, ta = TA.default_adapt_setup(0.05, 8, 8, device="cpu")
    hist = np.bincount(np.random.default_rng(2).poisson(5.0, size=300).clip(0, ja.tau_max),
                       minlength=ja.tau_max + 1).astype(np.int32)
    ja.hist = jnp.asarray(hist)
    ta.hist.copy_(torch.from_numpy(hist))
    jl = JT.scale_by_staleness(sched_j, 0.05, m=8, tau_max=ja.tau_max)
    tl = TT.scale_by_staleness(sched_t, 0.05, m=8, tau_max=ta.tau_max)
    tables = (ta.alpha_table, ta.tau_cdf, ta.hist)
    jn = JA.host_refresh(ja, jl, refresh_cdf=refresh_cdf, logger=None)
    tn = TA.host_refresh(ta, tl, refresh_cdf=refresh_cdf, logger=None)
    assert tn is ta and all(a is b for a, b in zip(tables, (tn.alpha_table, tn.tau_cdf, tn.hist)))
    np.testing.assert_array_equal(np.asarray(jn.alpha_table), tn.alpha_table.numpy())
    np.testing.assert_array_equal(np.asarray(jn.tau_cdf), tn.tau_cdf.numpy())
    assert int(tn.hist.sum()) == 0
    np.testing.assert_array_equal(jl.estimator.counts, tl.estimator.counts)
