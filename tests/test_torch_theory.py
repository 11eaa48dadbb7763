"""Port parity: the convergence bounds of ``core/theory.py`` (Thm 1, Lemma 1's
stale-gradient series, Thm 6, Cor. 3-4).

Both packages compute them in numpy float64 over their own staleness models
and schedules, on the inputs of tests/test_theory.py; the contract is
agreement to 1e-12 relative (they run the same float64 code, so in practice
the values are identical), and the same ``ValueError`` where the reference
raises.
"""

import math

import numpy as np
import pytest

from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro.core import theory as JT
from repro_torch.core import staleness as TS
from repro_torch.core import step_size as TSS
from repro_torch.core import theory as TT

TOL = 1e-12
PROBLEMS = [
    dict(c=1.0, L=4.0, M=8.0, r0=4.0),
    dict(c=1.0, L=2.0, M=4.0, r0=1.0),
    dict(c=1.0, L=2.0, M=4.0, r0=4.0),
    dict(c=0.5, L=3.0, M=6.0, r0=9.0),
]


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=TOL, abs=0.0)


def test_theorem1_helpers_match():
    for m, b in ((8, 4), (1, 1), (16, 32)):
        assert TT.effective_batch_size(m, b) == JT.effective_batch_size(m, b)
    assert TT.max_useful_workers(64) == JT.max_useful_workers(64) == 64
    for b in (1, 4, 16):
        _close(TT.gradient_variance_scaling(b, 2.5), JT.gradient_variance_scaling(b, 2.5))


@pytest.mark.parametrize("n_grads", [16, 40])
def test_sigma_series_matches(rng, n_grads):
    pmf_j, pmf_t = JS.Poisson(3.0).pmf_table(16), TS.Poisson(3.0).pmf_table(16)
    np.testing.assert_array_equal(pmf_j, pmf_t)
    tab = JSS.poisson_momentum(0.01, 3.0, K=0.01, tau_max=16).table
    grads = rng.normal(size=(n_grads, 4))
    out_t = TT.sigma_series(pmf_t, tab, grads)
    np.testing.assert_allclose(out_t, JT.sigma_series(pmf_j, tab, grads), rtol=TOL, atol=0)


@pytest.mark.parametrize("prob", PROBLEMS, ids=lambda p: f"c{p['c']}-L{p['L']}-M{p['M']}")
def test_corollary3_matches(prob):
    pj, pt = JT.ConvexProblem(**prob), TT.ConvexProblem(**prob)
    for eps in (0.05, 0.1):
        for tb in (0.0, 2.0, 8.0, 32.0):
            for theta in (0.5, 1.0, 1.5):
                _close(TT.corollary3_alpha(pt, eps, tb, theta), JT.corollary3_alpha(pj, eps, tb, theta))
                _close(TT.corollary3_bound(pt, eps, tb, theta), JT.corollary3_bound(pj, eps, tb, theta))
    with pytest.raises(ValueError):
        TT.corollary3_alpha(pt, 0.1, 1.0, theta=2.5)
    with pytest.raises(ValueError):
        TT.corollary3_bound(pt, 0.1, 1.0, theta=0.0)


SCHEDULES = [
    ("constant", lambda SS: SS.constant(0.002, tau_max=64)),
    ("adadelay", lambda SS: SS.adadelay(0.002, tau_max=64)),
    ("inverse_tau", lambda SS: SS.inverse_tau(0.002, tau_max=64)),
    ("poisson_momentum", lambda SS: SS.poisson_momentum(0.002, 4.0, K=0.002, tau_max=64)),
]
MODELS = [("Poisson", (4.0,)), ("Geometric", (0.3,)), ("Geometric", (1.0,)), ("CMP", (6.0, 1.3))]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[s[0] for s in SCHEDULES])
@pytest.mark.parametrize("model", MODELS, ids=[f"{m[0]}{m[1]}" for m in MODELS])
def test_theorem6_and_improvement_factor_match(sched, model):
    sj, st = sched[1](JSS), sched[1](TSS)
    np.testing.assert_array_equal(sj.table, st.table)
    mj, mt = getattr(JS, model[0])(*model[1]), getattr(TS, model[0])(*model[1])
    for prob in PROBLEMS:
        pj, pt = JT.ConvexProblem(**prob), TT.ConvexProblem(**prob)
        for eps in (0.05, 0.5):
            _close(TT.theorem6_bound(pt, eps, st, mt), JT.theorem6_bound(pj, eps, sj, mj))
            _close(TT.theorem6_bound(pt, eps, st, mt, tau_max=16),
                   JT.theorem6_bound(pj, eps, sj, mj, tau_max=16))
            _close(TT.theorem6_improvement_factor(pt, eps, 0.01, 1e-4, 0.03),
                   JT.theorem6_improvement_factor(pj, eps, 0.01, 1e-4, 0.03))


@pytest.mark.parametrize("sched", [s for s in SCHEDULES if s[0] != "poisson_momentum"],
                         ids=lambda s: s[0])
def test_corollary4_matches(sched):
    sj, st = sched[1](JSS), sched[1](TSS)
    for model in MODELS:
        mj, mt = getattr(JS, model[0])(*model[1]), getattr(TS, model[0])(*model[1])
        for prob in PROBLEMS:
            pj, pt = JT.ConvexProblem(**prob), TT.ConvexProblem(**prob)
            _close(TT.corollary4_bound(pt, 0.05, st, mt), JT.corollary4_bound(pj, 0.05, sj, mj))


def test_corollary4_rejects_increasing_schedule_in_both():
    prob_j = JT.ConvexProblem(c=1.0, L=2.0, M=4.0, r0=4.0)
    prob_t = TT.ConvexProblem(c=1.0, L=2.0, M=4.0, r0=4.0)
    with pytest.raises(ValueError):
        JT.corollary4_bound(prob_j, 0.05, JSS.cmp_zeroing(0.001, 4.0, 1.0, tau_max=32), JS.Poisson(4.0))
    with pytest.raises(ValueError):
        TT.corollary4_bound(prob_t, 0.05, TSS.cmp_zeroing(0.001, 4.0, 1.0, tau_max=32), TS.Poisson(4.0))


def test_bound_sgd_quadratic_inputs_match():
    """The Thm-6 input of tests/test_theory.py: tau == 0 (Geometric(1)), the
    Cor-3 step, its constant schedule."""
    eig = np.linspace(1.0, 4.0, 8)
    c, L, r0, eps, noise = float(eig.min()), float(eig.max()), 32.0, 0.05, 0.05
    M = math.sqrt((L * math.sqrt(r0)) ** 2 + 8 * noise**2) * 1.2
    pj, pt = JT.ConvexProblem(c=c, L=L, M=M, r0=r0), TT.ConvexProblem(c=c, L=L, M=M, r0=r0)
    aj = JT.corollary3_alpha(pj, eps, tau_bar=0.0)
    at = TT.corollary3_alpha(pt, eps, tau_bar=0.0)
    _close(at, aj)
    bj = JT.theorem6_bound(pj, eps, JSS.constant(aj, tau_max=4), JS.Geometric(1.0))
    bt = TT.theorem6_bound(pt, eps, TSS.constant(at, tau_max=4), TS.Geometric(1.0))
    _close(bt, bj)
    assert math.isfinite(bt) and bt > 0
