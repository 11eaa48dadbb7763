"""Port parity: the exact AsyncPSGD simulator (``async_engine/exact.py``).

The same commit order, batches (numpy, seeded), start point and alpha table
go through the reference's ``lax.scan`` and the port's host-planned loop.
Tolerances, each with its reason:
* taus and alphas: exactly equal (pure functions of the commit order and the
  f32 table in both packages);
* losses and final params: 1e-6 relative — the quadratic's update is
  elementwise (only its loss sums 16 terms, in another order), the
  linear-softmax's gradient is a small matmul whose f32 round-off differs
  between XLA and PyTorch and is carried over the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine import exact as JX
from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro_torch.async_engine import exact as TX

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _quadratic(d=16, T=600, seed=0):
    eig = np.linspace(0.5, 3.0, d).astype(np.float32)
    batches = (0.3 * np.random.default_rng(seed).standard_normal((T, d))).astype(np.float32)
    e_j, e_t = jnp.asarray(eig), torch.from_numpy(eig)

    def jloss(x, b):
        return 0.5 * jnp.sum(e_j * (x - b) ** 2)

    def tloss(x, b):
        return 0.5 * torch.sum(e_t * (x - b) ** 2)

    x0 = np.full((d,), 2.0, np.float32)
    return jloss, tloss, x0, batches


def _softmax_problem(d=12, c=5, n=8, T=200, seed=1):
    r = np.random.default_rng(seed)
    x0 = {"w": (0.1 * r.standard_normal((d, c))).astype(np.float32),
          "b": np.zeros((c,), np.float32)}
    batches = {"x": r.standard_normal((T, n, d)).astype(np.float32),
               "y": r.integers(0, c, size=(T, n)).astype(np.int32)}

    def jloss(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, b["y"][:, None], axis=-1)[:, 0])

    def tloss(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - torch.gather(logits, -1, b["y"].long()[:, None])[:, 0])

    return jloss, tloss, x0, batches


def _tables():
    return {
        "constant": JSS.constant(0.05, tau_max=63).table,
        "geometric_momentum": JSS.make_schedule(
            "geometric_momentum", 0.05, JS.Geometric(0.2), mu_star=0.0, tau_max=63).table,
        "adadelay": JSS.adadelay(0.1, tau_max=63).table,
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _compare(jtr, ttr):
    np.testing.assert_array_equal(ttr.taus.numpy(), np.asarray(jtr.taus))
    np.testing.assert_array_equal(ttr.alphas.numpy(), np.asarray(jtr.alphas))
    assert _rel(ttr.losses.numpy(), jtr.losses) <= RTOL
    if isinstance(jtr.params, dict):
        for k in jtr.params:
            assert _rel(ttr.params[k].numpy(), jtr.params[k]) <= RTOL, k
    else:
        assert _rel(ttr.params.numpy(), jtr.params) <= RTOL


@pytest.mark.parametrize("table", sorted(_tables()))
@pytest.mark.parametrize("m", [4, 16])
def test_quadratic_matches_reference(table, m):
    jloss, tloss, x0, batches = _quadratic()
    order = JX.uniform_commit_order(batches.shape[0], m, seed=3)
    np.testing.assert_array_equal(TX.uniform_commit_order(batches.shape[0], m, seed=3), order)
    tab = _tables()[table].astype(np.float32)
    jtr = JX.simulate_async_sgd(jloss, jnp.asarray(x0), jnp.asarray(batches), order,
                                jnp.asarray(tab), m=m)
    ttr = TX.simulate_async_sgd(tloss, torch.from_numpy(x0), torch.from_numpy(batches), order,
                                tab, m=m)
    _compare(jtr, ttr)


@pytest.mark.parametrize("m", [3, 8])
def test_linear_softmax_matches_reference(m):
    jloss, tloss, x0, batches = _softmax_problem()
    T = batches["y"].shape[0]
    order = JX.uniform_commit_order(T, m, seed=m)
    tab = _tables()["geometric_momentum"].astype(np.float32)
    jtr = JX.simulate_async_sgd(jloss, jax.tree.map(jnp.asarray, x0),
                                jax.tree.map(jnp.asarray, batches), order, jnp.asarray(tab), m=m)
    ttr = TX.simulate_async_sgd(tloss, _to_torch(x0), _to_torch(batches), order, tab, m=m)
    _compare(jtr, ttr)


def test_event_trace_commit_order_matches_reference():
    """The events module's worker sequence as the commit order, with an alpha
    table shorter than the largest tau (the clip path)."""
    from repro_torch.async_engine.events import EventSimConfig, simulate_staleness_trace

    jloss, tloss, x0, batches = _quadratic(T=400)
    _, workers = simulate_staleness_trace(EventSimConfig(m=6), 400, seed=2, return_workers=True)
    tab = np.linspace(0.08, 0.01, 4).astype(np.float32)
    jtr = JX.simulate_async_sgd(jloss, jnp.asarray(x0), jnp.asarray(batches), workers,
                                jnp.asarray(tab), m=6)
    ttr = TX.simulate_async_sgd(tloss, torch.from_numpy(x0), torch.from_numpy(batches), workers,
                                tab, m=6)
    assert int(ttr.taus.max()) > 3
    _compare(jtr, ttr)


def test_single_worker_is_sequential_sgd():
    """m = 1: every tau is 0 and the run is plain SGD with alpha(0), bitwise."""
    _, tloss, x0, batches = _quadratic(T=100)
    tab = np.array([0.05, 0.01], np.float32)
    order = np.zeros(100, np.int32)
    tr = TX.simulate_async_sgd(tloss, torch.from_numpy(x0), torch.from_numpy(batches), order,
                               tab, m=1)
    assert (tr.taus.numpy() == 0).all()
    np.testing.assert_array_equal(tr.alphas.numpy(), np.float32(0.05))
    x = torch.from_numpy(x0)
    alpha = torch.tensor(0.05, dtype=torch.float32)
    for t in range(100):
        g, _ = torch.func.grad_and_value(tloss)(x, torch.from_numpy(batches[t]))
        x = x - alpha * g
    assert torch.equal(tr.params, x)


@pytest.mark.parametrize("m,T", [(1, 5), (3, 40), (6, 60), (16, 200)])
def test_uniform_scheduler_tau_bookkeeping(m, T):
    """0 <= tau_t <= t, and tau is the number of commits since the worker's
    own previous commit (its last read) — the same as the reference's."""
    order = TX.uniform_commit_order(T, m, seed=T * 7 + m)
    taus = TX.commit_staleness(order, m)
    assert (taus >= 0).all() and (taus <= np.arange(T)).all()
    last = {}
    for t, w in enumerate(order):
        assert taus[t] == (t - (last[w] + 1) if w in last else t)
        last[w] = t
    jtr = JX.simulate_async_sgd(lambda x, b: jnp.sum(x * b), jnp.zeros((2,)),
                                jnp.zeros((T, 2)), order, jnp.full((64,), 0.01), m=m)
    np.testing.assert_array_equal(taus, np.asarray(jtr.taus))
