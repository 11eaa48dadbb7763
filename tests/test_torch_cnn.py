"""The paper's CNN and its experiments in the port (``models/cnn.py``, the
classification data streams, ``experiments/``) against the reference, on
the CPU, from the reference's params (bridged) and the same numpy data.

Tolerances, each with its reason:
* CNN and MLP logits, loss and gradient: 1e-5 absolute (f32; XLA's and
  oneDNN's convolutions sum in different orders; measured 2.8e-6 / 7e-7);
* the data streams: bitwise (numpy inside both packages);
* the exact simulator, 200 commits of the heterogeneous event order, the
  constant table: taus and alphas exactly equal (planned from the same
  commit order and f32 table).  MLP losses within 1e-5 relative (max |d| /
  max |ref|; measured 1.4e-7).  CNN: in float64 (both packages), losses
  within 1e-10 relative over all 200 commits (measured 2.6e-15); in f32,
  within 1e-4 over the first 100 commits (measured 3.7e-6).  The f32 CNN
  trajectory is not compared past that: at alpha 0.04 with taus near 16
  the run amplifies round-off — the port's own f32 and f64 runs of it
  differ by 1.7e-2 relative by commit 200 — so no f32 bound there could
  tell a fault from rounding, while the f64 run holds the whole trajectory
  to the reference;
* the convergence row (T 400, m 8, one repeat) and the momentum ablation
  (T 300, m 8): iterations-to-threshold equal to the reference's, except
  where the 25-commit smoothed loss is within 1e-4 of the threshold at the
  crossing (an f32 tie), which the test checks instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine import simulate_async_sgd as j_simulate
from repro.checkpoint.store import _flatten_with_keys
from repro.data import cifar_like_batches as j_cifar
from repro.data import classification_batches as j_blobs
from repro.models import cnn as JC
from repro_torch import bridge
from repro_torch.async_engine import simulate_async_sgd as t_simulate
from repro_torch.data import cifar_like_batches, classification_batches
from repro_torch.experiments import ablation_momentum, async_vs_sync_cnn, convergence
from repro_torch.experiments.common import event_order, iters_to
from repro_torch.models import cnn as TC
from repro_torch.tree import tree_map

M, T_SIM, ALPHA = 16, 200, 0.04


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bridge(jparams):
    keys, leaves, _ = _flatten_with_keys(jparams)
    return bridge.cnn_params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)})


MODELS = {
    "cnn16": (lambda k: JC.init_cnn(k, image=16), JC.cnn_loss, JC.cnn_forward, TC.cnn_loss,
              TC.cnn_forward, "images", lambda: next(j_cifar(8, image=16, seed=3))),
    "cnn32": (lambda k: JC.init_cnn(k, image=32), JC.cnn_loss, JC.cnn_forward, TC.cnn_loss,
              TC.cnn_forward, "images", lambda: next(j_cifar(4, image=32, seed=4))),
    "mlp": (lambda k: JC.init_mlp_classifier(k, d_in=32, d_hidden=64), JC.mlp_loss,
            JC.mlp_forward, TC.mlp_loss, TC.mlp_forward, "x",
            lambda: next(j_blobs(32, 10, 8, seed=5))),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_gradient_match_reference(name):
    j_init, j_loss, j_fwd, t_loss, t_fwd, xkey, batch_fn = MODELS[name]
    jp = j_init(jax.random.PRNGKey(1))
    jb = batch_fn()
    tp = _bridge(jp)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    np.testing.assert_allclose(t_fwd(tp, tb[xkey]).numpy(), np.asarray(j_fwd(jp, jb[xkey])),
                               rtol=0, atol=1e-5)
    jl, jg = jax.value_and_grad(j_loss)(jp, jb)
    tg, tl = torch.func.grad_and_value(t_loss)(tp, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=1e-5)
    for k in jg:
        for leaf in jg[k]:
            np.testing.assert_allclose(tg[k][leaf].numpy(), np.asarray(jg[k][leaf]), rtol=0,
                                       atol=1e-5, err_msg=f"{k}.{leaf}")
    if name.startswith("cnn"):
        # HWIO weights and the NHWC flatten: fc1 sees (h, w, c) order
        assert tuple(tp["conv1"]["w"].shape) == (3, 3, 3, 32)


def test_data_streams_are_the_reference_arrays():
    for jit, tit in ((j_cifar(4, image=32, seed=7), cifar_like_batches(4, image=32, seed=7)),
                     (j_blobs(32, 10, 8, seed=7), classification_batches(32, 10, 8, seed=7))):
        for _ in range(3):
            jb, tb = next(jit), next(tit)
            assert set(jb) == set(tb)
            for k in jb:
                a, b = np.asarray(jb[k]), tb[k].numpy()
                assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
                np.testing.assert_array_equal(b, a)
            assert tb["labels"].dtype == torch.int64


# ---------------------------------------------------------------------------
# The exact simulator
# ---------------------------------------------------------------------------

def _enable_x64(on: bool):
    """jax's float64 switch as a context manager (its name moved across
    versions)."""
    fn = getattr(jax, "enable_x64", None)
    if fn is None:
        from jax.experimental import enable_x64 as fn
    return fn(on)


def _simulate_both(j_init, j_loss, t_loss, np_batches, dtype):
    _, order = event_order(M, T_SIM, seed=1)
    table = np.full(256, ALPHA, np.float32)
    jparams = j_init(jax.random.PRNGKey(0))
    f64 = dtype == "float64"
    with _enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        jb = {k: jnp.asarray(v, jdt if v.dtype.kind == "f" else None) for k, v in np_batches.items()}
        jt = j_simulate(j_loss, jax.tree.map(lambda x: jnp.asarray(x, jdt), jparams), jb, order,
                        jnp.asarray(table), m=M)
        jt = {k: np.asarray(getattr(jt, k)) for k in ("taus", "alphas", "losses")}
    tdt = getattr(torch, dtype)
    tp = tree_map(lambda x: x.to(tdt), _bridge(jparams))
    tb = {k: torch.from_numpy(v).to(tdt if v.dtype.kind == "f" else torch.int64)
          for k, v in np_batches.items()}
    tt = t_simulate(t_loss, tp, tb, order, table, M)
    np.testing.assert_array_equal(tt.taus.numpy(), jt["taus"])
    np.testing.assert_array_equal(tt.alphas.numpy(), jt["alphas"])
    assert tt.losses.dtype == tdt
    d = np.abs(tt.losses.numpy() - jt["losses"])
    return d, np.abs(jt["losses"]).max()


def _cnn_batches():
    it = j_cifar(16, image=16, seed=0)
    bs = [next(it) for _ in range(T_SIM)]
    return {"images": np.stack([np.asarray(b["images"]) for b in bs]),
            "labels": np.stack([np.asarray(b["labels"]) for b in bs])}


def test_exact_simulator_cnn_f32_matches_reference():
    d, scale = _simulate_both(lambda k: JC.init_cnn(k, image=16), JC.cnn_loss, TC.cnn_loss,
                              _cnn_batches(), "float32")
    assert d[:100].max() <= 1e-4 * scale


def test_exact_simulator_cnn_f64_matches_reference():
    d, scale = _simulate_both(lambda k: JC.init_cnn(k, image=16), JC.cnn_loss, TC.cnn_loss,
                              _cnn_batches(), "float64")
    assert d.max() <= 1e-10 * scale


def test_exact_simulator_mlp_matches_reference():
    rng = np.random.default_rng(0)
    mus = rng.normal(size=(10, 32))
    mus = 3.0 * mus / np.linalg.norm(mus, axis=1, keepdims=True)
    ys = rng.integers(0, 10, size=(T_SIM, 16))
    xs = (mus[ys] + rng.normal(size=(T_SIM, 16, 32))).astype(np.float32)
    d, scale = _simulate_both(lambda k: JC.init_mlp_classifier(k, d_in=32, d_hidden=64),
                              JC.mlp_loss, TC.mlp_loss, {"x": xs, "labels": ys}, "float32")
    assert d.max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# The experiments
# ---------------------------------------------------------------------------

def _mlp_params_of_reference(seed):
    return _bridge(JC.init_mlp_classifier(jax.random.PRNGKey(seed), d_in=32, d_hidden=64,
                                          num_classes=10))


def _same_or_tie(got, want, losses, thresh):
    """Equal iteration counts, or an f32 tie at the crossing."""
    if got == want:
        return True
    sm = np.convolve(losses, np.ones(25) / 25, mode="valid")
    return all(abs(sm[i - 25] - thresh) <= 1e-4 for i in (got, want) if i <= len(losses))


def test_convergence_row_matches_reference():
    from benchmarks import convergence as j_convergence

    want = j_convergence.run(T=400, repeats=1, workers=(8,))["rows"][0]
    got = convergence.run(T=400, repeats=1, workers=(8,), device="cpu",
                          params=_mlp_params_of_reference)["rows"][0]
    assert got["m"] == want["m"] == 8
    for name in convergence.NAMES:
        assert _same_or_tie(got[name], want[name], got["losses"][name][0], 0.35), name
    assert got["speedup_geom"] == pytest.approx(want["speedup_geom"])
    lines = []
    convergence.print_table({"rows": [got], "T": 400, "thresh": 0.35, "alpha_c": 0.3},
                            logger=lines.append)
    assert lines[0].startswith("== Fig 3") and lines[2].split()[0] == "8"


def test_ablation_matches_reference():
    from benchmarks import ablation_momentum as j_ablation

    want = j_ablation.run(m=8, T=300, repeats=1, threshs=(0.5, 0.35))["rows"]
    got = ablation_momentum.run(m=8, T=300, repeats=1, threshs=(0.5, 0.35), device="cpu",
                                params=_mlp_params_of_reference)["rows"]
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_cnn_example_runs_from_given_params(capsys):
    params = _bridge(JC.init_cnn(jax.random.PRNGKey(0), image=16))
    out = async_vs_sync_cnn.run(steps=60, device="cpu", params=params)
    assert torch.equal(params["conv1"]["w"], _bridge(JC.init_cnn(jax.random.PRNGKey(0),
                                                                 image=16))["conv1"]["w"])
    for tag in ("const", "mindthestep"):
        r = out[tag]
        assert len(r["losses"]) == 60 and np.isfinite(r["losses"]).all()
        assert r["iters"] == iters_to(r["losses"], 0.6)
    async_vs_sync_cnn.print_report(out)
    text = capsys.readouterr().out
    assert "AsyncPSGD (const)" in text and "MindTheStep" in text
