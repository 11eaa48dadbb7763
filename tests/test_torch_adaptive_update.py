"""Port parity: the adaptive_update kernel family's plain PyTorch versions
(``repro_torch.kernels.adaptive_update.ref``, the CPU path of every wrapper)
against the JAX oracles (``repro.kernels.adaptive_update.ref``) AND against
the Pallas kernels run in interpret mode, as ``tests/test_fuse.py`` runs
them.  Same numpy inputs go to both packages.

Tolerances (the reference's Pallas bounds):
* 1e-6 rel/abs for the chain and tick results — the port's plain combine
  sums worker by worker like the JAX oracle; the Pallas tick folds same-slot
  workers first and XLA may contract multiply-adds, so only round-off
  separates them;
* 1e-5 for the bf16-ring combine (bf16 slot values, f32 sum);
* bf16 ring bits and the ``live`` mask exactly equal.

On the card the wrappers launch the hand-written kernels; that comparison
(kernel against plain version at full width) is ``chip_smoke.py``'s, and the
``cuda``-marked test below runs it at a small size where a card exists.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine.delayed import DelayedGradients as JDelayed
from repro.async_engine.delayed import delayed_combine as j_delayed_combine
from repro.kernels.adaptive_update import fused as JF
from repro.kernels.adaptive_update import ref as JR
from repro.kernels.adaptive_update.ops import adaptive_update as j_adaptive_update_pallas
from repro_torch.kernels.adaptive_update import cuda as C
from repro_torch.kernels.adaptive_update import ref as TR

TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scalars(**kw):
    base = {"f_stale": 1.3, "f_keep": 1.0, "f_clip": 0.7, "m_scale": -0.05}
    base.update(kw)
    return base


ADAM = dict(b1=0.9, omb1=0.1, b2=0.999, omb2=0.001, eps=1e-8, c1=10.0, c2=1000.0)
FAMILY_SCALARS = {"sgd": _scalars(), "momentum": _scalars(mu=0.9), "adam": _scalars(**ADAM)}


def _js(s):
    return {k: jnp.float32(v) for k, v in s.items()}


def _ts(s):
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in s.items()}


def _state(kind, n, rng):
    m = rng.standard_normal(n).astype(np.float32)
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    if kind == "sgd":
        return (), ()
    if kind == "momentum":
        return jnp.asarray(m), _t(m)
    return {"m": jnp.asarray(m), "v": jnp.asarray(v)}, {"m": _t(m), "v": _t(v)}


def _bufs_close(jb, tb, **tol):
    if isinstance(tb, dict):
        for k in tb:
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), **tol)
    elif isinstance(tb, torch.Tensor):
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **tol)


def _tick_data(n=9001, K=8, W=4, taus=(0, 2, 5, 2), seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        p=rng.standard_normal(n).astype(np.float32),
        g=rng.standard_normal(n).astype(np.float32),
        ring=rng.standard_normal((K, n)).astype(np.float32),
        step=11,
        taus=np.asarray(taus, np.int32),
        weights=rng.uniform(0.1, 1.0, W).astype(np.float32),
        rng=rng,
    )


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_chain_plain_matches_jax_ref_and_pallas(kind):
    rng = np.random.default_rng(0)
    n = 70001
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    jb, tb = _state(kind, n, rng)
    s = FAMILY_SCALARS[kind]
    tp, tbn = TR.fused_chain_ref(kind, _t(p), _t(g), tb, _ts(s))
    jp, jbn = JR.fused_chain_ref(kind, jnp.asarray(p), jnp.asarray(g), jb, _js(s))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    _bufs_close(jbn, tbn, **TOL)
    kernel_bufs = () if kind == "sgd" else ((jb,) if kind == "momentum" else (jb["m"], jb["v"]))
    pk, bk = JF.fused_chain_call(kind, jnp.asarray(p), jnp.asarray(g), kernel_bufs, _js(s), interpret=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(pk), **TOL)
    if kind == "momentum":
        np.testing.assert_allclose(tbn.numpy(), np.asarray(bk[0]), **TOL)
    if kind == "adam":
        np.testing.assert_allclose(tbn["m"].numpy(), np.asarray(bk[0]), **TOL)
        np.testing.assert_allclose(tbn["v"].numpy(), np.asarray(bk[1]), **TOL)


@pytest.mark.parametrize("ring_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_tick_plain_matches_jax_ref_and_pallas(kind, ring_dtype):
    d = _tick_data()
    jb, tb = _state(kind, d["p"].shape[0], d["rng"])
    s = FAMILY_SCALARS[kind]
    jring = jnp.asarray(d["ring"]).astype(jnp.bfloat16 if ring_dtype == "bfloat16" else jnp.float32)
    tring = _t(d["ring"]).to(getattr(torch, ring_dtype))
    tp, tbn, tr, tl = TR.fused_tick_ref(
        kind, _t(d["p"]), _t(d["g"]), tb, _ts(s), tring,
        torch.tensor(d["step"], dtype=torch.int32), _t(d["taus"]), _t(d["weights"]),
    )
    args = (jnp.asarray(d["p"]), jnp.asarray(d["g"]), jb, _js(s), jring,
            jnp.int32(d["step"]), jnp.asarray(d["taus"]), jnp.asarray(d["weights"]))
    jp, jbn, jr, jl = JR.fused_tick_ref(kind, *args)
    kp, kb, kr, kl = JF.fused_tick_flat(kind, *args, use_pallas=True, interpret=True)
    for other_p, other_b, other_r, other_l in ((jp, jbn, jr, jl), (kp, kb, kr, kl)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(other_p), **TOL)
        _bufs_close(other_b, tbn, **TOL)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(other_l))
        if ring_dtype == "bfloat16":
            np.testing.assert_array_equal(
                tr.view(torch.int16).numpy().view(np.uint16), np.asarray(other_r).view(np.uint16)
            )
        else:
            np.testing.assert_array_equal(tr.numpy(), np.asarray(other_r))


@pytest.mark.parametrize("ring_dtype", ["float32", "bfloat16"])
def test_combine_plain_with_dead_workers_matches_jax(ring_dtype):
    """Worker 1 has tau >= K (dead), and the step is young enough that the
    source steps of workers 2 and 3 predate the run (dead too)."""
    d = _tick_data(taus=(0, 9, 5, 4), seed=3)
    d["step"] = 3
    jring = jnp.asarray(d["ring"]).astype(jnp.bfloat16 if ring_dtype == "bfloat16" else jnp.float32)
    tring = _t(d["ring"]).to(getattr(torch, ring_dtype))
    tg, tl, tr = TR.fused_combine_ref(_t(d["g"]), tring, torch.tensor(d["step"], dtype=torch.int32),
                                      _t(d["taus"]), _t(d["weights"]))
    args = (jnp.asarray(d["g"]), jring, jnp.int32(d["step"]), jnp.asarray(d["taus"]),
            jnp.asarray(d["weights"]))
    jg, jl, jstate = j_delayed_combine(JDelayed(ring=args[1], step=args[2]), args[0], args[3], args[4])
    kg, kl, kr = JF.fused_combine_flat(*args, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(tl.numpy(), np.array([1.0, 0.0, 0.0, 0.0], np.float32))
    tol = BF16_TOL if ring_dtype == "bfloat16" else TOL
    for og, ol, orr in ((jg, jl, jstate.ring), (kg, kl, kr)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(og), **tol)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(ol))
        if ring_dtype == "bfloat16":
            np.testing.assert_array_equal(tr.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(orr).view(np.uint16))
        else:
            np.testing.assert_array_equal(tr.numpy(), np.asarray(orr))


def test_update_plain_matches_jax_ref_and_pallas():
    rng = np.random.default_rng(5)
    n = 70001
    p, g, v = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    tp, tv = TR.adaptive_update_ref(_t(p), _t(g), _t(v), torch.tensor(0.05), torch.tensor(0.9))
    jp, jv = JR.adaptive_update_ref(jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
                                    jnp.float32(0.05), jnp.float32(0.9))
    kp, kv = j_adaptive_update_pallas(jnp.asarray(p), jnp.asarray(g), jnp.asarray(v), 0.05, 0.9,
                                      interpret=True)
    for op, ov in ((jp, jv), (kp, kv)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(op), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(ov), **TOL)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_port_fused_tick_equals_unfused_bitwise(kind):
    """The port's fused tick (the wrapper, CPU path, in place) is bitwise the
    unfused ring ops followed by the link-by-link chain body."""
    d = _tick_data(n=997)
    _, tb = _state(kind, 997, d["rng"])
    s = _ts(FAMILY_SCALARS[kind])
    step, taus, w = torch.tensor(11, dtype=torch.int32), _t(d["taus"]), _t(d["weights"])
    g_eff, live_u, ring_u = TR.fused_combine_ref(_t(d["g"]), _t(d["ring"]), step, taus, w)
    p_u, b_u = TR.fused_chain_ref(kind, _t(d["p"]), g_eff, tb, s)
    p_f, ring_f = _t(d["p"]), _t(d["ring"])
    b_f = {k: v.clone() for k, v in tb.items()} if isinstance(tb, dict) else (
        tb.clone() if isinstance(tb, torch.Tensor) else ())
    live_f = C.fused_tick(kind, p_f, _t(d["g"]), b_f, s, ring_f, step, taus, w)
    assert torch.equal(p_u, p_f) and torch.equal(ring_u, ring_f) and torch.equal(live_u, live_f)
    if isinstance(b_u, dict):
        assert all(torch.equal(b_u[k], b_f[k]) for k in ("m", "v"))
    elif isinstance(b_u, torch.Tensor):
        assert torch.equal(b_u, b_f)


def test_cpu_wrappers_count_no_launches():
    """The CPU path runs the plain version and counts nothing."""
    C.reset_launches()
    d = _tick_data(n=64)
    C.fused_tick("sgd", _t(d["p"]), _t(d["g"]), (), _ts(_scalars()), _t(d["ring"]),
                 torch.tensor(1, dtype=torch.int32), _t(d["taus"]), _t(d["weights"]))
    C.fused_update(_t(d["p"]), _t(d["g"]), _t(d["p"]), torch.tensor(0.1), torch.tensor(0.9))
    C.fused_chain("momentum", _t(d["p"]), _t(d["g"]), _t(d["g"]), _ts(_scalars(mu=0.9)))
    assert C.LAUNCHES == {"fused_tick": 0, "fused_chain": 0, "fused_combine": 0, "fused_update": 0}


def test_wrapper_rejects_unknown_family():
    with pytest.raises(ValueError, match="unknown fused-chain kind"):
        C.fused_chain("lion", torch.zeros(8), torch.zeros(8), (), {})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ring_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_tick_kernel_matches_plain_on_card(cuda_device, kind, ring_dtype):
    d = _tick_data(n=100003)
    _, tb = _state(kind, 100003, d["rng"])
    s = _ts(FAMILY_SCALARS[kind])
    dev = cuda_device
    on = lambda t: t.to(dev)  # noqa: E731
    step, taus, w = (on(torch.tensor(11, dtype=torch.int32)), on(_t(d["taus"])), on(_t(d["weights"])))
    ring = on(_t(d["ring"]).to(ring_dtype))
    p_ref, b_ref, r_ref, l_ref = TR.fused_tick_ref(
        kind, on(_t(d["p"])), on(_t(d["g"])),
        {k: on(v) for k, v in tb.items()} if isinstance(tb, dict) else (on(tb) if isinstance(tb, torch.Tensor) else ()),
        s, ring.clone(), step, taus, w)
    p = on(_t(d["p"]))
    b = {k: on(v) for k, v in tb.items()} if isinstance(tb, dict) else (on(tb) if isinstance(tb, torch.Tensor) else ())
    live = C.fused_tick(kind, p, on(_t(d["g"])), b, s, ring, step, taus, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(p, p_ref, **TOL)
    assert torch.equal(live, l_ref)
    assert torch.equal(ring.view(torch.int16) if ring_dtype == torch.bfloat16 else ring,
                       r_ref.view(torch.int16) if ring_dtype == torch.bfloat16 else r_ref)
