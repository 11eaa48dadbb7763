"""``init_train_state`` stores params in ``cfg.param_dtype``, as the reference
does (``src/repro/training/steps.py::init_train_state``): every f32 leaf is
cast before the flat-native decision, the optimizer state and the ring.
With ``param_dtype="bfloat16"`` the params are a bf16 tree (not flat-native),
the ring is bf16 (``ring_dtype_for``) and the fused optimizer state keeps no
resident f32 copy; the default f32 config keeps its layout.

The trajectory test runs reduced stablelm-1.6b (d_model 128), async
momentum, W = K = 4, refresh every 3, 6 ticks, fused and unfused, in both
packages from the reference's params (``bridge``), numpy batches and the
reference's own uniforms (``RunSpec.tau_source``), tick by tick.

Tolerances, each with its reason (the f32 run test's, widened only by bf16
rounding).  Both packages differentiate through bf16 leaves, so each
gradient is bf16, summed in another order in each package; the ring holds
it, and the bf16 params take an f32 update rounded back to bf16:
* taus: exactly equal (same uniforms, same tables);
* params and ring, per leaf: every element within two bf16 ulps of the
  leaf's largest value, ``|d| <= 2**-6 max|ref|`` (measured 6.1e-3
  max|ref|), and at most 0.5 % of the elements farther than one bf16 ulp of
  their own value, ``|d| > 1e-6 + 2**-7 |ref|`` (measured 0.08 % of the
  ring, 0.005 % of the params);
* loss: 1e-5 relative (the f32 test's 1e-6, widened because the few params
  one ulp apart move the loss; measured 3.1e-6 at tick 6).
Inside the port the fused trajectory is bitwise equal to the unfused one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro.run.hooks import Hook as JHook
from repro.training import default_adapt_setup as j_adapt_setup
from repro.training import init_params as j_init_params
from repro.training import init_train_state as j_init_train_state
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.optim import transform as TT
from repro_torch.run import Hook, RunSpec, run
from repro_torch.training import default_adapt_setup, init_train_state, param_template
from repro_torch.tree import tree_leaves

W, K, LR, STEPS = 4, 4, 0.05, 6
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to |x| (8 significant bits)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(param_dtype):
    j = dataclasses.replace(j_reduced(j_get_config("stablelm-1.6b"), d_model=128),
                            param_dtype=param_dtype)
    t = dataclasses.replace(reduced(get_config("stablelm-1.6b"), d_model=128),
                            param_dtype=param_dtype)
    return j, t


def _j_pipe(sched, adapt):
    return JT.chain(JT.scale_by_staleness(sched, LR, m=W, tau_max=adapt.tau_max),
                    JT.scale(-LR), JT.trace(0.9))


def _t_pipe(sched, adapt):
    return TT.chain(TT.scale_by_staleness(sched, LR, m=W, tau_max=adapt.tau_max),
                    TT.scale(-LR), TT.trace(0.9))


def _j_f32(tree):
    return [np.asarray(leaf.astype(jnp.float32)) for leaf in jax.tree.leaves(tree)]


def _t_f32(tree):
    return [leaf.float().numpy().copy() for leaf in tree_leaves(tree)]


class _JRec(JHook):
    def __init__(self):
        self.rows, self.state = [], None

    def on_tick(self, ctx):
        self.state = ctx.state
        self.rows.append(dict(loss=float(ctx.metrics["loss"]), tau=float(ctx.metrics["tau_mean"]),
                              p=_j_f32(ctx.state.params), ring=_j_f32(ctx.state.delayed.ring)))


class _TRec(Hook):
    def __init__(self):
        self.rows, self.state = [], None

    def on_tick(self, ctx):
        self.state = ctx.state
        self.rows.append(dict(loss=ctx.metrics["loss"].item(), tau=ctx.metrics["tau_mean"].item(),
                              p=_t_f32(ctx.state.params), ring=_t_f32(ctx.state.delayed.ring)))


def _reference_params():
    jcfg, tcfg = _cfgs("bfloat16")
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    return params, flat


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def trajectories(request):
    fuse = request.param
    jcfg, tcfg = _cfgs("bfloat16")
    params, flat = _reference_params()
    sched, _, adapt = j_adapt_setup(LR, W, K)
    jrec = _JRec()
    j_run(JSpec(cfg=jcfg, pipeline=_j_pipe(sched, adapt), mode="async", num_steps=STEPS,
                batch_size=2, seq_len=32, num_workers=W, ring=K, adapt=adapt, fuse=fuse,
                refresh_every=3, params=params, seed=0), hooks=[jrec])

    _, rng = jax.random.split(jax.random.PRNGKey(0))
    draws = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    it = iter(draws)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    trec = _TRec()
    run(RunSpec(cfg=tcfg, pipeline=_t_pipe(tsched, tadapt), mode="async", num_steps=STEPS,
                batch_size=2, seq_len=32, num_workers=W, ring=K, adapt=tadapt, fuse=fuse,
                refresh_every=3, params=flat, seed=0, device="cpu",
                tau_source=lambda: torch.from_numpy(next(it))), hooks=[trec])
    return fuse, jrec, trec


def _bf16_close(got, want, what):
    n_far, total = 0, 0
    for g, w in zip(got, want):
        d = np.abs(g - w)
        scale = np.abs(w).max()
        assert d.max() <= 2 * BF16_ULP * scale, f"{what}: |d| {d.max()} of max|ref| {scale}"
        n_far += int((d > 1e-6 + BF16_ULP * np.abs(w)).sum())
        total += w.size
    assert n_far <= 5e-3 * total, f"{what}: {n_far} of {total} elements past one bf16 ulp"


def test_bf16_params_match_reference_tick_by_tick(trajectories):
    _, jrec, trec = trajectories
    assert len(jrec.rows) == len(trec.rows) == STEPS
    for i, (a, b) in enumerate(zip(jrec.rows, trec.rows)):
        assert a["tau"] == b["tau"], f"tick {i + 1}"
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5, err_msg=f"tick {i + 1}")
        _bf16_close(b["p"], a["p"], f"params, tick {i + 1}")
        _bf16_close(b["ring"], a["ring"], f"ring, tick {i + 1}")
    assert max(np.abs(x - y).max() for x, y in zip(trec.rows[-1]["p"], trec.rows[0]["p"])) > 1e-3


def test_bf16_layout_matches_reference(trajectories):
    fuse, jrec, trec = trajectories
    js, ts = jrec.state, trec.state
    assert isinstance(js.params, dict) and isinstance(ts.params, dict)  # not flat-native
    assert {str(x.dtype) for x in jax.tree.leaves(js.params)} == {"bfloat16"}
    assert {x.dtype for x in tree_leaves(ts.params)} == {torch.bfloat16}
    assert {str(x.dtype) for x in jax.tree.leaves(js.delayed.ring)} == {"bfloat16"}
    assert {x.dtype for x in tree_leaves(ts.delayed.ring)} == {torch.bfloat16}
    assert isinstance(ts.delayed.ring, torch.Tensor) == fuse
    if fuse:
        assert js.opt_state["p"] is None and ts.opt_state["p"] is None
        assert ts.opt_state["bufs"].dtype == torch.float32


def test_fused_equals_unfused_inside_the_port_with_bf16_params():
    _, tcfg = _cfgs("bfloat16")
    _, flat = _reference_params()
    finals = {}
    for fuse in (True, False):
        draws = iter(np.random.default_rng(0).random((4, W)).astype(np.float32))
        tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
        rec = _TRec()
        run(RunSpec(cfg=tcfg, pipeline=_t_pipe(tsched, tadapt), mode="async", num_steps=4,
                    batch_size=2, seq_len=32, num_workers=W, ring=K, adapt=tadapt, fuse=fuse,
                    refresh_every=2, params=flat, seed=0, device="cpu",
                    tau_source=lambda: torch.from_numpy(next(draws))), hooks=[rec])
        finals[fuse] = rec.rows
    for a, b in zip(finals[True], finals[False]):
        assert a["loss"] == b["loss"]
        for x, y in zip(a["p"], b["p"]):
            np.testing.assert_array_equal(x, y)
        flat_ring = np.concatenate([r.reshape(K, -1) for r in b["ring"]], axis=1)
        np.testing.assert_array_equal(a["ring"][0], flat_ring)


@pytest.mark.parametrize("given", ["tree", "packed"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_init_casts_params_as_the_reference(given, fuse):
    """A tree or a packed f32 buffer from ``bridge`` comes out as the
    reference's bf16 tree, bit for bit, with a bf16 ring."""
    jcfg, tcfg = _cfgs("bfloat16")
    params, flat = _reference_params()
    sched, _, adapt = j_adapt_setup(LR, W, K)
    js = j_init_train_state(jax.random.PRNGKey(0), jcfg, _j_pipe(sched, adapt), async_ring=K,
                            adapt=adapt, params=params, fuse=fuse)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    tparams = flat if given == "packed" else TT.flat_view(flat, param_template(tcfg))
    ts = init_train_state(tcfg, _t_pipe(tsched, tadapt), device="cpu", async_ring=K,
                          adapt=tadapt, params=tparams, fuse=fuse)
    assert isinstance(ts.params, dict)
    for a, b in zip(jax.tree.leaves(js.params), tree_leaves(ts.params)):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a.astype(jnp.float32)))
    assert {x.dtype for x in tree_leaves(ts.delayed.ring)} == {torch.bfloat16}
    assert str(jax.tree.leaves(js.delayed.ring)[0].dtype) == "bfloat16"


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_default_f32_config_keeps_its_layout(fuse):
    """The repair changes nothing for the default ``param_dtype="float32"``:
    fused is flat-native f32 with an f32 ring, unfused an f32 tree, as the
    reference."""
    jcfg, tcfg = _cfgs("float32")
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    sched, _, adapt = j_adapt_setup(LR, W, K)
    js = j_init_train_state(jax.random.PRNGKey(0), jcfg, _j_pipe(sched, adapt), async_ring=K,
                            adapt=adapt, params=params, fuse=fuse)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    ts = init_train_state(tcfg, _t_pipe(tsched, tadapt), device="cpu", async_ring=K,
                          adapt=tadapt, params=flat, fuse=fuse)
    flat_native = isinstance(js.params, jax.Array)
    assert flat_native == fuse and isinstance(ts.params, torch.Tensor) == fuse
    assert {x.dtype for x in tree_leaves(ts.params)} == {torch.float32}
    assert {x.dtype for x in tree_leaves(ts.delayed.ring)} == {torch.float32}
    assert str(jax.tree.leaves(js.delayed.ring)[0].dtype) == "float32"
    got = TT.pack_flat(ts.params).numpy()
    np.testing.assert_array_equal(got, np.asarray(JT.pack_flat(js.params)))
