"""Port parity, Mixture-of-Experts: ``repro_torch.models.moe`` and the MoE
trunk against the reference's single-device path (``src/repro/models/moe.py``,
``rules is None``), on reduced qwen2-moe-a2.7b (a shared expert; 4 experts,
and a padded variant of 6 real experts in 8 slots, so the router's -1e30
mask runs) and reduced qwen3-moe-235b-a22b (no shared expert, 4 query heads
over 4 KV heads at reduced size), in f32, with the reference's own params
carried over by ``repro_torch.bridge`` and the same numpy inputs.

Tolerances, each with its reason:
* ``capacity_for``, the slot assignment, the top-k expert ids and the set of
  dropped (token, choice) entries: exactly equal (integers; the router's f32
  probabilities agree far inside their gaps);
* ``apply_moe``'s output and aux loss: 1e-5 absolute (f32 round-off of the
  products' summation order);
* ``loss_fn``'s ce, aux and loss, and the gradient of every leaf: 1e-5
  relative to the leaf's largest element (f32 round-off);
* prefill logits, every cache leaf and 8 greedy steps' logits: 1e-4
  absolute, ids equal (the serving tests' bound);
* a 3-tick ``run(RunSpec(mode="async", fuse=True))``, tick by tick with the
  reference's uniforms injected: taus and alphas equal, loss 1e-6 relative,
  params and ring 1e-6 absolute (``tests/test_torch_run.py``'s bounds).
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
from repro.data import make_batch_for as j_make_batch_for
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro.run.hooks import Hook as JHook
from repro.training import default_adapt_setup as j_adapt_setup
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import transform as TT
from repro_torch.run import Hook, RunSpec, run
from repro_torch.training import default_adapt_setup, make_serve_step, param_view
from repro_torch.tree import keystr, tree_map, tree_paths

PROMPT, GEN = 48, 8
TOL = dict(rtol=0, atol=1e-4)
VARIANTS = {  # name -> (arch, config overrides on top of reduced())
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen2-moe-padded": ("qwen2-moe-a2.7b", dict(num_experts=6, num_experts_padded=8)),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _numpy_tree(tree) -> dict:
    keys, leaves, _ = _flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(name):
    arch, upd = VARIANTS[name]
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **upd),
            dataclasses.replace(reduced(get_config(arch)), **upd))


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat, _ = bridge.params_from_jax(_numpy_tree(jparams), tcfg)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=param_view(flat, tcfg))


def _moe_params(model):
    """The first layer's MoE params, both sides."""
    return (jax.tree.map(lambda a: a[0], model["jparams"]["stack"]["pos0"]["moe"]),
            tree_map(lambda t: t[0], model["tparams"]["stack"]["pos0"]["moe"]))


def _x(T, D, seed=3):
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


def _jax_route(xt, p, cfg):
    """The reference's router lines (``moe.py:106-111``), for the ids."""
    logits = jnp.einsum("td,de->te", xt, p["router"])
    if cfg.experts_padded != cfg.num_experts:
        pad = np.zeros((cfg.experts_padded,), np.float32)
        pad[cfg.num_experts:] = -1e30
        logits = logits + pad
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)


@pytest.mark.parametrize("tokens", [1, 4, 7, 96, 2048])
@pytest.mark.parametrize("experts,top_k,cf", [(4, 2, 1.25), (64, 4, 1.25), (128, 8, 1.25),
                                              (8, 2, 0.3), (60, 4, 1.0)])
def test_capacity_for_equals_reference(tokens, experts, top_k, cf):
    got = TMOE.capacity_for(tokens, experts, top_k, cf)
    assert isinstance(got, int)
    assert got == JMOE.capacity_for(tokens, experts, top_k, cf)


@pytest.mark.parametrize("T,K,E", [(16, 2, 4), (97, 4, 64), (5, 8, 128)])
def test_slot_assignment_equals_reference(T, K, E):
    idx = np.random.default_rng(T).integers(0, E, size=(T, K)).astype(np.int32)
    jpos, jcounts = JMOE._slot_assignment(jnp.asarray(idx), E)
    tpos, tcounts = TMOE._slot_assignment(torch.from_numpy(idx).long(), E)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))


def test_topk_ids_equal_reference(model):
    jp, tp = _moe_params(model)
    cfg = model["tcfg"]
    x = _x(64, cfg.d_model)
    jtop_p, jidx = _jax_route(jnp.asarray(x), jp, model["jcfg"])
    _, ttop_p, tidx = TMOE.route(torch.from_numpy(x), tp, cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if cfg.experts_padded != cfg.num_experts:
        assert int(tidx.max()) < cfg.num_experts  # a padded expert is never chosen
    jnorm = jtop_p / jnp.maximum(jtop_p.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(ttop_p.numpy(), np.asarray(jnorm), rtol=0, atol=1e-6)


def test_apply_moe_matches_reference(model):
    jp, tp = _moe_params(model)
    x = np.random.default_rng(4).normal(size=(2, 24, model["tcfg"].d_model)).astype(np.float32)
    jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), model["jcfg"])
    tout, taux = TMOE.apply_moe(tp, torch.from_numpy(x), model["tcfg"])
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen2-moe", "qwen3-moe"])
def test_dropped_tokens_equal_reference(name):
    """capacity_factor 0.25: C = 4 slots an expert for 2 x 16 tokens x top-2
    over 4 experts, so at least 48 of the 64 entries are dropped; the dropped
    set and the output agree."""
    jcfg, tcfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    tparams = param_view(bridge.params_from_jax(_numpy_tree(jparams), tcfg)[0], tcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["pos0"]["moe"])
    tp = tree_map(lambda t: t[0], tparams["stack"]["pos0"]["moe"])
    x = np.random.default_rng(5).normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    T = 32
    C = TMOE.capacity_for(T, tcfg.experts_padded, tcfg.top_k, tcfg.capacity_factor)
    assert C == JMOE.capacity_for(T, jcfg.experts_padded, jcfg.top_k, jcfg.capacity_factor) == 4

    _, jidx = _jax_route(jnp.asarray(x.reshape(T, -1)), jp, jcfg)
    jpos, _ = JMOE._slot_assignment(jidx, jcfg.experts_padded)
    _, _, tidx = TMOE.route(torch.from_numpy(x.reshape(T, -1)), tp, tcfg)
    tpos, _ = TMOE._slot_assignment(tidx, tcfg.experts_padded)
    jdrop, tdrop = np.asarray(jpos) >= C, (tpos >= C).numpy()
    np.testing.assert_array_equal(tdrop, jdrop)
    assert 0 < tdrop.sum() < tdrop.size

    jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    tout, taux = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=0, atol=1e-5)


def test_loss_and_gradient_match_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jbatch = j_make_batch_for(jcfg, batch=2, seq=32, seed=2)
    tbatch = make_batch_for(tcfg, batch=2, seq=32, seed=2)
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jcfg), has_aux=True)(model["jparams"])
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), model["tparams"])
    tloss, tm = TM.loss_fn(leaves, tbatch, tcfg)
    tloss.backward()
    assert float(jm["aux"]) > 0.5  # a real load-balance term (1.0 when balanced)
    for key, got, want in (("loss", tloss, jloss), ("ce", tm["ce"], jm["ce"]),
                           ("aux", tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, err_msg=key)
    ce, aux = float(tm["ce"].detach()), float(tm["aux"].detach())
    np.testing.assert_allclose(float(tloss.detach()), ce + tcfg.router_aux_coef * aux, rtol=1e-6)
    want = _numpy_tree(jgrad)
    got = {keystr(path): leaf.grad.numpy() for path, leaf in tree_paths(leaves)}
    assert sorted(got) == sorted(want)
    assert any("['moe']" in k for k in got)
    for name, g in got.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-5 * scale, err_msg=name)


def test_prefill_and_greedy_decode_match_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jbatch = j_make_batch_for(jcfg, batch=2, seq=PROMPT, seed=0)
    tbatch = make_batch_for(tcfg, batch=2, seq=PROMPT, seed=0)
    cap = PROMPT + GEN
    jl, jcache = JM.prefill(model["jparams"], jbatch, jcfg, cap, cache_dtype=jnp.float32)
    tl, tcache = TM.prefill(model["tparams"], tbatch, tcfg, cap, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jstep, tstep = jax.jit(j_make_serve_step(jcfg)), make_serve_step(tcfg)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for i in range(GEN):
        jo = jstep(model["jparams"], jcache, jtok, jnp.int32(PROMPT + i))
        to = tstep(model["tparams"], tcache, ttok, PROMPT + i)
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), **TOL)
        np.testing.assert_array_equal(to["next_token"].numpy(), np.asarray(jo["next_token"]))
        jtok, jcache, ttok, tcache = jo["next_token"], jo["cache"], to["next_token"], to["cache"]
    want = _numpy_tree(jcache)
    for path, leaf in tree_paths(tcache):
        np.testing.assert_allclose(leaf.numpy(), want[keystr(path)], **TOL, err_msg=keystr(path))


# ---------------------------------------------------------------------------
# The paper's algorithm through the MoE objective
# ---------------------------------------------------------------------------

W, K, LR, STEPS = 4, 4, 0.05, 3


class _JRec(JHook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m = ctx.metrics
        self.rows.append(dict(loss=float(m["loss"]), tau=float(m["tau_mean"]),
                              alpha=float(m["alpha_mean"]), p=np.array(ctx.state.params),
                              ring=np.array(ctx.state.delayed.ring)))


class _TRec(Hook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m, s = ctx.metrics, ctx.state
        self.rows.append(dict(loss=m["loss"].item(), tau=m["tau_mean"].item(),
                              alpha=m["alpha_mean"].item(), p=s.params.numpy().copy(),
                              ring=s.delayed.ring.numpy().copy()))


def test_async_fused_run_on_moe_matches_reference_tick_by_tick():
    jcfg, tcfg = _configs("qwen2-moe")
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    sched, _, adapt = j_adapt_setup(LR, W, K)
    pipe = JT.chain(JT.scale_by_staleness(sched, LR, m=W, tau_max=adapt.tau_max),
                    JT.scale(-LR), JT.trace(0.9))
    jrec = _JRec()
    j_run(JSpec(cfg=jcfg, pipeline=pipe, mode="async", num_steps=STEPS, batch_size=2, seq_len=16,
                num_workers=W, ring=K, adapt=adapt, fuse=True, params=params, seed=0),
          hooks=[jrec])
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    draws = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    it = iter(draws)

    flat, _ = bridge.params_from_jax(_numpy_tree(params), tcfg)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    tpipe = TT.chain(TT.scale_by_staleness(tsched, LR, m=W, tau_max=tadapt.tau_max),
                     TT.scale(-LR), TT.trace(0.9))
    trec = _TRec()
    run(RunSpec(cfg=tcfg, pipeline=tpipe, mode="async", num_steps=STEPS, batch_size=2, seq_len=16,
                num_workers=W, ring=K, adapt=tadapt, fuse=True, params=flat, seed=0,
                device="cpu", tau_source=lambda: torch.from_numpy(next(it))), hooks=[trec])
    assert len(jrec.rows) == len(trec.rows) == STEPS
    for i, (a, b) in enumerate(zip(jrec.rows, trec.rows)):
        assert a["tau"] == b["tau"] and a["alpha"] == b["alpha"], f"tick {i + 1}"
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6, err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-6, err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["ring"], a["ring"], rtol=0, atol=1e-6,
                                   err_msg=f"tick {i + 1}")
    assert np.abs(trec.rows[-1]["p"] - flat.numpy()).max() > 1e-4  # the params moved
