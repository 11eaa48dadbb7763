"""Port parity, model: forward logits, loss and the flat gradient of the
dense LM on the reference's own params (carried over by
``repro_torch.bridge``), on the same numpy batch, reduced stablelm-1.6b
(2 layers, d_model 256, vocab 512, f32 activations).

Tolerances (f32 round-off — the two frameworks sum matmuls and reductions in
other orders): logits 1e-5 absolute (their scale is ~4), loss 1e-5 relative,
flat gradient ``rtol=1e-5, atol=1e-5 * max|g|``.  Measured on this model:
loss equal, logits within 4e-6, gradient within 1.4e-6 of max|g|.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import lm_batches as j_lm_batches
from repro.models import model as JM
from repro.optim import transform as JT
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import lm_batches
from repro_torch.models import model as TM
from repro_torch.optim import transform as TT
from repro_torch.training import param_template, param_view


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref_params():
    cfg = j_reduced(j_get_config("stablelm-1.6b"))
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    keys, leaves, _ = _flatten_with_keys(params)
    return params, {k: np.asarray(v) for k, v in zip(keys, leaves)}


def test_template_matches_reference_tree(ref_params):
    """Same key paths, shapes and leaf order: the flat buffers line up
    element for element with the reference's ravel_pytree."""
    params, np_tree = ref_params
    cfg = reduced(get_config("stablelm-1.6b"))
    flat, template = bridge.params_from_jax(np_tree, cfg)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(JT.pack_flat(params)))
    assert template == param_template(cfg)
    back = bridge.params_to_numpy(flat, cfg)
    assert list(back) == list(np_tree)
    for k in np_tree:
        np.testing.assert_array_equal(back[k], np_tree[k])
    tree = param_view(flat, cfg)
    assert tree["stack"]["pos0"]["attn"]["wq"].shape == (2, 256, 4, 64)


def test_bridge_rejects_missing_names(ref_params):
    _, np_tree = ref_params
    partial = dict(np_tree)
    partial.pop("['final_norm']['bias']")
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_jax(partial, reduced(get_config("stablelm-1.6b")))


@pytest.mark.parametrize("remat", [False, True])
def test_logits_loss_and_flat_gradient_match_reference(ref_params, remat):
    params, np_tree = ref_params
    jcfg = dataclasses.replace(j_reduced(j_get_config("stablelm-1.6b")), remat=remat)
    tcfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")), remat=remat)
    flat, template = bridge.params_from_jax(np_tree, tcfg)
    # seq 64 with 32-wide attention blocks: the query- and KV-block loops run
    jb = next(j_lm_batches(jcfg.vocab_size, 2, 64, seed=0))
    tb = next(lm_batches(tcfg.vocab_size, 2, 64, seed=0))
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())

    jtemplate = jax.eval_shape(lambda k: j_init_params(k, jcfg), jax.random.PRNGKey(0))
    (jl, _), jg = jax.value_and_grad(
        lambda pf: JM.loss_fn(JT.flat_view(pf, jtemplate), jb, jcfg), has_aux=True
    )(JT.pack_flat(params))
    jlog, _ = JM.forward(params, jb, jcfg)

    leaf = flat.clone().requires_grad_(True)
    tl, metrics = TM.loss_fn(TT.flat_view(leaf, template), tb, tcfg)
    (tg,) = torch.autograd.grad(tl, leaf)
    with torch.no_grad():
        tlog, _ = TM.forward(TT.flat_view(flat, template), tb, tcfg)

    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    assert metrics["n_tokens"].item() == 2 * 63


def test_bridge_carries_adapt_tables_and_bf16_ring_bit_for_bit():
    import jax.numpy as jnp

    from repro.async_engine.delayed import init_flat_delayed
    from repro.training import default_adapt_setup as j_adapt_setup
    from repro.training import record_taus

    _, _, adapt = j_adapt_setup(0.05, 8, 8)
    adapt = record_taus(adapt, jnp.asarray([0, 3, 3, 9], jnp.int32))
    ta = bridge.adapt_from_jax(adapt.alpha_table, adapt.tau_cdf, adapt.hist)
    np.testing.assert_array_equal(ta.alpha_table.numpy(), np.asarray(adapt.alpha_table))
    np.testing.assert_array_equal(ta.tau_cdf.numpy(), np.asarray(adapt.tau_cdf))
    np.testing.assert_array_equal(ta.hist.numpy(), np.asarray(adapt.hist))
    assert (ta.alpha_table.dtype, ta.hist.dtype) == (torch.float32, torch.int32)

    ring = init_flat_delayed({"w": jnp.zeros(37)}, 4, dtype=jnp.bfloat16)
    vals = np.random.default_rng(0).standard_normal((4, 37)).astype(np.float32)
    jring = jnp.asarray(vals).astype(jnp.bfloat16)
    td = bridge.delayed_from_jax(np.asarray(jring), ring.step + 5)
    assert td.ring.dtype == torch.bfloat16 and int(td.step) == 5
    np.testing.assert_array_equal(td.ring.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jring).view(np.uint16))


def test_make_batch_for_matches_reference():
    from repro.data import make_batch_for as j_make_batch_for
    from repro_torch.data import make_batch_for

    jcfg, tcfg = j_reduced(j_get_config("stablelm-1.6b")), reduced(get_config("stablelm-1.6b"))
    jb, tb = j_make_batch_for(jcfg, batch=2, seq=16, seed=3), make_batch_for(tcfg, batch=2, seq=16, seed=3)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
