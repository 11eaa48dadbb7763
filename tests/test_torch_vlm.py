"""Port parity, the vlm prefix: reduced internvl2-2b (2 layers, d_model 256,
4 query heads over 4 KV heads at reduced size, 8 prefix embeddings, f32)
against the reference, with the reference's own params carried over by
``repro_torch.bridge`` and the same numpy batch (tokens and
``prefix_embeds``).

* ``forward``: the prefix rows leave the logits, so they align with the
  tokens; within 1e-5 of the reference's (f32 round-off), and ``loss_fn``
  the same to 1e-6 relative.
* prefill and 8 greedy steps: the reference driven with the right capacity
  (P + S + gen) and start (P + S); last logits and every step's within 1e-4,
  ids equal.
* the serving launcher: the reference launcher's arithmetic (capacity
  ``S + gen``, start ``S``) trips its own prefill's capacity check for
  ``gen`` < P; the port's launcher sizes the cache ``P + S + gen``, starts at
  ``P + S`` and gives, step for step, what the reference's own
  ``prefill`` / ``decode_step`` give when driven that way.
"""

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
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import serve
from repro_torch.models import model as TM
from repro_torch.training import param_view

ARCH, SEQ = "internvl2-2b", 24
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _numpy_tree(tree) -> dict:
    keys, leaves, _ = _flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    assert tcfg.num_prefix_embeddings == 8
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat, _ = bridge.params_from_jax(_numpy_tree(jparams), tcfg)
    jbatch = j_make_batch_for(jcfg, batch=2, seq=SEQ, seed=0)
    tbatch = make_batch_for(tcfg, batch=2, seq=SEQ, seed=0)
    for key in ("tokens", "labels", "prefix_embeds"):
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]), err_msg=key)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=param_view(flat, tcfg),
                jbatch=jbatch, tbatch=tbatch, P=tcfg.num_prefix_embeddings)


def test_forward_logits_align_with_tokens_and_match_reference(model):
    jlogits, _ = JM.forward(model["jparams"], model["jbatch"], model["jcfg"])
    with torch.no_grad():
        tlogits, aux = TM.forward(model["tparams"], model["tbatch"], model["tcfg"])
        loss, metrics = TM.loss_fn(model["tparams"], model["tbatch"], model["tcfg"])
        # the prefix changes the logits: it is attended to, not ignored
        bare, _ = TM.forward(model["tparams"], {"tokens": model["tbatch"]["tokens"]},
                             model["tcfg"])
    assert tlogits.shape == (2, SEQ, model["tcfg"].vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert float((tlogits - bare).abs().max()) > 1e-2
    jloss, jm = JM.loss_fn(model["jparams"], model["jbatch"], model["jcfg"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(metrics["n_tokens"]) == float(jm["n_tokens"]) == 2 * (SEQ - 1)


def _reference_serve(model, gen):
    """The reference's own prefill / decode_step with capacity P + S + gen and
    positions from P + S."""
    jcfg, start = model["jcfg"], model["P"] + SEQ
    jl, jcache = JM.prefill(model["jparams"], model["jbatch"], jcfg, start + gen,
                            cache_dtype=jnp.float32)
    jstep = jax.jit(j_make_serve_step(jcfg))
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    logits, ids = [], []
    for i in range(gen):
        out = jstep(model["jparams"], jcache, tok, jnp.int32(start + i))
        tok, jcache = out["next_token"], out["cache"]
        logits.append(np.asarray(out["logits"]))
        ids.append(np.asarray(tok))
    return np.asarray(jl), np.stack(logits, 1), np.stack(ids, 1)


@pytest.mark.parametrize("gen", [4, 8])
def test_launcher_prefill_and_decode_match_reference(model, gen):
    jl, jlogits, jids = _reference_serve(model, gen)
    result = serve(model["tcfg"], model["tparams"], model["tbatch"], gen=gen)
    np.testing.assert_allclose(result["prefill_logits"].numpy(), jl, **TOL)
    np.testing.assert_allclose(result["logits"].numpy(), jlogits, **TOL)
    np.testing.assert_array_equal(result["tokens"].numpy(), jids)


def test_reference_launcher_arithmetic_trips_on_the_prefix(model):
    """``src/repro/launch/serve.py:39``'s capacity ``prompt_len + gen`` is
    short of the prompt's P + S positions for gen = 4 < P = 8: the
    reference's prefill refuses it; the port's launcher takes P into
    account."""
    with pytest.raises(AssertionError, match="cache capacity"):
        JM.prefill(model["jparams"], model["jbatch"], model["jcfg"], SEQ + 4,
                   cache_dtype=jnp.float32)
    with pytest.raises(ValueError, match="cache capacity"):
        TM.prefill(model["tparams"], model["tbatch"], model["tcfg"], SEQ + 4,
                   cache_dtype=torch.float32)
    result = serve(model["tcfg"], model["tparams"], model["tbatch"], gen=4)
    assert result["tokens"].shape == (2, 4)


def test_launcher_runs_internvl2_on_cpu(capsys):
    from repro_torch.launch.serve import main

    result = main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                   "--prompt_len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=internvl2-2b-reduced layers=2" in out and "use_pallas=False" in out
    assert result["tokens"].shape == (2, 3) and torch.isfinite(result["logits"]).all()
