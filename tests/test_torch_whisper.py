"""Port parity, whisper's encoder-decoder: ``repro_torch.models.whisper``
against ``src/repro/models/whisper.py`` on reduced whisper-large-v3 (2
encoder and 2 decoder layers, d_model 256, 4 heads of 64, 64 encoder
frames, f32), with the reference's own params carried over by
``repro_torch.bridge`` and the same numpy batch (tokens and ``enc_embeds``).

Tolerances, each with its reason:
* ``sinusoidal_positions``: bitwise (the same numpy in both packages);
* ``encode``, ``decode_train``'s logits and both halves of
  ``init_whisper_cache``: 1e-5 absolute (f32 round-off of the products'
  summation order); the encoder also with ``use_pallas`` (the reference's
  Pallas kernel in interpret mode, the port's kernel's plain version: the
  non-causal flash path);
* 8 greedy steps through the serving launcher's path (the cache from
  encoding the batch, the first prompt token, positions from 0): logits
  1e-4 absolute and ids equal (the serving tests' bound).
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import whisper as JW
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import whisper as TW
from repro_torch.training import param_view
from repro_torch.tree import keystr, tree_paths

ARCH, SEQ, GEN = "whisper-large-v3", 12, 8
F32 = dict(rtol=0, atol=1e-5)


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
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat, _ = bridge.params_from_jax(_numpy_tree(jparams), tcfg)
    jbatch = j_make_batch_for(jcfg, batch=2, seq=SEQ, seed=0)
    tbatch = make_batch_for(tcfg, batch=2, seq=SEQ, seed=0)
    for key in ("tokens", "enc_embeds"):
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]), err_msg=key)
    assert tbatch["enc_embeds"].shape == (2, tcfg.encoder_positions, tcfg.d_model)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=param_view(flat, tcfg),
                jbatch=jbatch, tbatch=tbatch)


@pytest.mark.parametrize("n,d", [(1500, 1280), (64, 256), (7, 6), (448, 64)])
def test_sinusoidal_positions_bitwise(n, d):
    got, want = TL.sinusoidal_positions(n, d), JL.sinusoidal_positions(n, d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    t = TL.position_table(n, d, "cpu", torch.float32)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), want.view(np.uint32))
    assert TL.position_table(n, d, "cpu", torch.float32) is t  # built once


def test_softcap_matches_reference():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    np.testing.assert_allclose(TL.softcap(torch.from_numpy(x), 30.0).numpy(),
                               np.asarray(JL.softcap(jnp.asarray(x), 30.0)), rtol=0, atol=1e-5)
    t = torch.from_numpy(x)
    assert TL.softcap(t, None) is t


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_matches_reference(model, use_pallas):
    jcfg = dataclasses.replace(model["jcfg"], use_pallas=use_pallas)
    tcfg = dataclasses.replace(model["tcfg"], use_pallas=use_pallas)
    want = JW.encode(model["jparams"], model["jbatch"]["enc_embeds"], jcfg)
    with torch.no_grad():
        got = TW.encode(model["tparams"], model["tbatch"]["enc_embeds"], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_train_and_forward_match_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jmem = JW.encode(model["jparams"], model["jbatch"]["enc_embeds"], jcfg)
    want = JW.decode_train(model["jparams"], model["jbatch"]["tokens"], jmem, jcfg)
    with torch.no_grad():
        tmem = TW.encode(model["tparams"], model["tbatch"]["enc_embeds"], tcfg)
        got = TW.decode_train(model["tparams"], model["tbatch"]["tokens"], tmem, tcfg)
        logits, aux = TM.forward(model["tparams"], model["tbatch"], tcfg)
        loss, metrics = TM.loss_fn(model["tparams"], model["tbatch"], tcfg)
    assert got.shape == (2, SEQ, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(logits.numpy(), got.numpy())
    assert float(aux) == 0.0
    jloss, _ = JM.loss_fn(model["jparams"], model["jbatch"], jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_init_whisper_cache_matches_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    cap = SEQ + GEN
    want = JM.init_decode_state(model["jparams"], jcfg, 2, cap, cache_dtype=jnp.float32,
                                batch=model["jbatch"])
    got = TM.init_decode_state(model["tparams"], tcfg, 2, cap, cache_dtype=torch.float32,
                               batch=model["tbatch"])
    want = _numpy_tree(want)
    assert sorted(keystr(p) for p, _ in tree_paths(got)) == sorted(want)
    for path, leaf in tree_paths(got):
        name = keystr(path)
        assert leaf.shape == want[name].shape and leaf.dtype == torch.float32, name
        np.testing.assert_allclose(leaf.numpy(), want[name], **F32, err_msg=name)
    L, T = tcfg.num_layers, tcfg.encoder_positions
    assert got["cross"]["k"].shape == (L, 2, T, tcfg.num_heads, tcfg.head_dim)
    assert not got["self"]["k"].any()
    # the reference's cache crosses the bridge with its names and bits
    carried = bridge.cache_from_jax(want, tcfg)
    for path, leaf in tree_paths(carried):
        np.testing.assert_array_equal(leaf.numpy(), want[keystr(path)])


def test_greedy_decode_through_the_launcher_matches_reference(model):
    """The reference launcher's whisper path (``serve.py:41-48``): cache from
    ``init_decode_state(..., batch=batch)``, first token ``tokens[:, 0]``,
    positions 0, 1, ...; the port's through ``launch.serve.serve``."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jcache = JM.init_decode_state(model["jparams"], jcfg, 2, SEQ + GEN, cache_dtype=jnp.float32,
                                  batch=model["jbatch"])
    jstep = jax.jit(j_make_serve_step(jcfg))
    jtok, jlogits, jids = model["jbatch"]["tokens"][:, 0], [], []
    for i in range(GEN):
        out = jstep(model["jparams"], jcache, jtok, jnp.int32(i))
        jtok, jcache = out["next_token"], out["cache"]
        jlogits.append(np.asarray(out["logits"]))
        jids.append(np.asarray(jtok))
    result = serve(tcfg, model["tparams"], model["tbatch"], gen=GEN)
    assert result["prefill_logits"] is None
    np.testing.assert_allclose(result["logits"].numpy(), np.stack(jlogits, 1), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(result["tokens"].numpy(), np.stack(jids, 1))
