"""Port parity, serving: prefill and greedy decode of reduced
recurrentgemma-9b (6 layers: recurrent, recurrent, local x 2; d_model 256,
window 64, f32; also 8 layers, for the two remainder layers ``rem0``/``rem1``),
reduced stablelm-1.6b, reduced falcon-mamba-7b (2 Mamba layers, d_inner
512), reduced codeqwen1.5-7b (untied unembed, rope theta 1e6), reduced
gemma2-27b (local/global x 2, window 64: softcaps 50 and 30, post-norms,
query scale, scaled embeddings, GeGLU) and reduced gemma3-27b at 8 layers
(one 5 local + 1 global period and 2 remainder local layers), on the
reference's own params carried over by ``repro_torch.bridge``, with the same
numpy prompts.  The full-width param and decode-cache templates of all ten
archs are held against the reference's ``jax.eval_shape``.

Tolerances (f32 on both sides; the frameworks sum in other orders): last
prefill logits, every cache leaf and every decode step's logits within 1e-4
absolute, greedy ids identical.  The port's own decode-equals-forward check
keeps the reference's tolerance (``tests/test_models.py:131``, 2e-3).
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
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import model as TM
from repro_torch.training import init_params, make_serve_step, param_template, param_view
from repro_torch.tree import keystr, tree_paths

TOL = dict(rtol=0, atol=1e-4)
PROMPT, GEN = 128, 8
MODELS = {  # name -> (arch, layers of the reduced config)
    "recurrentgemma": ("recurrentgemma-9b", 6),
    "recurrentgemma-rem": ("recurrentgemma-9b", 8),
    "stablelm": ("stablelm-1.6b", 2),
    "falcon-mamba": ("falcon-mamba-7b", 2),
    "codeqwen": ("codeqwen1.5-7b", 2),
    "gemma2": ("gemma2-27b", 4),
    "gemma3-rem": ("gemma3-27b", 8),
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


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    arch, layers = MODELS[request.param]
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), num_layers=layers)
    tcfg = dataclasses.replace(reduced(get_config(arch)), num_layers=layers)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat, _ = bridge.params_from_jax(_numpy_tree(jparams), tcfg)
    jbatch = j_make_batch_for(jcfg, batch=2, seq=PROMPT, seed=0)
    tbatch = make_batch_for(tcfg, batch=2, seq=PROMPT, seed=0)
    np.testing.assert_array_equal(np.asarray(jbatch["tokens"]), tbatch["tokens"].numpy())
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=param_view(flat, tcfg), jbatch=jbatch, tbatch=tbatch)


def _assert_cache_close(tcache, jcache):
    want = _numpy_tree(jcache)
    got = {keystr(path): leaf for path, leaf in tree_paths(tcache)}
    assert list(got) == list(want)
    for name, leaf in got.items():
        assert leaf.shape == want[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == want[name].dtype.name, name
        np.testing.assert_allclose(leaf.numpy(), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_reference(model, use_pallas):
    """Last logits and every cache leaf; with use_pallas the reference runs its
    Pallas kernels in interpret mode and the port its kernels' plain versions."""
    jcfg = dataclasses.replace(model["jcfg"], use_pallas=use_pallas)
    tcfg = dataclasses.replace(model["tcfg"], use_pallas=use_pallas)
    jl, jcache = JM.prefill(model["jparams"], model["jbatch"], jcfg, PROMPT + GEN,
                            cache_dtype=jnp.float32)
    tl, tcache = TM.prefill(model["tparams"], model["tbatch"], tcfg, PROMPT + GEN,
                            cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tcache, jcache)


def test_greedy_decode_from_the_carried_cache_matches_reference(model):
    """8 ``make_serve_step`` steps from the reference's own prefill cache."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jl, jcache = JM.prefill(model["jparams"], model["jbatch"], jcfg, PROMPT + GEN,
                            cache_dtype=jnp.float32)
    tcache = bridge.cache_from_jax(_numpy_tree(jcache), tcfg)
    jstep, tstep = jax.jit(j_make_serve_step(jcfg)), make_serve_step(tcfg)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.from_numpy(np.array(jtok))
    for i in range(GEN):
        jo = jstep(model["jparams"], jcache, jtok, jnp.int32(PROMPT + i))
        to = tstep(model["tparams"], tcache, ttok, PROMPT + i)
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), **TOL)
        np.testing.assert_array_equal(to["next_token"].numpy(), np.asarray(jo["next_token"]))
        jtok, jcache, ttok, tcache = jo["next_token"], jo["cache"], to["next_token"], to["cache"]
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("arch,seq", [("stablelm-1.6b", 8), ("recurrentgemma-9b", 80),
                                      ("falcon-mamba-7b", 24)])
def test_decode_matches_forward_and_prefill_continues(arch, seq):
    """Token-by-token decode reproduces the full-sequence logits (80 tokens
    wrap recurrentgemma's 64-slot ring), and prefill then decode equals
    decode from scratch."""
    cfg = reduced(get_config(arch))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=1, seq=seq, seed=1)
    with torch.no_grad():
        full, _ = TM.forward(params, batch, cfg)
    cache = TM.init_decode_state(params, cfg, 1, seq + 1, cache_dtype=torch.float32)
    outs = []
    for t in range(seq):
        lg, cache = TM.decode_step(params, cache, batch["tokens"][:, t], t, cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)

    prompt = {"tokens": batch["tokens"][:, :-1]}
    lg_p, cache_p = TM.prefill(params, prompt, cfg, seq + 1, cache_dtype=torch.float32)
    np.testing.assert_allclose(lg_p.numpy(), outs[-2].numpy(), rtol=2e-3, atol=2e-3)
    lg_pc, _ = TM.decode_step(params, cache_p, batch["tokens"][:, -1], seq - 1, cfg)
    np.testing.assert_allclose(lg_pc.numpy(), outs[-1].numpy(), rtol=2e-3, atol=2e-3)


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    result = main(["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu", "--batch", "2",
                   "--prompt_len", "16", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "tok/s" in out and "generated token ids [0]:" in out
    assert "use_pallas=False" in out
    assert result["tokens"].shape == (2, 3) and result["logits"].shape == (2, 3, 512)
    assert torch.isfinite(result["logits"]).all() and torch.isfinite(result["prefill_logits"]).all()


def test_serve_launcher_runs_falcon_mamba_on_cpu(capsys):
    from repro_torch.launch.serve import main

    result = main(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu", "--batch", "2",
                   "--prompt_len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b-reduced layers=2" in out and "use_pallas=False" in out
    assert result["tokens"].shape == (2, 3) and result["logits"].shape == (2, 3, 512)
    assert torch.isfinite(result["logits"]).all() and torch.isfinite(result["prefill_logits"]).all()


def _assert_full_width_templates_match(arch):
    """Full ``arch`` on the meta device against the reference's
    ``jax.eval_shape``: same key paths in the same order, same shapes —
    params and decode cache (whisper's from encoding a (4, 1500, D) batch).
    Returns the param shapes."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda k: JM.init_model(k, jcfg), jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(s.shape))
            for p, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    got = [(keystr(p), tuple(shape)) for p, (shape, _) in tree_paths(param_template(tcfg))]
    assert got == want

    enc = (4, jcfg.encoder_positions, jcfg.d_model)
    jbatch = {"enc_embeds": jax.ShapeDtypeStruct(enc, jnp.float32)} if jcfg.is_encoder_decoder \
        else None
    jcache = jax.eval_shape(lambda p, b: JM.init_decode_state(p, jcfg, 4, 4128, batch=b,
                                                              cache_dtype=jnp.float32),
                            jshapes, jbatch)
    want_cache = [(jax.tree_util.keystr(p), tuple(s.shape), s.dtype.name)
                  for p, s in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    if tcfg.is_encoder_decoder:
        meta = TM.init_model(None, tcfg, "meta")
        tbatch = {"enc_embeds": torch.empty(enc, device="meta")}
    else:
        meta, tbatch = {"embed": {"embedding": torch.empty(0, device="meta")}}, None
    tcache = TM.init_decode_state(meta, tcfg, 4, 4128, cache_dtype=torch.float32, batch=tbatch)
    got_cache = [(keystr(p), tuple(t.shape), str(t.dtype).split(".")[-1])
                 for p, t in tree_paths(tcache)]
    assert got_cache == want_cache
    return dict(got)


def test_full_width_templates_match_reference():
    """Full recurrentgemma-9b: 12 periods under pos0..pos2, rem0 and rem1."""
    shapes = _assert_full_width_templates_match("recurrentgemma-9b")
    assert "['stack']['rem1']['rglru']['lambda_']" in shapes
    # 37.6 GB in f32; param_count()'s analytic sum leaves out the W x W gates
    assert sum(int(np.prod(s)) for s in shapes.values()) == 9_396_408_320


def test_full_width_falcon_mamba_templates_match_reference():
    """Full falcon-mamba-7b: 64 Mamba blocks stacked under pos0, untied
    unembed; 29.09 GB in f32."""
    shapes = _assert_full_width_templates_match("falcon-mamba-7b")
    assert shapes["['stack']['pos0']['ssm']['in_proj']"] == (64, 4096, 16384)
    assert shapes["['unembed']['embedding']"] == (65_024, 4096)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 7_272_683_520


# arch -> (a leaf and its full-width shape, the param count, in f32: GB)
NEW_ARCHS = {
    "codeqwen1.5-7b": ("['unembed']['embedding']", (92_416, 4096), 8_189_644_800),  # 32.76
    "gemma2-27b": ("['stack']['pos1']['mlp_post_norm']['scale']", (23, 4608), 27_227_128_320),
    "gemma3-27b": ("['stack']['rem1']['attn']['wq']", (5376, 32, 128), 27_008_986_368),
    "internvl2-2b": ("['stack']['pos0']['attn']['wk']", (24, 2048, 8, 128), 1_889_146_880),
    # 60 routed experts padded to 64: 60.59 GB, past param_count()'s 14.32e9
    "qwen2-moe-a2.7b": ("['stack']['pos0']['moe']['w_gate_e']", (24, 64, 2048, 1408),
                        15_146_305_536),
    "qwen3-moe-235b-a22b": ("['stack']['pos0']['moe']['w_down_e']", (94, 128, 1536, 4096),
                            235_093_610_496),  # 940.37 GB
    "whisper-large-v3": ("['encoder']['attn']['wk']", (32, 1280, 20, 64), 1_534_809_600),
}


@pytest.mark.parametrize("arch", list(NEW_ARCHS))
def test_full_width_templates_of_the_other_archs_match_reference(arch):
    """The seven archs ported last, at full width: params and decode cache
    against the reference's templates, one named leaf and the total."""
    shapes = _assert_full_width_templates_match(arch)
    leaf, shape, total = NEW_ARCHS[arch]
    assert shapes[leaf] == shape
    assert sum(int(np.prod(s)) for s in shapes.values()) == total


def test_cache_from_jax_keeps_dtypes_and_bits(model):
    """A bf16 cache arrives with its bits; the recurrent state h stays f32."""
    _, jcache = JM.prefill(model["jparams"], model["jbatch"], model["jcfg"], PROMPT + GEN,
                           cache_dtype=jnp.bfloat16)
    want = _numpy_tree(jcache)
    tcache = bridge.cache_from_jax(want, model["tcfg"])
    for path, leaf in tree_paths(tcache):
        a = want[keystr(path)]
        if path[-1] == "h":
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy(), a)
        else:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(), a.view(np.int16))
    dropped = {k: v for k, v in want.items() if not k.startswith("['pos0']")}
    with pytest.raises(ValueError, match="missing"):
        bridge.cache_from_jax(dropped, model["tcfg"])
