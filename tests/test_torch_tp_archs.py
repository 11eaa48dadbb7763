"""Port parity, tensor parallelism of the other families: the Mamba layer
(reduced falcon-mamba-7b), the RG-LRU layer with local attention (reduced
recurrentgemma-9b: one (recurrent, recurrent, local) period and a remainder
recurrent layer), whisper's encoder-decoder (reduced whisper-large-v3, 2 + 2
layers) and the vision prefix (reduced internvl2-2b, 8 prefix embeddings),
each at d_model 64 in f32 (``torch_tp_common.arch_config``), run as gloo
processes on the CPU against one process of the port and against the
reference.

The params are the reference's ``init_params`` carried over as numpy; the
ranks take their blocks with ``bridge.params_from_jax(..., mesh=...)`` and
their gradients and params are put back together with
``bridge.gather_params``.  Three layouts, each one spawn of its ranks from a
script (``_WORKER``), all under ``use_sharding_rules(mesh)`` with a running
``make_mesh`` layout: ``1x2`` (data 1 x model 2), ``1x4`` (data 1 x model 4:
every width of the four divides; whisper's vocab of 514 does not, so its
embedding stays whole there), ``2x2`` (data 2 x model 2, each data group
its batch row, in the reference's FSDP storage over ``data``: each rank
gathers a layer's weights before it runs) and ``2x2-repl`` (the same with
every weight whole over ``data``, ``replicate_params_over_data``).

Bounds, each with its reason:
* loss within 1e-6 relative and the gathered flat gradient within 1e-5 of
  max |g|, of the port's one process and of the reference's
  ``make_grad_fn`` (the bound of ``tests/test_torch_grad_parity.py``; the
  cross-rank sums change the order of the sums);
* the Mamba layers' ``bc_norm`` gradients bitwise equal on every rank (the
  norms run replicated on whole inputs, and the cotangent they get is one
  all-reduce's result);
* prefill logits within 1e-5 of one process's and of the reference's
  ``prefill`` (whisper has no decoder prefill in the launcher); 8 greedy
  steps: logits within 1e-4 (the serving tests' bound) and ids equal;
* 3 fused async ticks (momentum, W = K = 4, f32 ring, the same injected
  uniforms): gathered params within 1e-5 of one process's, losses within
  1e-6 relative and bitwise equal across ranks;
* the bytes every rank handed to all-reduce (``COLLECTIVE_BYTES``) equal
  ``launch.analysis.port_collective_bytes`` exactly, for the gradient and
  for the serve, and for a serve in bf16 activations at model 2;
* every leaf of a rank's decode cache (empty, and from a prefill) is its
  block of the one-process cache: batch over data, kv heads and the Mamba
  and RG-LRU layers' widths over model;
* the layout: a rank's ``in_proj`` block is ``[u_r | z_r]`` of the whole
  leaf, ``bridge.params_from_jax(mesh=)`` packs what ``localize`` cuts, and
  ``gather_params`` of it is the whole flat buffer bit for bit, for every
  leaf of the four archs; internvl2's embedding, unembedding and logits are
  whole on every rank.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import make_batch_for as j_make_batch_for
from repro.distributed import make_grad_fn as j_make_grad_fn
from repro.models import model as JM
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.data import make_batch_for
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.run import run
from repro_torch.sharding.collectives import COLLECTIVE_BYTES
from repro_torch.training.steps import param_template
from repro_torch.tree import tree_paths
from torch_tp_common import REPL, ARCHS, B, GEN, S, arch_async_spec, arch_config, layout_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "2x2-repl": (2, 2)}

_WORKER = textwrap.dedent('''
    import dataclasses
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.run import run
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, leaf_paths, localize
    from repro_torch.training.steps import _template, param_template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import ARCHS, GEN, S, arch_async_spec, arch_config  # noqa: E402


    def counted():
        return np.array([C.COLLECTIVE_BYTES[k] for k in sorted(C.COLLECTIVE_BYTES)])


    def worker(rank, world, data, model, tmp, repl):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        name = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{name}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        tag = f"{name}_{rank}"
        out = {"data": mesh.index("data"), "model": mesh.index("model")}
        draws = np.load(f"{tmp}/draws.npy")
        with use_sharding_rules(mesh):
            for arch in ARCHS:
                cfg = arch_config(arch)
                tree = dict(np.load(f"{tmp}/params_{arch}.npz"))
                batch = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/batch_{arch}.npz").items()}
                local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
                whole, _ = bridge.params_from_jax(tree, cfg)

                # the layout: localize cuts what params_from_jax packs, and
                # gather_params puts it back together
                cut = T.pack_flat(localize(T.flat_view(whole, param_template(cfg)), cfg, mesh))
                out[f"{arch}_localize_equal"] = bool(torch.equal(cut, local))
                out[f"{arch}_gathered_whole"] = bool(torch.equal(
                    bridge.gather_params(local, cfg, mesh), whole))
                tree_local = T.flat_view(local, _template(cfg, mesh))
                out[f"{arch}_shapes"] = json.dumps({p: list(t.shape)
                                                    for p, t in leaf_paths(tree_local)})
                if arch == "falcon-mamba-7b":
                    out["in_proj_block"] = tree_local["stack"]["pos0"]["ssm"]["in_proj"].numpy()

                # loss and gradient
                C.reset_collective_bytes()
                leaf = local.clone().requires_grad_()
                loss, _ = M.loss_fn(T.flat_view(leaf, _template(cfg, mesh)),
                                    C.local_rows(batch, mesh), cfg)
                (g,) = torch.autograd.grad(loss, leaf)
                if C.data_size(mesh) > 1:
                    C.sum_grads_over_data(g, mesh, cfg)
                out[f"{arch}_grad_bytes"] = counted()
                out[f"{arch}_loss"] = loss.detach().numpy()
                out[f"{arch}_grad"] = bridge.gather_params(g, cfg, mesh).numpy()
                if arch == "falcon-mamba-7b":
                    out["bc_norm_grad"] = torch.cat(
                        [t.reshape(-1) for p, t in leaf_paths(T.flat_view(g, _template(cfg, mesh)))
                         if "bc_norm" in p]).numpy()

                # the decode caches a rank holds: empty, and from a prefill
                rows = C.local_rows(batch, mesh, strict=False)
                n_pre = cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0
                cap = S + n_pre + GEN
                with torch.no_grad():
                    caches = {"init": M.init_decode_state(tree_local, cfg, rows["tokens"].shape[0],
                                                          cap, cache_dtype=torch.float32,
                                                          batch=rows)}
                    if not cfg.is_encoder_decoder:
                        caches["prefill"] = M.prefill(tree_local, rows, cfg, cap,
                                                      cache_dtype=torch.float32)[1]
                out[f"{arch}_caches"] = json.dumps(
                    {k: {p: list(t.shape) for p, t in leaf_paths(c)} for k, c in caches.items()})

                # prefill and 8 greedy steps
                C.reset_collective_bytes()
                with torch.no_grad():
                    res = serve(cfg, tree_local, batch, gen=GEN)
                out[f"{arch}_serve_bytes"] = counted()
                if res["prefill_logits"] is not None:
                    out[f"{arch}_prefill"] = res["prefill_logits"].numpy()
                out[f"{arch}_logits"] = res["logits"].numpy()
                out[f"{arch}_ids"] = res["tokens"].numpy()

                # 3 fused async ticks
                losses = []

                class Losses:
                    def on_start(self, ctx): pass
                    def on_refresh(self, ctx): pass
                    def on_end(self, ctx): pass
                    def on_tick(self, ctx): losses.append(ctx.metrics["loss"].clone())

                state = run(arch_async_spec(cfg, local, draws), hooks=[Losses()]).state
                out[f"{arch}_async_losses"] = torch.stack(losses).numpy()
                out[f"{arch}_async_params"] = bridge.gather_params(state.params, cfg, mesh).numpy()

                if (data, model) == (1, 2):
                    # bf16 activations and the f32 cache: a decode step's
                    # residual stream is promoted after the first attention
                    bcfg = dataclasses.replace(cfg, activation_dtype="bfloat16")
                    C.reset_collective_bytes()
                    with torch.no_grad():
                        serve(bcfg, tree_local, batch, gen=GEN)
                    out[f"{arch}_bf16_serve_bytes"] = counted()
        np.savez(f"{tmp}/rank_{tag}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, repl in ((1, 2, False), (1, 4, False), (2, 2, False), (2, 2, True)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp, repl),
                                        nprocs=data * model, join=True)
        print("OK tensor parallel archs")
''')


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference_serve(jcfg, jparams, jbatch):
    """The reference's serve: prefill and GEN greedy steps (f32 cache); for
    whisper the launcher's cache from the encoder and steps from the first
    prompt token at 0 (no prefill logits)."""
    step = jax.jit(j_make_serve_step(jcfg))
    if jcfg.is_encoder_decoder:
        cache = JM.init_decode_state(jparams, jcfg, B, S + GEN, cache_dtype=jnp.float32,
                                     batch=jbatch)
        pre, tok, start = None, jbatch["tokens"][:, 0], 0
    else:
        start = S + (jcfg.num_prefix_embeddings if jcfg.frontend == "vision" else 0)
        logits, cache = JM.prefill(jparams, jbatch, jcfg, start + GEN, cache_dtype=jnp.float32)
        pre, tok = np.asarray(logits), jnp.argmax(logits, axis=-1).astype(jnp.int32)
    steps, ids = [], []
    for i in range(GEN):
        out = step(jparams, cache, tok, jnp.int32(start + i))
        tok, cache = out["next_token"], out["cache"]
        steps.append(np.asarray(out["logits"]))
        ids.append(np.asarray(tok))
    return pre, np.stack(steps, axis=1), np.stack(ids, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and one process's results for the four archs, and
    every rank's of the three layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("tp_archs")
    draws = np.random.default_rng(0).random((3, 4)).astype(np.float32)
    np.save(tmp / "draws.npy", draws)
    want = {}
    for arch in ARCHS:
        jcfg, cfg = arch_config(arch, j_reduced, j_get_config), arch_config(arch)
        jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
        keys, leaves, _ = _flatten_with_keys(jparams)
        tree = {k: np.asarray(v) for k, v in zip(keys, leaves)}
        np.savez(tmp / f"params_{arch}.npz", **tree)
        jbatch = j_make_batch_for(jcfg, batch=B, seq=S, seed=0)
        batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
        np.savez(tmp / f"batch_{arch}.npz", **{k: v.numpy() for k, v in batch.items()})
        flat, _ = bridge.params_from_jax(tree, cfg)
        jl, jg = j_make_grad_fn(jcfg)(flat.numpy(), jbatch)
        leaf = flat.clone().requires_grad_()
        loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), batch, cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            res = serve(cfg, T.flat_view(flat, param_template(cfg)), batch, gen=GEN)
        jpre, jlogits, jids = _reference_serve(jcfg, jparams, jbatch)
        losses = []

        class Losses:
            def on_start(self, ctx):
                pass

            def on_refresh(self, ctx):
                pass

            def on_end(self, ctx):
                pass

            def on_tick(self, ctx):
                losses.append(ctx.metrics["loss"].clone())

        async_params = run(arch_async_spec(cfg, flat, draws), hooks=[Losses()]).state.params
        want[arch] = dict(
            flat=flat.numpy(), jloss=float(jl), jgrad=np.asarray(jg), loss=loss.item(),
            grad=g.numpy(), prefill=(None if res["prefill_logits"] is None
                                     else res["prefill_logits"].numpy()),
            logits=res["logits"].numpy(), ids=res["tokens"].numpy(), jprefill=jpre,
            jlogits=jlogits, jids=jids, async_params=async_params.numpy(),
            async_losses=torch.stack(losses).numpy())

    script = tmp / "tp_archs_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), os.path.join(ROOT, "tests")],
                          env=env, cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK tensor parallel archs" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    return dict(want=want, ranks=ranks)


def _cases():
    return [(name, arch) for name in LAYOUTS for arch in ARCHS]


@pytest.mark.parametrize("name,arch", _cases())
def test_loss_and_gradient_match_one_process_and_reference(runs, name, arch):
    want = runs["want"][arch]
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(float(r[f"{arch}_loss"]), want["loss"], rtol=1e-6)
        np.testing.assert_allclose(float(r[f"{arch}_loss"]), want["jloss"], rtol=1e-6)
        assert np.abs(r[f"{arch}_grad"] - want["grad"]).max() <= 1e-5 * np.abs(want["grad"]).max()
        assert np.abs(r[f"{arch}_grad"] - want["jgrad"]).max() <= \
            1e-5 * np.abs(want["jgrad"]).max()
        np.testing.assert_array_equal(r[f"{arch}_grad"], runs["ranks"][name][0][f"{arch}_grad"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_bc_norm_gradients_are_bitwise_equal_across_ranks(runs, name):
    ranks = runs["ranks"][name]
    assert ranks[0]["bc_norm_grad"].size == 2 * (64 // 16 + 2 * 16)  # 2 layers of (dt, B, C)
    assert np.abs(ranks[0]["bc_norm_grad"]).max() > 0
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["bc_norm_grad"], ranks[0]["bc_norm_grad"])


def _gathered(ranks, key, vocab):
    """The layout's logits in (row, vocab) order from every rank's block, or
    where ``model`` does not divide the vocab from each data group's first
    rank (every rank holds them whole)."""
    data = 1 + max(int(r["data"]) for r in ranks)
    model = len(ranks) // data
    rows = []
    for d in range(data):
        group = sorted((r for r in ranks if int(r["data"]) == d), key=lambda r: int(r["model"]))
        if vocab % model:
            assert all(g[key].shape[-1] == vocab for g in group)
            rows.append(group[0][key])
        else:
            rows.append(np.concatenate([g[key] for g in group], axis=-1))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name,arch", _cases())
def test_serve_matches_one_process_and_reference(runs, name, arch):
    want = runs["want"][arch]
    ranks = runs["ranks"][name]
    vocab = arch_config(arch).vocab_size
    if want["prefill"] is not None:
        pre = _gathered(ranks, f"{arch}_prefill", vocab)
        np.testing.assert_allclose(pre, want["prefill"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(pre, want["jprefill"], rtol=0, atol=1e-5)
    else:
        assert want["jprefill"] is None and all(f"{arch}_prefill" not in r for r in ranks)
    logits = _gathered(ranks, f"{arch}_logits", vocab)
    np.testing.assert_allclose(logits, want["logits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(logits, want["jlogits"], rtol=0, atol=1e-4)
    data = 1 + max(int(r["data"]) for r in ranks)
    rows = B // data
    for r in ranks:
        d = int(r["data"])
        np.testing.assert_array_equal(r[f"{arch}_ids"], want["jids"][d * rows:(d + 1) * rows])
        np.testing.assert_array_equal(r[f"{arch}_ids"], want["ids"][d * rows:(d + 1) * rows])


@pytest.mark.parametrize("name,arch", _cases())
def test_async_fused_run_matches_one_process(runs, name, arch):
    want = runs["want"][arch]
    ranks = runs["ranks"][name]
    for r in ranks:
        assert np.abs(r[f"{arch}_async_params"] - want["async_params"]).max() <= 1e-5
        np.testing.assert_allclose(r[f"{arch}_async_losses"], want["async_losses"], rtol=1e-6)
        np.testing.assert_array_equal(r[f"{arch}_async_losses"], ranks[0][f"{arch}_async_losses"])


@pytest.mark.parametrize("name,arch", _cases())
def test_counted_all_reduce_bytes_equal_the_plan(runs, name, arch):
    data, model = LAYOUTS[name]
    mesh = make_mesh((data, model), ("data", "model"))
    cfg = arch_config(arch)
    keys = sorted(COLLECTIVE_BYTES)
    with layout_of(name):
        train = port_collective_bytes(cfg, "train", B, S, mesh)["counted"]
        pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
        dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
    want_train = [train.get(k, 0) for k in keys]
    want_serve = [pre.get(k, 0) + GEN * dec.get(k, 0) for k in keys]
    for r in runs["ranks"][name]:
        assert r[f"{arch}_grad_bytes"].tolist() == want_train
        assert r[f"{arch}_serve_bytes"].tolist() == want_serve
    mixer = {"falcon-mamba-7b": ("ssm_proj", "ssm_out"),
             "recurrentgemma-9b": ("lru_gather", "lru_out", "attn")}.get(arch, ("attn", "mlp"))
    for k in mixer:
        assert train[k] > 0 and pre[k] + dec[k] > 0
    assert train["backward"] > 0


def _cache_block(arch, path, shape, data, model):
    """A rank's block of a whole cache leaf, as the reference's
    ``cache_spec_for`` lays it out: the batch over data; over model the kv
    heads (``k`` / ``v``: (..., B, C, N, H)), a conv window's width (...,
    B, K-1, W), a Mamba state's inner width (..., B, D_inner, N) and an
    RG-LRU state's width (..., B, W), each where ``model`` divides it.
    (``cache_spec_for`` tells the two states apart by ``N <= 64``, which
    reads the RG-LRU's reduced width of 64 as an SSM state; so the leaf's
    kind is named here.)"""
    leaf = path.rsplit("/", 1)[-1]
    ssm_state = leaf == "h" and arch == "falcon-mamba-7b"
    over_model = {"k": -2, "v": -2, "conv": -1, "h": -2 if ssm_state else -1}[leaf]
    batch = {"k": -4, "v": -4, "conv": -3, "h": -3 if ssm_state else -2}[leaf]
    out = list(shape)
    if out[batch] % data == 0:
        out[batch] //= data
    if out[over_model] % model == 0:
        out[over_model] //= model
    return out


@pytest.mark.parametrize("name,arch", _cases())
def test_decode_caches_hold_the_ranks_block_of_the_reference_spec(runs, name, arch):
    """Every leaf of a rank's decode cache, empty and from a prefill, is its
    block of the one-process cache (:func:`_cache_block`): the SSM's ``conv
    (B, K-1, D_inner / model)`` and ``h (B, D_inner / model, N)``, the
    RG-LRU's ``(B, K-1, W / model)`` and ``(B, W / model)``, the local
    layers' one kv head whole, whisper's self and cross K/V by heads."""
    from repro_torch.sharding.specs import cache_spec_for, leaf_paths, local_shape

    data, model = LAYOUTS[name]
    mesh = make_mesh((data, model), ("data", "model"))
    cfg = arch_config(arch)
    batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
    n_pre = cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0
    with torch.no_grad():
        params = T.flat_view(torch.from_numpy(runs["want"][arch]["flat"]), param_template(cfg))
        whole = M.init_decode_state(params, cfg, B, S + n_pre + GEN, cache_dtype=torch.float32,
                                    batch=batch)
    want = {p: _cache_block(arch, p, tuple(t.shape), data, model) for p, t in leaf_paths(whole)}
    for p, t in leaf_paths(whole):  # the reference's spec, where it reads the leaf's kind
        if not (arch == "recurrentgemma-9b" and p.endswith("/h")):
            shape = tuple(t.shape)
            assert list(local_shape(shape, cache_spec_for(p, shape, mesh, B), mesh)) == want[p], p
    assert [p for p, t in leaf_paths(whole) if list(t.shape) != want[p]], "no leaf is split"
    for r in runs["ranks"][name]:
        caches = json.loads(str(r[f"{arch}_caches"]))
        assert sorted(caches) == (["init"] if cfg.is_encoder_decoder else ["init", "prefill"])
        for kind, shapes in caches.items():
            assert shapes == want, kind


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serve_bytes_equal_the_plan(runs, arch):
    """bf16 activations with the launcher's f32 cache (model 2): the plan
    follows the dtype a decode step's residual stream has, promoted to f32
    after the first attention layer, exactly."""
    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = dataclasses.replace(arch_config(arch), activation_dtype="bfloat16")
    pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
    dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
    want = [pre.get(k, 0) + GEN * dec.get(k, 0) for k in sorted(COLLECTIVE_BYTES)]
    for r in runs["ranks"]["1x2"]:
        assert r[f"{arch}_bf16_serve_bytes"].tolist() == want


@pytest.mark.parametrize("name,arch", _cases())
def test_layout_gathers_back_to_the_whole_tree(runs, name, arch):
    """``localize`` and ``params_from_jax(mesh=)`` cut the same blocks, and
    ``gather_params`` puts them back bit for bit; every leaf split over
    ``model`` is a rank's block, of the same shape on each data replica
    (whole over ``data`` in the replicated layout)."""
    data, model = LAYOUTS[name]
    for r in runs["ranks"][name]:
        assert bool(r[f"{arch}_localize_equal"]) and bool(r[f"{arch}_gathered_whole"])
    ranks = runs["ranks"][name]
    for r in ranks:
        twins = [o for o in ranks if int(o["model"]) == int(r["model"])]
        for o in twins:
            assert str(o[f"{arch}_shapes"]) == str(r[f"{arch}_shapes"])
    shapes = json.loads(str(ranks[0][f"{arch}_shapes"]))
    cfg = arch_config(arch)
    whole = {"/".join(p): s for p, (s, _) in tree_paths(param_template(cfg))}
    split = [p for p in whole if tuple(shapes[p]) != tuple(whole[p])]
    assert split, "no leaf is split"
    V, D = whole["embed/embedding"]
    # internvl2's vocab and whisper's at model 4 do not split: whole over model
    rows = V if arch == "internvl2-2b" or (arch == "whisper-large-v3" and model == 4) else V // model
    # d_model over data in the FSDP storage, whole in the replicated layout
    cols = D if data == 1 or name.endswith(REPL) else D // data
    assert tuple(shapes["embed/embedding"]) == (rows, cols)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_in_proj_block_is_the_ranks_columns_of_u_and_of_z(runs, name):
    """The SSM's ``in_proj`` (d, 2 d_inner) stacks u and z: a rank holds
    ``[u_r | z_r]``, so ``chunk(2)`` splits its block into its u and z (of
    its d rows, in the FSDP storage over ``data``)."""
    data, model = LAYOUTS[name]
    rows = cfg_rows = arch_config("falcon-mamba-7b").d_model
    if not name.endswith(REPL):
        rows //= data
    cfg = arch_config("falcon-mamba-7b")
    whole = M.init_model(None, cfg, "meta")  # the template's layout
    assert tuple(whole["stack"]["pos0"]["ssm"]["in_proj"].shape[-2:]) == \
        (cfg.d_model, 2 * cfg.d_inner)
    tree = T.flat_view(torch.from_numpy(runs["want"]["falcon-mamba-7b"]["flat"]),
                       param_template(cfg))
    full = tree["stack"]["pos0"]["ssm"]["in_proj"].numpy()
    di, w = cfg.d_inner, cfg.d_inner // model
    for r in runs["ranks"][name]:
        m = int(r["model"])
        want = np.concatenate([full[..., m * w:(m + 1) * w], full[..., di + m * w:di + (m + 1) * w]],
                              axis=-1)
        d = int(r["data"]) if rows < cfg_rows else 0
        np.testing.assert_array_equal(r["in_proj_block"], want[..., d * rows:(d + 1) * rows, :])
