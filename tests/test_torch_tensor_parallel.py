"""Port parity, dense tensor parallelism: Megatron-style products over
``model`` and data parallelism over ``data``, run as gloo processes on the
CPU against one process of the port and against the reference.

The config is reduced stablelm-1.6b at d_model 64 (4 heads of 64, d_ff 256,
vocab 512, 2 layers, f32), batch 2 x seq 16, its params the reference's
``init_params`` carried over as numpy; the ranks take their blocks with
``bridge.params_from_jax(..., mesh=...)`` and their gradients and params are
put back together with ``bridge.gather_params``.  Three layouts, each one
spawn of its ranks from a script (``_WORKER``), all under
``use_sharding_rules(mesh)`` with a running ``make_mesh`` layout:

* ``1x2``: data 1 x model 2;
* ``1x4``: data 1 x model 4 (one query head a rank);
* ``2x2``: data 2 x model 2 (each data group its batch row), in the
  reference's FSDP storage over ``data`` (the default: each rank stores
  its block over ``data`` too, gathers a layer's weights before it runs
  and reduce-scatters their gradient);
* ``2x2-repl``: the same under ``SPEC_OPTIONS["replicate_params_over_data"]``
  (every weight whole over ``data``, the gradient summed in all-reduces).

Bounds, each with its reason:
* loss within 1e-6 relative and the gathered flat gradient within 1e-5 of
  max |g|, of the port's one process and of the reference's
  ``make_grad_fn`` (the bound of ``tests/test_torch_grad_parity.py``; the
  cross-rank sums change the order of the sums);
* a 4-tick async fused run (momentum, W = K = 4, a refresh every 2) with the
  same injected uniforms: gathered params within 1e-5 of one process's;
  every rank's losses, alpha tables, CDFs and histograms after every tick
  bitwise equal to one process's (the taus are the same draws looked up in
  the same tables); the data replicas' blocks of the leaves whole over
  ``data`` bitwise equal;
* prefill and 8 greedy steps against the reference's ``prefill`` /
  ``decode_step``: logits within 1e-4 (phase 6's bound), ids equal;
* the kv-replicated layout (``num_kv_heads=1``, which no model axis here
  divides): the same loss, gradient and serve bounds;
* the clip link's squared norm over the rank's blocks equal to one
  process's within 1e-6 relative, and a 2-step sync fused run with a clip
  that binds within 1e-5 of one process's params;
* the bytes every rank handed to all-reduce (``COLLECTIVE_BYTES``) equal
  ``launch.analysis.port_collective_bytes`` exactly, for the gradient step
  and for the serve (prefill + 8 decode steps);
* under model 2 reduced falcon-mamba-7b builds its blocks (``in_proj`` as
  the rank's ``[u_r | z_r]``, half the whole leaf's columns), the same
  with ``sequence_parallel`` (a layout of the activations alone,
  ``tests/test_torch_sequence_parallel.py``), and a ``CheckpointHook`` of
  the sharded state saves and resumes it.
"""

import dataclasses
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
from repro_torch import bridge
from repro_torch.data import make_batch_for
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.optim import transform as T
from repro_torch.run import run
from repro_torch.sharding.specs import local_template
from repro_torch.training import init_params
from repro_torch.training.steps import param_template
from repro_torch.tree import tree_leaves
from torch_tp_common import (
    B,
    GEN,
    S,
    TICKS,
    Tables,
    async_spec,
    clip_spec,
    config,
    layout_of,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "2x2-repl": (2, 2)}
VARIANTS = ("mha", "kv1")

_WORKER = textwrap.dedent('''
    import dataclasses
    import sys
    import threading

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.run import run
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, leaf_paths
    from repro_torch.training.steps import _template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import (  # noqa: E402
        GEN, Tables, async_spec, clip_spec, config, differ, whole_over_data)


    def grads(cfg, local, batch, mesh, other_thread=False):
        """Loss, gradient, counted bytes and clip norm.  ``other_thread``
        runs the backward on a thread of its own, as autograd runs a CUDA
        backward on its device thread: a remat recompute there must see
        the rules too."""
        C.reset_collective_bytes()
        leaf = local.clone().requires_grad_()
        loss, _ = M.loss_fn(T.flat_view(leaf, _template(cfg, mesh)), C.local_rows(batch, mesh),
                            cfg)
        if other_thread:
            box = []
            th = threading.Thread(target=lambda: box.append(torch.autograd.grad(loss, leaf)),
                                  daemon=True)
            th.start()
            th.join()
            (g,) = box[0]
        else:
            (g,) = torch.autograd.grad(loss, leaf)
        if C.data_size(mesh) > 1:
            C.sum_grads_over_data(g, mesh, cfg)
        counted = dict(C.COLLECTIVE_BYTES)
        with torch.no_grad():
            sq = C.make_sq_norm(cfg, mesh)(g)
        return loss.detach(), g, counted, sq


    def worker(rank, world, data, model, tmp, repl):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        name = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{name}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        tag = f"{name}_{rank}"
        out = {"data": mesh.index("data"), "model": mesh.index("model")}
        with use_sharding_rules(mesh):
            for variant in ("mha", "kv1"):
                cfg = config(variant)
                tree = dict(np.load(f"{tmp}/params_{variant}.npz"))
                local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
                batch = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/batch.npz").items()}
                loss, g, counted, sq = grads(cfg, local, batch, mesh)
                out[f"{variant}_loss"] = loss.numpy()
                out[f"{variant}_grad"] = bridge.gather_params(g, cfg, mesh).numpy()
                out[f"{variant}_grad_bytes"] = np.array([counted[k] for k in sorted(counted)])
                out[f"{variant}_sq_norm"] = sq.numpy()
                params = T.flat_view(local, _template(cfg, mesh))
                C.reset_collective_bytes()
                with torch.no_grad():
                    res = serve(cfg, params, batch, gen=GEN)
                out[f"{variant}_serve_bytes"] = np.array(
                    [C.COLLECTIVE_BYTES[k] for k in sorted(C.COLLECTIVE_BYTES)])
                out[f"{variant}_prefill"] = res["prefill_logits"].numpy()
                out[f"{variant}_logits"] = res["logits"].numpy()
                out[f"{variant}_ids"] = res["tokens"].numpy()
            cfg = config("mha")
            tree = dict(np.load(f"{tmp}/params_mha.npz"))
            local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
            _, g, counted, _ = grads(dataclasses.replace(cfg, remat=True), local, batch, mesh,
                                     other_thread=True)
            out["remat_grad"] = bridge.gather_params(g, cfg, mesh).numpy()
            out["remat_grad_bytes"] = np.array([counted[k] for k in sorted(counted)])
            hook = Tables()
            state = run(async_spec(cfg, local, np.load(f"{tmp}/draws.npy")), hooks=[hook]).state
            out.update(hook.arrays())
            out["async_local"] = state.params.numpy()
            out["async_whole_over_data"] = whole_over_data(state.params, cfg, mesh).numpy()
            out["async_params"] = bridge.gather_params(state.params, cfg, mesh).numpy()
            out["async_ring_shape"] = np.array(state.delayed.ring.shape)
            out["state_bytes"] = sum(t.numel() * t.element_size() for _, t in leaf_paths(state)
                                     if isinstance(t, torch.Tensor))
            state = run(clip_spec(cfg, local)).state
            out["clip_params"] = bridge.gather_params(state.params, cfg, mesh).numpy()
            if (data, model) == (1, 2):
                from repro_torch.run import CheckpointHook
                from repro_torch.training import init_params

                ssm = reduced(get_config("falcon-mamba-7b"), d_model=64)
                out["ssm_in_proj"] = np.array(
                    init_params(0, ssm, "cpu")["stack"]["pos0"]["ssm"]["in_proj"].shape)
                out["ssm_sp_in_proj"] = np.array(init_params(
                    0, dataclasses.replace(ssm, sequence_parallel=True),
                    "cpu")["stack"]["pos0"]["ssm"]["in_proj"].shape)
                whole = run(clip_spec(cfg, local),
                            hooks=[CheckpointHook(f"{tmp}/ckpt", every=1)]).state
                resumed = run(clip_spec(cfg, local), resume_from=f"{tmp}/ckpt",
                              resume_step=1).state
                out["ckpt_differ"] = np.array(differ(whole, resumed), dtype=str)
                out["ckpt_params_shape"] = np.array(
                    np.load(f"{tmp}/ckpt/step_00000001.npz")[".params"].shape)
        np.savez(f"{tmp}/rank_{tag}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, repl in ((1, 2, False), (1, 4, False), (2, 2, False), (2, 2, True)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp, repl),
                                        nprocs=data * model, join=True)
        print("OK tensor parallel")
''')



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference(variant):
    """The reference's params (as numpy, by key path), config and batch."""
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    if variant == "kv1":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=1)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}, jcfg, params


def _reference_serve(jcfg, params, batch):
    """The reference's prefill and GEN greedy decode steps (f32 cache)."""
    logits, cache = JM.prefill(params, {"tokens": jnp.asarray(batch["tokens"])}, jcfg, S + GEN,
                               cache_dtype=jnp.float32)
    prefill = np.asarray(logits)
    last = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    steps, ids = [], []
    for i in range(GEN):
        logits, cache = JM.decode_step(params, cache, last, S + i, jcfg)
        last = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        steps.append(np.asarray(logits))
        ids.append(np.asarray(last))
    return prefill, np.stack(steps, axis=1), np.stack(ids, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and one process's results, and every rank's of the
    three layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    jbatch = j_make_batch_for(j_reduced(j_get_config("stablelm-1.6b"), d_model=64), batch=B,
                              seq=S, seed=0)
    batch = make_batch_for(config("mha"), batch=B, seq=S, seed=0)
    np.savez(tmp / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    draws = np.random.default_rng(0).random((TICKS, 4)).astype(np.float32)
    np.save(tmp / "draws.npy", draws)
    want = {}
    for variant in VARIANTS:
        tree, jcfg, jparams = _reference(variant)
        np.savez(tmp / f"params_{variant}.npz", **tree)
        cfg = config(variant)
        flat, _ = bridge.params_from_jax(tree, cfg)
        jl, jg = j_make_grad_fn(jcfg)(flat.numpy(), jbatch)
        leaf = flat.clone().requires_grad_()
        from repro_torch.models import model as M

        loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), batch, cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            res = serve(cfg, T.flat_view(flat, param_template(cfg)), batch, gen=GEN)
        jpre, jlogits, jids = _reference_serve(jcfg, jparams, batch)
        want[variant] = dict(
            flat=flat, jloss=float(jl), jgrad=np.asarray(jg), loss=loss.item(),
            grad=g.numpy(), sq=float(torch.sum(torch.square(g))),
            prefill=res["prefill_logits"].numpy(), logits=res["logits"].numpy(),
            ids=res["tokens"].numpy(), jprefill=jpre, jlogits=jlogits, jids=jids)
    cfg, flat = config("mha"), want["mha"]["flat"]
    hook = Tables()
    want["async"] = dict(params=run(async_spec(cfg, flat, draws), hooks=[hook]).state.params
                         .numpy(), **hook.arrays())
    want["clip"] = run(clip_spec(cfg, flat)).state.params.numpy()

    script = tmp / "tp_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), os.path.join(ROOT, "tests")],
                          env=env, cwd=str(tmp),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK tensor parallel" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    return dict(want=want, ranks=ranks)


def _cases():
    return [(name, variant) for name in LAYOUTS for variant in VARIANTS]


@pytest.mark.parametrize("name,variant", _cases())
def test_loss_and_gradient_match_one_process_and_reference(runs, name, variant):
    want = runs["want"][variant]
    scale = np.abs(want["grad"]).max()
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(float(r[f"{variant}_loss"]), want["loss"], rtol=1e-6)
        np.testing.assert_allclose(float(r[f"{variant}_loss"]), want["jloss"], rtol=1e-6)
        assert np.abs(r[f"{variant}_grad"] - want["grad"]).max() <= 1e-5 * scale
        assert np.abs(r[f"{variant}_grad"] - want["jgrad"]).max() <= \
            1e-5 * np.abs(want["jgrad"]).max()
        np.testing.assert_array_equal(r[f"{variant}_grad"], runs["ranks"][name][0][
            f"{variant}_grad"])


def _gathered_serve(ranks, variant, key):
    """The layout's logits in (row, vocab) order from every rank's block."""
    data = 1 + max(int(r["data"]) for r in ranks)
    model = 1 + max(int(r["model"]) for r in ranks)
    rows = []
    for d in range(data):
        group = sorted((r for r in ranks if int(r["data"]) == d), key=lambda r: int(r["model"]))
        assert len(group) == model
        rows.append(np.concatenate([r[f"{variant}_{key}"] for r in group], axis=-1))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name,variant", _cases())
def test_serve_matches_the_reference(runs, name, variant):
    want = runs["want"][variant]
    ranks = runs["ranks"][name]
    pre = _gathered_serve(ranks, variant, "prefill")
    logits = _gathered_serve(ranks, variant, "logits")
    np.testing.assert_allclose(pre, want["jprefill"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(logits, want["jlogits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pre, want["prefill"], rtol=0, atol=1e-4)
    data = 1 + max(int(r["data"]) for r in ranks)
    rows = B // data
    for r in ranks:
        d = int(r["data"])
        np.testing.assert_array_equal(r[f"{variant}_ids"], want["jids"][d * rows:(d + 1) * rows])
        np.testing.assert_array_equal(r[f"{variant}_ids"], want["ids"][d * rows:(d + 1) * rows])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_async_fused_run_matches_one_process(runs, name):
    want = runs["want"]["async"]
    ranks = runs["ranks"][name]
    for r in ranks:
        assert np.abs(r["async_params"] - want["params"]).max() <= 1e-5
        for k in ("losses", "tables", "cdfs", "hists"):
            if k == "losses":
                np.testing.assert_allclose(r[k], want[k], rtol=1e-6)
                np.testing.assert_array_equal(r[k], ranks[0][k])
            else:
                np.testing.assert_array_equal(r[k], want[k])
    data, model = LAYOUTS[name]
    with layout_of(name):
        n_local = sum(int(np.prod(s)) for s, _ in tree_leaves(
            local_template(config("mha"), make_mesh((data, model), ("data", "model")))))
    assert n_local < want["params"].shape[0]
    for r in ranks:
        assert r["async_local"].shape[0] == n_local
        assert tuple(r["async_ring_shape"]) == (4, n_local)
        for twin in (o for o in ranks if int(o["model"]) == int(r["model"])):
            np.testing.assert_array_equal(twin["async_whole_over_data"],
                                          r["async_whole_over_data"])
        if name.endswith("-repl"):
            np.testing.assert_array_equal(r["async_whole_over_data"], r["async_local"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rank_state_bytes_equal_the_plan(runs, name):
    """Each rank's async fused state (its flat blocks, momentum and ring, and
    the replicated tables) holds the bytes ``plan_run`` plans for one rank
    of the layout."""
    from repro_torch.launch.dryrun import plan_run

    data, model = LAYOUTS[name]
    spec = async_spec(config("mha"), None, np.zeros((TICKS, 4), np.float32))
    with layout_of(name):
        planned = plan_run(spec, mesh=make_mesh((data, model), ("data", "model")))
    for r in runs["ranks"][name]:
        assert int(r["state_bytes"]) == planned["memory"]["argument_bytes"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_clip_norm_is_the_global_one(runs, name):
    for variant in VARIANTS:
        for r in runs["ranks"][name]:
            np.testing.assert_allclose(float(r[f"{variant}_sq_norm"]), runs["want"][variant]["sq"],
                                       rtol=1e-6)
    for r in runs["ranks"][name]:
        assert np.abs(r["clip_params"] - runs["want"]["clip"]).max() <= 1e-5


@pytest.mark.parametrize("name,variant", _cases())
def test_counted_all_reduce_bytes_equal_the_plan(runs, name, variant):
    from repro_torch.sharding.collectives import COLLECTIVE_BYTES

    data, model = LAYOUTS[name]
    mesh = make_mesh((data, model), ("data", "model"))
    cfg = config(variant)
    keys = sorted(COLLECTIVE_BYTES)
    with layout_of(name):
        train = port_collective_bytes(cfg, "train", B, S, mesh)["counted"]
        pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
        dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
    want_train = [train.get(k, 0) for k in keys]
    want_serve = [pre.get(k, 0) + GEN * dec.get(k, 0) for k in keys]
    for r in runs["ranks"][name]:
        assert r[f"{variant}_grad_bytes"].tolist() == want_train
        assert r[f"{variant}_serve_bytes"].tolist() == want_serve
    assert sum(want_train) > 0 and sum(want_serve) > 0


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_remat_recomputes_every_forward_all_reduce(runs, name):
    """With ``cfg.remat`` the backward recomputes each block whole, its two
    all-reduces and its FSDP gathers included, and the gradient is the one
    without remat, also
    when the backward runs on a thread of its own (a CUDA backward runs on
    autograd's device thread)."""
    from repro_torch.sharding.collectives import COLLECTIVE_BYTES

    data, model = LAYOUTS[name]
    cfg = dataclasses.replace(config("mha"), remat=True)
    with layout_of(name):
        plan = port_collective_bytes(cfg, "train", B, S,
                                     make_mesh((data, model), ("data", "model")))
        base = port_collective_bytes(config("mha"), "train", B, S,
                                     make_mesh((data, model), ("data", "model")))["counted"]
    want = [plan["counted"].get(k, 0) for k in sorted(COLLECTIVE_BYTES)]
    assert plan["counted"]["attn"] == 2 * base["attn"] and plan["counted"]["mlp"] == 2 * base["mlp"]
    # the recompute gathers each layer's weights again (the embedding is gathered once)
    assert plan["counted"]["fsdp_grad"] == base["fsdp_grad"]
    fsdp = data > 1 and not name.endswith("-repl")
    assert (plan["counted"]["fsdp_gather"] > base["fsdp_gather"]) == fsdp
    scale = np.abs(runs["want"]["mha"]["grad"]).max()
    for r in runs["ranks"][name]:
        assert r["remat_grad_bytes"].tolist() == want
        assert np.abs(r["remat_grad"] - runs["want"]["mha"]["grad"]).max() <= 1e-5 * scale


def test_unsharded_layouts_raise_and_sharded_checkpoints_resume(runs):
    """The Mamba layer, which the port shards, builds the rank's blocks,
    the same under ``sequence_parallel``, which no longer raises (it lays
    out the activations, not the params); a ``CheckpointHook`` of the
    sharded clip run saves the one-process ``(N,)`` params, and a resume
    from step 1 ends bit for bit where the run that was not interrupted
    did."""
    r = runs["ranks"]["1x2"][0]
    assert tuple(r["ssm_in_proj"]) == (2, 64, 2 * 128 // 2)  # 2 layers, d 64, [u_r | z_r]
    assert tuple(r["ssm_sp_in_proj"]) == tuple(r["ssm_in_proj"])
    n = sum(int(np.prod(s)) for s, _ in tree_leaves(param_template(config("mha"))))
    for r in runs["ranks"]["1x2"]:
        assert tuple(r["ckpt_params_shape"]) == (n,)
        assert r["ckpt_differ"].tolist() == []


@pytest.mark.parametrize("name", ["2x1", "2x1-repl"])
def test_the_plan_counts_the_data_parallel_gradient(name):
    """data 2 x model 1 adds nothing over model but the gradient and the
    loss: replicated, the whole flat gradient in one all-reduce; in FSDP
    the gradient of the leaves whole over data (the norms) in an all-reduce
    and the rest reduce-scattered, every weight gathered once in the
    forward."""
    cfg = config("mha")
    n = sum(int(np.prod(s)) for s, _ in tree_leaves(param_template(cfg)))
    with layout_of(name):
        only_data = port_collective_bytes(cfg, "train", B, S,
                                          make_mesh((2, 1), ("data", "model")))
    c = only_data["counted"]
    assert c["grad"] + c["fsdp_grad"] == 4 * n and c["loss"] == 8
    assert c["embed"] == c["backward"] == 0
    assert only_data["all-reduce"] == pytest.approx(c["loss"] + c["grad"])
    if name.endswith("-repl"):
        assert c["fsdp_grad"] == c["fsdp_gather"] == 0
    else:
        assert 0 < c["grad"] < c["fsdp_grad"] == c["fsdp_gather"]
        assert only_data["all-gather"] == only_data["reduce-scatter"] == \
            pytest.approx(c["fsdp_grad"] / 2)


def test_one_process_layout_takes_the_one_process_path():
    """A layout with no running processes (planning) leaves the model, its
    loss and its serve step bitwise as one process runs them."""
    from repro_torch.models import model as M
    from repro_torch.sharding import use_sharding_rules

    cfg = config("mha")
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
    params = T.flat_view(flat, param_template(cfg))
    want = M.loss_fn(params, batch, cfg)[0]
    with use_sharding_rules(make_mesh((2, 2), ("data", "model"), device="cpu")):
        got = M.loss_fn(params, batch, cfg)[0]
    assert torch.equal(got, want)
