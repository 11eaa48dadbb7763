"""Port parity, the weights-stationary MoE served and trained over ``data``,
run as gloo processes on the CPU against one process of the port on the
whole global batch and against the reference's ``make_grad_fn``.

The config is ``tests/test_torch_tp_moe.py``'s reduced qwen2-moe-a2.7b
(d_model 256, 4 experts of top 2 with a d_ff of 256, a shared expert,
vocab 512, 2 layers, f32, ``router_aux_coef`` 0.5) with
``moe_weights_stationary``: the expert stacks split the expert axis over
``model`` and d_ff over ``data`` in both storage layouts, and are never
gathered.  Params are the reference's ``init_params`` carried over as
numpy, batch 2 x seq 16.  One subprocess spawns the ranks of each layout in
turn (``_WORKER``), under ``use_sharding_rules(mesh)`` with a running
``make_mesh`` layout: ``2x2`` first (its checkpoint is restored by the
later layouts), then ``2x1``, ``2x1-repl``, ``2x2-repl`` (every weight but
the expert stacks whole over ``data``) and ``1x2``.

What the layout computes is one process's step on the whole global batch:
every rank routes the gathered tokens of its data group with the capacity
of all of them, so the routes, the drops, aux and the loss are the
one-process ones (not the mean over data shards of the expert-parallel
layout, ``tests/test_torch_tp_moe.py``).  Each layout's ranks:

* serve (a prefill and ``GEN`` greedy steps of ``launch.serve.serve``) and
  take the model's loss (``loss_fn`` on their rows): the prefill logits
  within 1e-4 of one process's on the rank's rows and vocab block, the
  ids equal, the loss within 1e-6 relative.  Before the weights-stationary
  branch ran at one ``model`` rank, each rank of ``2x1`` ran the
  one-process route on half of every expert's d_ff (ROADMAP Queue 3);
* take one sync ``make_step`` step (``trace(0.9)`` then ``scale``: the
  trace is the gradient): loss within 1e-6 relative and the gathered
  gradient within 1e-5 of max |g| of one process's and of the reference's;
* run 4 fused async ticks (``run(RunSpec(mode="async", fuse=True))``,
  kernel 1's plain version on the CPU, a refresh every 2): losses within
  1e-6 relative, gathered params within 1e-5 of one process's; and 2 sync
  fused steps whose clip binds, within 1e-5;
* count exactly the bytes ``launch.analysis.port_collective_bytes`` plans
  for the serve and for the step, and hold the state bytes ``plan_run``
  plans;
* restore the ``2x2`` checkpoint (saved at tick 3 of the async run) into
  their layout, every leaf bit for bit the rank's blocks of the file's
  (``specs.local_shard``, the cut ``specs.localize`` makes); and in one
  process the file's leaves bit for bit;
* at ``model`` 2, serve and step again with ``sequence_parallel``: the
  same bounds and the plan's bytes.
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
from repro.distributed import make_grad_fn as j_make_grad_fn
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.run import run
from repro_torch.sharding.collectives import COLLECTIVE_BYTES
from repro_torch.training.steps import param_template
from torch_tp_common import (
    B,
    S,
    Tables,
    async_spec,
    clip_spec,
    file_leaves,
    layout_of,
    np_bits,
    restored,
    state_bits,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
LAYOUTS = {"2x2": (2, 2), "2x1": (2, 1), "2x1-repl": (2, 1), "2x2-repl": (2, 2),
           "1x2": (1, 2)}  # spawned in order
AUX, GEN, SAVE_AT = 0.5, 4, 3

_WORKER = textwrap.dedent('''
    import dataclasses
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, Hook, run
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, leaf_paths, local_template
    from repro_torch.training.steps import init_train_state, make_step

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import async_spec, blocks_differ, clip_spec, restored  # noqa: E402

    GEN, SAVE_AT = %d, %d


    class Losses(Hook):
        def __init__(self):
            self.losses = []

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())


    def worker(rank, world, data, model, tmp, repl):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        name = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{name}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), router_aux_coef=0.5,
                                  moe_weights_stationary=True)
        tree = dict(np.load(f"{tmp}/params.npz"))
        batch = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/batch.npz").items()}
        draws = np.load(f"{tmp}/draws.npy")
        out = {}
        with use_sharding_rules(mesh):
            local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
            params = T.flat_view(local, local_template(cfg, mesh))
            with torch.no_grad():
                C.reset_collective_bytes()
                res = serve(cfg, params, batch, gen=GEN)
                out["serve_bytes"] = json.dumps(dict(C.COLLECTIVE_BYTES))
                out["loss_fwd"] = M.loss_fn(params, C.local_rows(batch, mesh), cfg)[0].numpy()
            out.update(prefill=res["prefill_logits"].numpy(), tokens=res["tokens"].numpy())

            opt = T.chain(T.trace(0.9), T.scale(-0.05))
            state = init_train_state(cfg, opt, device="cpu", params=params)
            step = make_step(cfg, opt, mode="sync")
            C.reset_collective_bytes()
            state, metrics = step(state, batch)
            out["step_bytes"] = json.dumps(dict(C.COLLECTIVE_BYTES))
            out["loss"] = metrics["loss"].numpy()
            out["grad"] = bridge.gather_params(T.pack_flat(state.opt_state[0]), cfg,
                                               mesh).numpy()

            losses = Losses()
            hooks = [losses]
            if name == "2x2":
                hooks.append(CheckpointHook(f"{tmp}/ck", every=SAVE_AT))
            spec = async_spec(cfg, local, draws)
            state = run(spec, hooks=hooks).state
            out["async_losses"] = np.array(losses.losses)
            out["async_params"] = bridge.gather_params(state.params, cfg, mesh).numpy()
            out["state_bytes"] = sum(t.numel() * t.element_size() for _, t in leaf_paths(state)
                                     if isinstance(t, torch.Tensor))
            out["restore_differ"] = json.dumps(
                blocks_differ(f"{tmp}/ck", restored(spec, f"{tmp}/ck"), cfg, mesh))
            out["clip_params"] = bridge.gather_params(run(clip_spec(cfg, local)).state.params,
                                                      cfg, mesh).numpy()
            if model > 1:  # with Megatron sequence parallelism
                sp = dataclasses.replace(cfg, sequence_parallel=True)
                with torch.no_grad():
                    C.reset_collective_bytes()
                    res = serve(sp, params, batch, gen=GEN)
                    out["sp_serve_bytes"] = json.dumps(dict(C.COLLECTIVE_BYTES))
                out.update(sp_prefill=res["prefill_logits"].numpy(),
                           sp_tokens=res["tokens"].numpy())
                state = init_train_state(sp, opt, device="cpu", params=params)
                C.reset_collective_bytes()
                state, metrics = make_step(sp, opt, mode="sync")(state, batch)
                out["sp_step_bytes"] = json.dumps(dict(C.COLLECTIVE_BYTES))
                out["sp_loss"] = metrics["loss"].numpy()
                out["sp_grad"] = bridge.gather_params(T.pack_flat(state.opt_state[0]), cfg,
                                                      mesh).numpy()
        np.savez(f"{tmp}/rank_{name}_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, repl in ((2, 2, False), (2, 1, False), (2, 1, True), (2, 2, True),
                                  (1, 2, False)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp, repl),
                                        nprocs=data * model, join=True)
        print("OK weights-stationary MoE")
''') % (GEN, SAVE_AT)


def config():
    return dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), router_aux_coef=AUX,
                               moe_weights_stationary=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's serve, loss, gradient and async run on the whole
    batch, the reference's loss and gradient; and every rank's results of
    the five layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("tp_stationary")
    cfg = config()
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen2-moe-a2.7b")), router_aux_coef=AUX,
                               moe_weights_stationary=True)
    keys, leaves, _ = _flatten_with_keys(j_init_params(jax.random.PRNGKey(0), jcfg))
    tree = {k: np.asarray(v) for k, v in zip(keys, leaves)}
    np.savez(tmp / "params.npz", **tree)
    batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
    np.savez(tmp / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    draws = np.random.default_rng(7).random((8, 4)).astype(np.float32)
    np.save(tmp / "draws.npy", draws)

    flat, _ = bridge.params_from_jax(tree, cfg)
    params = T.flat_view(flat, param_template(cfg))
    with torch.no_grad():
        res = serve(cfg, params, batch, gen=GEN)
    leaf = flat.clone().requires_grad_()
    loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), batch, cfg)
    (grad,) = torch.autograd.grad(loss, leaf)
    jloss, jgrad = j_make_grad_fn(jcfg)(flat.numpy(),
                                        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    tables = Tables()
    state = run(async_spec(cfg, flat, draws), hooks=[tables]).state
    clip = run(clip_spec(cfg, flat)).state.params.numpy()
    want = dict(prefill=res["prefill_logits"].numpy(), tokens=res["tokens"].numpy(),
                loss=loss.item(), grad=grad.numpy(), jloss=float(jloss), jgrad=np.asarray(jgrad),
                async_losses=tables.arrays()["losses"], async_params=state.params.numpy(),
                clip=clip)

    script = tmp / "tp_stationary_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), TESTS], env=env,
                          cwd=str(tmp), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK weights-stationary MoE" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    return dict(want=want, ranks=ranks, tmp=tmp, draws=draws, flat=flat)


def _rows_and_block(r, name, want):
    """One process's ``want`` cut to what rank ``r`` of ``name`` holds:
    its batch rows, and its vocab block of the last dim."""
    data, model = LAYOUTS[name]
    rows = B // data
    d, m = int(r["coords"][0]), int(r["coords"][1])
    v = want.shape[-1] // model
    return want[d * rows:(d + 1) * rows, ..., m * v:(m + 1) * v]


def _coords(runs, name):
    data, model = LAYOUTS[name]
    for rank, r in enumerate(runs["ranks"][name]):
        r["coords"] = (rank // model, rank % model)
    return runs["ranks"][name]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_serve_and_loss_match_one_process(runs, name):
    """The fault of ROADMAP Queue 3 (data 2 x model 1): served and scored,
    a rank equals one process on the whole batch."""
    want = runs["want"]
    for r in _coords(runs, name):
        np.testing.assert_allclose(r["prefill"], _rows_and_block(r, name, want["prefill"]),
                                   rtol=0, atol=1e-4)
        rows = B // LAYOUTS[name][0]
        d = int(r["coords"][0])
        assert np.array_equal(r["tokens"], want["tokens"][d * rows:(d + 1) * rows])
        np.testing.assert_allclose(float(r["loss_fwd"]), want["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_step_matches_one_process_and_reference(runs, name):
    want = runs["want"]
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(float(r["loss"]), want["loss"], rtol=1e-6)
        np.testing.assert_allclose(float(r["loss"]), want["jloss"], rtol=1e-6)
        assert np.abs(r["grad"] - want["grad"]).max() <= 1e-5 * np.abs(want["grad"]).max()
        assert np.abs(r["grad"] - want["jgrad"]).max() <= 1e-5 * np.abs(want["jgrad"]).max()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_async_ticks_match_one_process(runs, name):
    want = runs["want"]
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(r["async_losses"], want["async_losses"], rtol=1e-6)
        assert np.abs(r["async_params"] - want["async_params"]).max() <= 1e-5


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_clip_run_matches_one_process(runs, name):
    """2 sync fused steps whose clip binds: the clip link's squared norm
    sums the expert stacks' squares over ``model`` and ``data``."""
    for r in runs["ranks"][name]:
        assert np.abs(r["clip_params"] - runs["want"]["clip"]).max() <= 1e-5


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_bytes_equal_the_plan(runs, name):
    """The serve (a prefill and GEN steps) and the step count what
    ``port_collective_bytes`` plans, purpose by purpose."""
    import json

    data, model = LAYOUTS[name]
    with layout_of(name):
        mesh = make_mesh((data, model), ("data", "model"))
        train = port_collective_bytes(config(), "train", B, S, mesh)["counted"]
        pre = port_collective_bytes(config(), "prefill", B, S, mesh)["counted"]
        dec = port_collective_bytes(config(), "decode", B, S, mesh)["counted"]
    assert train["gather"] > 0 and train["combine"] > 0
    for r in runs["ranks"][name]:
        step, served = json.loads(str(r["step_bytes"])), json.loads(str(r["serve_bytes"]))
        assert {k: step[k] for k in sorted(COLLECTIVE_BYTES)} == \
            {k: train.get(k, 0) for k in sorted(COLLECTIVE_BYTES)}
        assert {k: served[k] for k in sorted(COLLECTIVE_BYTES)} == \
            {k: pre.get(k, 0) + GEN * dec.get(k, 0) for k in sorted(COLLECTIVE_BYTES)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_rank_state_bytes_equal_the_plan(runs, name):
    """Each rank's async fused state (its flat blocks with the expert
    stacks' d_ff block over ``data`` in both layouts, momentum and ring,
    and the replicated tables) holds the bytes ``plan_run`` plans."""
    from repro_torch.launch.dryrun import plan_run

    data, model = LAYOUTS[name]
    spec = async_spec(config(), None, runs["draws"])
    with layout_of(name):
        planned = plan_run(spec, mesh=make_mesh((data, model), ("data", "model")))
    for r in runs["ranks"][name]:
        assert int(r["state_bytes"]) == planned["memory"]["argument_bytes"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stationary_checkpoint_restores_every_layout(runs, name):
    """The 2x2 checkpoint, restored in every layout: each rank's leaves bit
    for bit its blocks of the file's, the expert stacks' d_ff block over
    ``data`` in the replicated layout too."""
    import json

    for r in runs["ranks"][name]:
        assert json.loads(str(r["restore_differ"])) == []


@pytest.mark.parametrize("name", [n for n, (_, m) in LAYOUTS.items() if m > 1])
def test_stationary_with_sequence_parallel_matches_one_process(runs, name):
    """``sequence_parallel`` on top: the sequence gathered over ``model``
    before the MoE and its weights-stationary output cut to the rank's
    chunk; served, stepped and counted as one process and the plan."""
    import json

    want = runs["want"]
    data, model = LAYOUTS[name]
    cfg = dataclasses.replace(config(), sequence_parallel=True)
    with layout_of(name):
        mesh = make_mesh((data, model), ("data", "model"))
        train = port_collective_bytes(cfg, "train", B, S, mesh)["counted"]
        pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
        dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
    assert train["sp_gather"] > 0 and train["gather"] > 0
    keys = sorted(COLLECTIVE_BYTES)
    for r in _coords(runs, name):
        np.testing.assert_allclose(r["sp_prefill"], _rows_and_block(r, name, want["prefill"]),
                                   rtol=0, atol=1e-4)
        assert np.array_equal(r["sp_tokens"], r["tokens"])
        np.testing.assert_allclose(float(r["sp_loss"]), want["loss"], rtol=1e-6)
        assert np.abs(r["sp_grad"] - want["grad"]).max() <= 1e-5 * np.abs(want["grad"]).max()
        step, served = json.loads(str(r["sp_step_bytes"])), json.loads(str(r["sp_serve_bytes"]))
        assert {k: step[k] for k in keys} == {k: train.get(k, 0) for k in keys}
        assert {k: served[k] for k in keys} == \
            {k: pre.get(k, 0) + GEN * dec.get(k, 0) for k in keys}


def test_stationary_checkpoint_restores_in_one_process(runs):
    _, whole = file_leaves(runs["tmp"] / "ck", SAVE_AT)
    spec = async_spec(config(), runs["flat"], runs["draws"])
    held = state_bits(restored(spec, str(runs["tmp"] / "ck"), SAVE_AT))
    assert [k for k, v in held.items() if not np.array_equal(np_bits(whole[k]), v)] == []
