"""Port parity, an MoE arch trained through ``make_step`` under tensor and
data parallelism, run as gloo processes on the CPU against one process of
the port and against the reference's ``make_grad_fn``.

The config is reduced qwen2-moe-a2.7b (d_model 256, 4 heads, 4 experts of
top 2, a shared expert, vocab 512, 2 layers, f32) with ``router_aux_coef``
0.5, so that the router's load-balance loss carries a share of the gradient
far above the bound (at the config's 0.001 a wrong weight of aux would hide
under it).  Batch 2 x seq 16, the reference's ``init_params`` carried over
as numpy.  Three layouts, one spawn of its ranks each (``_WORKER``), under
``use_sharding_rules(mesh)`` with a running ``make_mesh`` layout:

* ``1x2``: data 1 x model 2 (expert-parallel MoE, attention and shared
  expert split over ``model``);
* ``2x1``: data 2 x model 1 (each rank routes its own row);
* ``2x2``: data 2 x model 2;
* ``2x1-repl`` and ``2x2-repl``: the same two with every weight whole over
  ``data`` (``replicate_params_over_data``); the two above run the
  reference's FSDP storage over ``data`` (the expert stacks' d_ff, the
  router's and the attention's d_model split over ``data`` and gathered a
  layer at a time).

Each rank takes one sync step of ``make_step`` (``trace(0.9)`` then
``scale``: after one step the trace is the gradient itself) and hands back
its loss, its gradient put back together with ``bridge.gather_params`` and
the bytes it handed to all-reduce.

What a layout computes is the reference's sharded loss: each data shard
routes its own rows with its own capacity, and the load-balance loss is the
mean over shards of each shard's (``pmean`` in the reference's
``apply_moe``); the cross-entropy is the token mean over the global batch,
which is the mean over shards of each shard's token mean, since every row
has the same number of labels.  So the one-process target is the mean over
the data shards of the one-process loss and gradient on each shard's rows.
Bounds: loss within 1e-6 relative, gradient within 1e-5 of max |g| (the
bound of ``tests/test_torch_grad_parity.py``); the counted bytes equal
``launch.analysis.port_collective_bytes`` exactly.  Under model 2, params
held whole raise instead of running whole on every rank: the model's loss
on the whole tree, and ``apply_moe`` on whole expert stacks.
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
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.sharding.collectives import COLLECTIVE_BYTES
from repro_torch.training.steps import param_template
from torch_tp_common import REPL, layout_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "2x1-repl": (2, 1), "2x2-repl": (2, 2)}
B, S, AUX = 2, 16, 0.5

_WORKER = textwrap.dedent('''
    import dataclasses
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.optim import transform as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, local_template
    from repro_torch.training.steps import init_train_state, make_step


    def worker(rank, world, data, model, tmp, repl):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        layout = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{layout}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), router_aux_coef=0.5)
        tree = dict(np.load(f"{tmp}/params.npz"))
        batch = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/batch.npz").items()}
        opt = T.chain(T.trace(0.9), T.scale(-0.05))
        with use_sharding_rules(mesh):
            local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
            state = init_train_state(cfg, opt, device="cpu",
                                     params=T.flat_view(local, local_template(cfg, mesh)))
            step = make_step(cfg, opt, mode="sync")
            C.reset_collective_bytes()
            state, metrics = step(state, batch)
            counted = dict(C.COLLECTIVE_BYTES)
            grad = bridge.gather_params(T.pack_flat(state.opt_state[0]), cfg, mesh)
            errors = {}
            if model > 1:
                # params held whole must not run whole on every rank
                whole, template = bridge.params_from_jax(tree, cfg)
                whole = T.flat_view(whole, template)
                for name, fn in (
                        ("whole_tree", lambda: M.loss_fn(whole, batch, cfg)),
                        ("whole_experts", lambda: MOE.apply_moe(
                            whole["stack"]["pos0"]["moe"],
                            torch.zeros((1, 4, cfg.d_model)), cfg))):
                    try:
                        fn()
                    except ValueError as e:
                        errors[name] = str(e)
        np.savez(f"{tmp}/rank_{layout}_{rank}.npz", loss=metrics["loss"].numpy(),
                 grad=grad.numpy(), bytes=np.array([counted[k] for k in sorted(counted)]),
                 **errors)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, repl in ((1, 2, False), (2, 1, False), (2, 2, False), (2, 1, True),
                                  (2, 2, True)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp, repl),
                                        nprocs=data * model, join=True)
        print("OK tensor parallel MoE")
''')


def config():
    return dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), router_aux_coef=AUX)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each data width, the mean over shards of one process's and of
    the reference's loss and gradient on each shard's rows; and every
    rank's results of the three layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("tp_moe")
    cfg = config()
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen2-moe-a2.7b")), router_aux_coef=AUX)
    keys, leaves, _ = _flatten_with_keys(j_init_params(jax.random.PRNGKey(0), jcfg))
    tree = {k: np.asarray(v) for k, v in zip(keys, leaves)}
    np.savez(tmp / "params.npz", **tree)
    batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
    np.savez(tmp / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    flat, _ = bridge.params_from_jax(tree, cfg)
    grad_fn = j_make_grad_fn(jcfg)
    want = {}
    for data in sorted({d for d, _ in LAYOUTS.values()}):
        rows = B // data
        shards = [{k: v[d * rows:(d + 1) * rows] for k, v in batch.items()} for d in range(data)]
        assert len({int((s["labels"] >= 0).sum()) for s in shards}) == 1
        losses, grads, jlosses, jgrads = [], [], [], []
        for shard in shards:
            leaf = flat.clone().requires_grad_()
            loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), shard, cfg)
            (g,) = torch.autograd.grad(loss, leaf)
            losses.append(loss.item())
            grads.append(g.numpy())
            jl, jg = grad_fn(flat.numpy(), {k: jnp.asarray(v.numpy()) for k, v in shard.items()})
            jlosses.append(jl)
            jgrads.append(np.asarray(jg))
        want[data] = dict(loss=np.mean(losses), grad=np.mean(grads, axis=0),
                          jloss=np.mean(jlosses), jgrad=np.mean(jgrads, axis=0))

    script = tmp / "tp_moe_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp)], env=env, cwd=str(tmp),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK tensor parallel MoE" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    return dict(want=want, ranks=ranks)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_step_matches_one_process_and_reference(runs, name):
    want = runs["want"][LAYOUTS[name][0]]
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(float(r["loss"]), want["loss"], rtol=1e-6)
        np.testing.assert_allclose(float(r["loss"]), want["jloss"], rtol=1e-6)
        assert np.abs(r["grad"] - want["grad"]).max() <= 1e-5 * np.abs(want["grad"]).max()
        assert np.abs(r["grad"] - want["jgrad"]).max() <= 1e-5 * np.abs(want["jgrad"]).max()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_step_all_reduce_bytes_equal_the_plan(runs, name):
    data, model = LAYOUTS[name]
    with layout_of(name):
        plan = port_collective_bytes(config(), "train", B, S,
                                     make_mesh((data, model), ("data", "model")))["counted"]
    assert (plan["fsdp_gather"] > 0) == (data > 1 and not name.endswith(REPL))
    want = [plan.get(k, 0) for k in sorted(COLLECTIVE_BYTES)]
    for r in runs["ranks"][name]:
        assert r["bytes"].tolist() == want


@pytest.mark.parametrize("name", [n for n, (_, m) in LAYOUTS.items() if m > 1])
def test_whole_params_under_a_model_axis_raise(runs, name):
    for r in runs["ranks"][name]:
        assert "rank's block" in str(r["whole_tree"]), r.get("whole_tree")
        assert "local_expert_params" in str(r["whole_experts"]), r.get("whole_experts")
