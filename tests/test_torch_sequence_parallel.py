"""Port parity, Megatron sequence parallelism (``cfg.sequence_parallel``)
and ``cfg.shard_grads``, run as gloo processes on the CPU against the
reference, against the same ranks without them and against one process of
the port.

Under ``sequence_parallel`` and a ``model`` axis that divides the
sequence, the residual stream between the blocks is the rank's chunk of
the sequence (the reference's ``seq_sp`` rule in ``apply_block``): the
norms and the residual adds run on the chunk, every mixer's and MLP's
input is gathered over ``model`` before its column-parallel projections
(only the chunk kept for the backward, which gathers it again), and its
row-parallel output reduce-scattered in place of the all-reduce
(``sharding/collectives.py``: ``enter_linear`` / ``leave_model``).  The
configs are ``tests/torch_tp_common.py``'s (``sp_config``): reduced
stablelm-1.6b at d_model 64 (``dense``), reduced qwen2-moe-a2.7b
expert-parallel (``moe``; ``moe-whole-shared`` with a shared expert whose
d_ff does not split over ``model``), reduced qwen3-moe-235b-a22b (no shared
expert), falcon-mamba-7b and recurrentgemma-9b of ``ARCH_UPDATES``; params
from the reference's ``init_params`` carried over with
``bridge.params_from_jax``, batch 2 x seq 16 from numpy.  One subprocess
spawns the ranks of each layout in turn (``_WORKER``): ``1x2`` (every
config), ``1x4`` and ``2x2`` (the dense one) and ``2x1-repl`` (the dense
one, every weight whole over ``data``).

Each rank, for each of its configs, with and without ``sequence_parallel``:
one sync ``make_step`` step (the loss within 1e-6 relative and the
gathered gradient within 1e-5 of max |g| of the reference's
``make_grad_fn``, of one process's and of the ranks' without it), a serve
of a prefill and ``SP_GEN`` greedy steps (the prefill logits within 1e-4 of
the reference's ``prefill`` and of one process's on the rank's rows and
vocab block, the ids equal; decode steps, S = 1, run as without it), the
bytes of both equal to ``launch.analysis.port_collective_bytes`` exactly.
At ``2x2`` (FSDP storage over ``data``) and ``2x1-repl`` a ``shard_grads``
step is bit for bit the step without it.  In one process both flags change
nothing, bit for bit.
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
from repro.distributed import make_grad_fn as j_make_grad_fn
from repro.models import model as JM
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.data import make_batch_for
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.sharding.collectives import COLLECTIVE_BYTES
from repro_torch.training.steps import param_template
from torch_tp_common import SP_GEN, B, S, layout_of, sp_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
CASES = ("dense", "moe", "moe-whole-shared", "qwen3-moe", "falcon-mamba-7b",
         "recurrentgemma-9b")
LAYOUTS = {"1x2": ((1, 2), CASES), "1x4": ((1, 4), ("dense",)), "2x2": ((2, 2), ("dense",)),
           "2x1-repl": ((2, 1), ("dense",))}  # spawned in order
RUNS = [(name, case) for name, (_, cases) in LAYOUTS.items() for case in cases]

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
    from repro_torch.optim import transform as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS
    from repro_torch.training.steps import _template, init_train_state, make_step

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import SP_GEN, differ, sp_config  # noqa: E402

    LAYOUTS = %r


    def step_once(cfg, mesh, local, batch):
        """One sync step from the rank's blocks ``local``: (state, loss, bytes)."""
        opt = T.chain(T.trace(0.9), T.scale(-0.05))
        params = T.flat_view(local.clone(), _template(cfg, mesh))
        state = init_train_state(cfg, opt, device="cpu", params=params)
        step = make_step(cfg, opt, mode="sync")
        C.reset_collective_bytes()
        state, metrics = step(state, batch)
        return state, metrics["loss"].numpy(), json.dumps(dict(C.COLLECTIVE_BYTES))


    def worker(rank, world, data, model, tmp, repl, cases):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        name = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{name}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        out = {}
        with use_sharding_rules(mesh):
            for case in cases:
                base = sp_config(case)
                tree = dict(np.load(f"{tmp}/params_{case}.npz"))
                batch = {k: torch.from_numpy(v)
                         for k, v in np.load(f"{tmp}/batch_{case}.npz").items()}
                local, _ = bridge.params_from_jax(tree, base, mesh=mesh)
                for sp in (False, True):
                    cfg = dataclasses.replace(base, sequence_parallel=sp)
                    tag = f"{case}_{sp}"
                    with torch.no_grad():
                        C.reset_collective_bytes()
                        res = serve(cfg, T.flat_view(local, _template(cfg, mesh)), batch,
                                    gen=SP_GEN)
                    out[f"{tag}_serve_bytes"] = json.dumps(dict(C.COLLECTIVE_BYTES))
                    out[f"{tag}_prefill"] = res["prefill_logits"].numpy()
                    out[f"{tag}_tokens"] = res["tokens"].numpy()
                    state, out[f"{tag}_loss"], out[f"{tag}_bytes"] = step_once(cfg, mesh, local,
                                                                               batch)
                    out[f"{tag}_grad"] = bridge.gather_params(T.pack_flat(state.opt_state[0]),
                                                              cfg, mesh).numpy()
                    if not sp and data > 1:
                        grads = dataclasses.replace(cfg, shard_grads=True)
                        pinned = step_once(grads, mesh, local, batch)[0]
                        out[f"{case}_shard_grads_differ"] = json.dumps(differ(state, pinned))
        np.savez(f"{tmp}/rank_{name}_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for name, ((data, model), cases) in LAYOUTS.items():
            torch.multiprocessing.spawn(
                worker, args=(data * model, data, model, tmp, name.endswith("-repl"), cases),
                nprocs=data * model, join=True)
        print("OK sequence parallel")
''') % (LAYOUTS,)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _one_process(cfg, flat, batch):
    """One process's loss and gradient, prefill logits and ids."""
    leaf = flat.clone().requires_grad_()
    loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), batch, cfg)
    (grad,) = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        res = serve(cfg, T.flat_view(flat, param_template(cfg)), batch, gen=SP_GEN)
    return dict(loss=loss.detach(), grad=grad, prefill=res["prefill_logits"],
                tokens=res["tokens"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's loss, gradient and prefill logits and one process's
    results for each config, with and without the flags; and every rank's
    results of the four layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("sequence_parallel")
    one, ref = {}, {}
    for case in CASES:
        jcfg, cfg = sp_config(case, j_reduced, j_get_config), sp_config(case)
        jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
        keys, leaves, _ = _flatten_with_keys(jparams)
        tree = {k: np.asarray(v) for k, v in zip(keys, leaves)}
        np.savez(tmp / f"params_{case}.npz", **tree)
        batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
        np.savez(tmp / f"batch_{case}.npz", **{k: v.numpy() for k, v in batch.items()})
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        flat, _ = bridge.params_from_jax(tree, cfg)
        jl, jg = j_make_grad_fn(jcfg)(flat.numpy(), jbatch)
        jpre, _ = JM.prefill(jparams, jbatch, jcfg, S + SP_GEN, cache_dtype=jnp.float32)
        ref[case] = dict(loss=float(jl), grad=np.asarray(jg), prefill=np.asarray(jpre))
        for flag in ("plain", "sequence_parallel", "shard_grads"):
            upd = {} if flag == "plain" else {flag: True}
            one[case, flag] = _one_process(dataclasses.replace(cfg, **upd), flat, batch)
    script = tmp / "sequence_parallel_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), TESTS], env=env,
                          cwd=str(tmp), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK sequence parallel" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, ((d, m), _) in LAYOUTS.items()}
    return dict(one=one, ref=ref, ranks=ranks)


def _mine(rank, name, whole):
    """One process's ``whole`` (rows, ..., vocab) cut to rank ``rank``'s
    rows and vocab block."""
    (data, model), _ = LAYOUTS[name]
    d, m, rows = rank // model, rank % model, B // data
    v = whole.shape[-1] // model
    return whole[d * rows:(d + 1) * rows, ..., m * v:(m + 1) * v]


@pytest.mark.parametrize("case", CASES)
def test_flags_change_nothing_in_one_process(runs, case):
    plain = runs["one"][case, "plain"]
    for flag in ("sequence_parallel", "shard_grads"):
        got = runs["one"][case, flag]
        for k in plain:
            assert torch.equal(got[k], plain[k]), (flag, k)


@pytest.mark.parametrize("name,case", RUNS)
def test_sequence_parallel_step_matches_one_process(runs, name, case):
    """Every rank's loss and gathered gradient, with and without sequence
    parallelism, against the reference's ``make_grad_fn`` and one process
    on the same params and batch, and the two layouts against each other."""
    want, ref = runs["one"][case, "plain"], runs["ref"][case]
    g = want["grad"].numpy()
    for r in runs["ranks"][name]:
        for sp in (True, False):
            np.testing.assert_allclose(float(r[f"{case}_{sp}_loss"]), want["loss"].item(),
                                       rtol=1e-6)
            np.testing.assert_allclose(float(r[f"{case}_{sp}_loss"]), ref["loss"], rtol=1e-6)
            assert np.abs(r[f"{case}_{sp}_grad"] - g).max() <= 1e-5 * np.abs(g).max()
            assert np.abs(r[f"{case}_{sp}_grad"] - ref["grad"]).max() <= \
                1e-5 * np.abs(ref["grad"]).max()
        np.testing.assert_allclose(float(r[f"{case}_True_loss"]), float(r[f"{case}_False_loss"]),
                                   rtol=1e-6)
        d = r[f"{case}_True_grad"] - r[f"{case}_False_grad"]
        assert np.abs(d).max() <= 1e-5 * np.abs(g).max()


@pytest.mark.parametrize("name,case", RUNS)
def test_sequence_parallel_serve_matches_one_process(runs, name, case):
    want, ref = runs["one"][case, "plain"], runs["ref"][case]
    for rank, r in enumerate(runs["ranks"][name]):
        for sp in (True, False):
            np.testing.assert_allclose(r[f"{case}_{sp}_prefill"],
                                       _mine(rank, name, want["prefill"].numpy()), rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(r[f"{case}_{sp}_prefill"],
                                       _mine(rank, name, ref["prefill"]), rtol=0, atol=1e-4)
        assert np.array_equal(r[f"{case}_True_tokens"], r[f"{case}_False_tokens"])
        (data, _), _ = LAYOUTS[name]
        rows = B // data
        d = rank // LAYOUTS[name][0][1]
        assert np.array_equal(r[f"{case}_True_tokens"],
                              want["tokens"].numpy()[d * rows:(d + 1) * rows])


@pytest.mark.parametrize("name,case", RUNS)
def test_sequence_parallel_bytes_equal_the_plan(runs, name, case):
    (data, model), _ = LAYOUTS[name]
    keys = sorted(COLLECTIVE_BYTES)
    for sp in (True, False):
        cfg = dataclasses.replace(sp_config(case), sequence_parallel=sp)
        with layout_of(name):
            mesh = make_mesh((data, model), ("data", "model"))
            train = port_collective_bytes(cfg, "train", B, S, mesh)["counted"]
            pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
            dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
        assert (train["sp_scatter"] > 0) == (sp and model > 1)
        for r in runs["ranks"][name]:
            step = json.loads(str(r[f"{case}_{sp}_bytes"]))
            served = json.loads(str(r[f"{case}_{sp}_serve_bytes"]))
            assert {k: step[k] for k in keys} == {k: train.get(k, 0) for k in keys}, sp
            assert {k: served[k] for k in keys} == \
                {k: pre.get(k, 0) + SP_GEN * dec.get(k, 0) for k in keys}, sp


@pytest.mark.parametrize("name", [n for n, ((d, _), _) in LAYOUTS.items() if d > 1])
def test_shard_grads_changes_nothing(runs, name):
    """The gradient already comes out in each weight's storage layout (the
    FSDP gather's reduce-scatter, the replicated leaves' all-reduce): the
    reference's ``_constrain_grads`` pin has nothing to move."""
    for r in runs["ranks"][name]:
        assert json.loads(str(r["dense_shard_grads_differ"])) == []
