"""The reference's FSDP storage over ``data`` in the port: each rank stores
its block of every weight over ``data`` and ``model`` (the reference's
``param_spec_for``), gathers a layer's weights over ``data`` just before the
layer runs and reduce-scatters their gradient; ``SPEC_OPTIONS
["replicate_params_over_data"]`` gives back the replicated layout.

The specs are held to the reference's leaf by leaf for all ten archs.  The
runs are gloo processes on the CPU (``_WORKER``, one subprocess spawning the
ranks of each layout in turn: data 2 x model 2, data 2 x model 1, then data
1 x model 2), on ``tests/torch_tp_common.py``'s reduced configs at d_model
64, the reference's params carried over as numpy and the reference's own
uniforms handed in.  Gates, each with its reason:

* the reduced stablelm's 4 fused async ticks at 2 x 1 and 2 x 2: the
  gathered params within 1e-5 of one process's and of the reference's
  ``run`` (the cross-rank sums change the order of the sums), losses
  within 1e-6 relative, taus, tables, CDFs and histograms bitwise equal to
  one process's;
* at data 2 the FSDP run and the replicated one bitwise equal (params,
  momentum, ring, losses): with two data ranks every gradient element is
  ``a + b`` in both;
* at data 2, sync and async, fused and unfused, bitwise equal (the port's
  fused and link-by-link paths are, in one process);
* the nine other archs at data 2: loss within 1e-6 relative and the
  gathered gradient within 1e-5 of max |g| of one process's (the mean over
  the data shards of one process's, for the MoE, whose ranks route their
  own rows), the greedy ids of a 4-step serve and the MoE's routes equal to
  one process serving each rank's rows;
* the clip link at data 2 x model 1: the squared norm of the rank's blocks
  summed over ``data`` within 1e-6 relative of one process's, and the
  clipped run within 1e-5;
* ``COLLECTIVE_BYTES`` equal to ``launch.analysis.port_collective_bytes``
  and a rank's state bytes equal to ``plan_run``'s, exactly;
* a 2 x 2 FSDP checkpoint is the one-process checkpoint and restores bit
  for bit to ``localize`` of its leaves at 2 x 2, 2 x 1, 1 x 2 and in one
  process; a one-process checkpoint restores into 2 x 2 FSDP the same.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro.run.hooks import Hook as JHook
from repro.sharding import specs as JS
from repro.training import default_adapt_setup as j_adapt_setup
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.run import CheckpointHook, run
from repro_torch.sharding import specs as TS
from repro_torch.training import init_params
from repro_torch.training.steps import param_template
from torch_tp_common import (
    FSDP_GEN,
    B,
    S,
    SAVE_AT,
    TICKS,
    Tables,
    async_spec,
    blocks_differ,
    ckpt_spec,
    clip_spec,
    config,
    fsdp_arch_config,
    mode_spec,
    restored,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"2x2": (2, 2), "2x1": (2, 1), "1x2": (1, 2)}  # spawned in this order
OTHER_ARCHS = tuple(a for a in ASSIGNED_ARCHS if a != "stablelm-1.6b")


_WORKER = textwrap.dedent('''
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, run
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, leaf_paths, localize
    from repro_torch.training.steps import _template, param_template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import (  # noqa: E402
        FSDP_GEN, SAVE_AT, Tables, async_spec, blocks_differ, ckpt_spec, clip_spec, config,
        digest, fsdp_arch_config, mode_spec, restored, state_bits)

    OTHER_ARCHS = sys.argv[3].split(",")


    def grads(cfg, local, batch, mesh):
        """Loss, the rank's gradient blocks and the bytes counted."""
        C.reset_collective_bytes()
        leaf = local.clone().requires_grad_()
        loss, _ = M.loss_fn(T.flat_view(leaf, _template(cfg, mesh)), C.local_rows(batch, mesh),
                            cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        C.sum_grads_over_data(g, mesh, cfg)
        return loss.detach(), g, dict(C.COLLECTIVE_BYTES)


    def served(cfg, local, batch, mesh):
        """A GEN-step serve of the rank's rows: ids, the MoE's routes, bytes."""
        routes, inner = [], MOE.route

        def keep(*a, **k):
            out = inner(*a, **k)
            routes.append(out[2].clone())
            return out

        MOE.route = keep
        C.reset_collective_bytes()
        try:
            with torch.no_grad():
                res = serve(cfg, T.flat_view(local, _template(cfg, mesh)), batch, gen=FSDP_GEN)
        finally:
            MOE.route = inner
        return res, routes, dict(C.COLLECTIVE_BYTES)


    def cut(t, cfg, mesh):
        """The FSDP blocks of a flat tensor (..., N) over the whole params."""
        rows = [T.pack_flat(localize(T.flat_view(r, param_template(cfg)), cfg, mesh))
                for r in t.reshape(-1, t.shape[-1])]
        return torch.stack(rows).reshape(tuple(t.shape[:-1]) + (-1,))


    def fsdp_run(cfg, local, draws, mesh, out, tag):
        hook = Tables()
        C.reset_collective_bytes()
        state = run(async_spec(cfg, local, draws), hooks=[hook]).state
        out[f"{tag}_bytes"] = json.dumps(C.COLLECTIVE_BYTES)
        out.update({f"{tag}_{k}": v for k, v in hook.arrays().items()})
        out[f"{tag}_state_bytes"] = sum(t.numel() * t.element_size()
                                        for _, t in leaf_paths(state)
                                        if isinstance(t, torch.Tensor))
        return state


    def worker(rank, world, data, model, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{data}x{model}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        tag = f"{data}x{model}"
        out = {"data": mesh.index("data"), "model": mesh.index("model")}
        cfg = config("mha")
        tree = dict(np.load(f"{tmp}/params_stablelm-1.6b.npz"))
        batch = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/batch.npz").items()}
        draws = np.load(f"{tmp}/draws.npy")
        with use_sharding_rules(mesh):
            local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
            ckpt = f"{tmp}/ck_2x2"
            if tag == "1x2":
                out["ck_2x2_differ"] = blocks_differ(
                    ckpt, restored(ckpt_spec("momentum", cfg, local, draws, SAVE_AT), ckpt),
                    cfg, mesh)
            else:
                state = fsdp_run(cfg, local, draws, mesh, out, "async")
                out["async_params"] = bridge.gather_params(state.params, cfg, mesh).numpy()
                out["async_local"] = json.dumps(
                    [digest(t) for t in (state.params, state.opt_state["bufs"],
                                           state.delayed.ring)])
                loss, g, counted = grads(cfg, local, batch, mesh)
                out["grad_bytes"] = json.dumps(counted)
                res, _, counted = served(cfg, local, batch, mesh)
                out["serve_bytes"] = json.dumps(counted)
            if tag == "2x2":
                spec = ckpt_spec("momentum", cfg, local, draws, 0, num_steps=SAVE_AT)
                state = run(spec, hooks=[CheckpointHook(ckpt, every=SAVE_AT)]).state
                again = restored(spec, ckpt)
                out["ck_2x2_same"] = [k for k, v in state_bits(again).items()
                                      if not np.array_equal(v, state_bits(state)[k])]
                out["ck_2x2_differ"] = blocks_differ(ckpt, again, cfg, mesh)
                one = f"{tmp}/ck_one"
                out["ck_one_differ"] = blocks_differ(
                    one, restored(ckpt_spec("momentum", cfg, local, draws, SAVE_AT), one),
                    cfg, mesh)
            if tag == "2x1":
                out["ck_2x2_differ"] = blocks_differ(
                    ckpt, restored(ckpt_spec("momentum", cfg, local, draws, SAVE_AT), ckpt),
                    cfg, mesh)
                out["loss"], out["grad"] = loss.numpy(), bridge.gather_params(g, cfg, mesh).numpy()
                with torch.no_grad():
                    out["sq_norm"] = C.make_sq_norm(cfg, mesh)(g).numpy()
                out["clip_params"] = bridge.gather_params(
                    run(clip_spec(cfg, local)).state.params, cfg, mesh).numpy()
                for mode in ("sync", "async"):
                    for fuse in (True, False):
                        spec = mode_spec(mode, fuse, cfg, local, draws)
                        p = run(spec).state.params
                        p = p if fuse else T.pack_flat(p)
                        out[f"{mode}_{fuse}"] = bridge.gather_params(p, cfg, mesh).numpy()
                for arch in OTHER_ARCHS:
                    acfg = fsdp_arch_config(arch)
                    atree = dict(np.load(f"{tmp}/params_{arch}.npz"))
                    abatch = {k: torch.from_numpy(v)
                              for k, v in np.load(f"{tmp}/batch_{arch}.npz").items()}
                    alocal, _ = bridge.params_from_jax(atree, acfg, mesh=mesh)
                    aloss, ag, _ = grads(acfg, alocal, abatch, mesh)
                    out[f"{arch}_loss"] = aloss.numpy()
                    out[f"{arch}_grad"] = bridge.gather_params(ag, acfg, mesh).numpy()
                    res, routes, _ = served(acfg, alocal, abatch, mesh)
                    out[f"{arch}_ids"] = res["tokens"].numpy()
                    if routes:
                        out[f"{arch}_routes"] = routes[0].numpy()
                # the replicated layout: the same run, cut to the FSDP blocks
                SPEC_OPTIONS["replicate_params_over_data"] = True
                try:
                    whole, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
                    state = fsdp_run(cfg, whole, draws, mesh, out, "repl")
                finally:
                    SPEC_OPTIONS["replicate_params_over_data"] = False
                out["repl_n_local"] = state.params.numel()
                out["repl_local"] = json.dumps(
                    [digest(cut(t, cfg, mesh)) for t in (state.params, state.opt_state["bufs"],
                                                            state.delayed.ring)])
        out = {k: np.array(v, dtype=str) if isinstance(v, list) else v for k, v in out.items()}
        np.savez(f"{tmp}/rank_{tag}_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model in ((2, 2), (2, 1), (1, 2)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp),
                                        nprocs=data * model, join=True)
        print("OK fsdp")
''')


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _JRec(JHook):
    def __init__(self):
        self.losses = []

    def on_tick(self, ctx):
        self.losses.append(float(ctx.metrics["loss"]))


def _reference_run(tmp):
    """The reference's params (saved for the ranks), its 4 fused async ticks
    of ``async_spec``'s configuration and the uniforms it drew."""
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    tree = {k: np.asarray(v) for k, v in zip(keys, leaves)}
    np.savez(tmp / "params_stablelm-1.6b.npz", **tree)
    lr, w = 0.05, 4
    sched, _, adapt = j_adapt_setup(lr, w, w)
    pipe = JT.chain(JT.scale_by_staleness(sched, lr, m=w, tau_max=adapt.tau_max), JT.scale(-lr),
                    JT.trace(0.9))
    rec = _JRec()
    result = j_run(JSpec(cfg=jcfg, pipeline=pipe, mode="async", num_steps=TICKS, batch_size=B,
                         seq_len=S, num_workers=w, ring=w, adapt=adapt, fuse=True,
                         refresh_every=2, params=params, seed=0), hooks=[rec])
    # the reference's draws: split(PRNGKey(seed))[1], then per tick split and uniform
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    draws = []
    for _ in range(TICKS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (w,))))
    return tree, np.asarray(result.state.params), np.array(rec.losses), np.stack(draws)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, one process's results, and every rank's of the
    three layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("fsdp")
    tree, jparams, jlosses, draws = _reference_run(tmp)
    np.save(tmp / "draws.npy", draws)
    cfg = config("mha")
    batch = _batch(cfg)
    np.savez(tmp / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    flat, _ = bridge.params_from_jax(tree, cfg)
    want = dict(jparams=jparams, jlosses=jlosses)
    hook = Tables()
    want["async"] = dict(params=run(async_spec(cfg, flat, draws), hooks=[hook]).state.params
                         .numpy(), **hook.arrays())
    want["clip"] = run(clip_spec(cfg, flat)).state.params.numpy()
    leaf = flat.clone().requires_grad_()
    loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), batch, cfg)
    (g,) = torch.autograd.grad(loss, leaf)
    want["sq"] = float(torch.sum(torch.square(g)))
    for mode in ("sync", "async"):
        want[f"{mode}_2"] = run(mode_spec(mode, True, cfg, flat, draws)).state.params.numpy()
    # a one-process checkpoint at step SAVE_AT, for the ranks to restore
    run(ckpt_spec("momentum", cfg, flat, draws, 0, num_steps=SAVE_AT),
        hooks=[CheckpointHook(str(tmp / "ck_one"), every=SAVE_AT)])
    for arch in OTHER_ARCHS:
        want[arch] = _one_process_arch(arch, tmp)

    script = tmp / "fsdp_worker.py"
    script.write_text(_WORKER)
    tests = os.path.join(ROOT, "tests")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), tests]))
    proc = subprocess.run([sys.executable, str(script), str(tmp), tests, ",".join(OTHER_ARCHS)],
                          env=env,
                          cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK fsdp" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{d}x{m}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    spec = ckpt_spec("momentum", cfg, flat, draws, SAVE_AT)
    one = make_mesh((1, 1), ("data", "model"))
    want["ck_2x2_one_differ"] = blocks_differ(tmp / "ck_2x2", restored(spec, str(tmp / "ck_2x2")),
                                              cfg, one)
    return dict(want=want, ranks=ranks)


def _batch(cfg):
    return make_batch_for(cfg, batch=B, seq=S, seed=0)


def _one_process_arch(arch, tmp):
    """One process: ``arch``'s loss and gradient (the MoE's: the mean over
    the two data shards'), and its GEN-step serve of each shard's rows, with
    the MoE's routes.  The params are the port's ``init_params(0)``."""
    from repro_torch.models import moe as MOE

    cfg = fsdp_arch_config(arch)
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    np.savez(tmp / f"params_{arch}.npz", **bridge.params_to_numpy(flat, cfg))
    batch = _batch(cfg)
    np.savez(tmp / f"batch_{arch}.npz", **{k: v.numpy() for k, v in batch.items()})
    rows = B // 2
    shards = [{k: v[d * rows:(d + 1) * rows] for k, v in batch.items()} for d in range(2)]
    parts = [batch] if not cfg.num_experts else shards
    assert len({int((s["labels"] >= 0).sum()) for s in parts}) == 1
    losses, grads = [], []
    for part in parts:
        leaf = flat.clone().requires_grad_()
        loss, _ = M.loss_fn(T.flat_view(leaf, param_template(cfg)), part, cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        losses.append(loss.item())
        grads.append(g.numpy())
    out = dict(loss=np.mean(losses), grad=np.mean(grads, axis=0), ids=[], routes=[])
    for shard in shards:
        routes, inner = [], MOE.route

        def keep(*a, **k):
            got = inner(*a, **k)
            routes.append(got[2].clone())
            return got

        MOE.route = keep
        try:
            with torch.no_grad():
                res = serve(cfg, T.flat_view(flat, param_template(cfg)), shard, gen=FSDP_GEN)
        finally:
            MOE.route = inner
        out["ids"].append(res["tokens"].numpy())
        out["routes"].append(routes[0].numpy() if routes else None)
    return out


# ---------------------------------------------------------------------------
# The storage specs against the reference's param_spec_for
# ---------------------------------------------------------------------------

class FakeMesh:
    """The reference's duck-typed mesh (tests/test_sharding.py)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)
        self._shape = dict(zip(axes, shape))

    @property
    def shape(self):
        return self._shape


SPEC_LAYOUTS = {
    "2x1": ((2, 1), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuple entries as the bare axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.fixture
def replicate():
    """Set both packages' ``replicate_params_over_data`` together; restore
    them after."""
    old_j, old_t = dict(JS.SPEC_OPTIONS), dict(TS.SPEC_OPTIONS)

    def set_option(on):
        JS.SPEC_OPTIONS["replicate_params_over_data"] = on
        TS.SPEC_OPTIONS["replicate_params_over_data"] = on

    yield set_option
    JS.SPEC_OPTIONS.update(old_j)
    TS.SPEC_OPTIONS.update(old_t)


@pytest.mark.parametrize("repl", [False, True], ids=["fsdp", "replicated"])
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_storage_spec_is_the_reference_param_spec(arch, size, repl, replicate):
    """Leaf by leaf, on every layout: the one exception is the SSM's
    ``in_proj`` halves rule (``specs.block_view``), whose last dim splits
    over ``model`` where ``model`` divides each half."""
    replicate(repl)
    cfg = get_config(arch) if size == "full" else reduced(get_config(arch))
    tree = M.init_model(None, cfg, "meta")
    for shape, axes in SPEC_LAYOUTS.values():
        fake, mesh = FakeMesh(shape, axes), make_mesh(shape, axes)
        n_model = dict(zip(axes, shape))["model"]
        checked = 0
        for path, leaf in TS.leaf_paths(tree):
            dims = tuple(leaf.shape)
            want = _norm(JS.param_spec_for(path, dims, fake))
            got = _norm(TS.storage_spec_for(path, dims, mesh, cfg))
            if re.search(r"in_proj$", path):
                halves = "model" if (dims[-1] // 2) % n_model == 0 else None
                assert got[:-1] == want[:-1] and got[-1] == halves, (path, shape, got, want)
            else:
                assert got == want, (path, shape, got, want)
            checked += 1
        assert checked == len(TS.leaf_paths(tree))
        if repl:
            assert not any(e in ("data", ("pod", "data")) for _, leaf in TS.leaf_paths(tree)
                           for e in _norm(TS.storage_spec_for(_, tuple(leaf.shape), mesh, cfg)))


def test_gather_dim_is_the_data_split_dim(replicate):
    """The dim a rank gathers a leaf along is the one its spec splits over
    the batch axes (counted from the end, as a stacked leaf and its layers
    share it); none under the replicated layout."""
    cfg = get_config("stablelm-1.6b")
    mesh = make_mesh((2, 1), ("data", "model"))
    shapes = dict((p, tuple(t.shape)) for p, t in TS.leaf_paths(M.init_model(None, cfg, "meta")))
    assert TS.gather_dim("stack/pos0/attn/wq", shapes["stack/pos0/attn/wq"], mesh, cfg) == -3
    assert TS.gather_dim("stack/pos0/attn/wo", shapes["stack/pos0/attn/wo"], mesh, cfg) == -1
    assert TS.gather_dim("embed/embedding", shapes["embed/embedding"], mesh, cfg) == -1
    assert TS.gather_dim("final_norm/scale", shapes["final_norm/scale"], mesh, cfg) is None
    replicate(True)
    assert TS.gather_dim("stack/pos0/attn/wq", shapes["stack/pos0/attn/wq"], mesh, cfg) is None


# ---------------------------------------------------------------------------
# The runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["2x1", "2x2"])
def test_async_fused_run_matches_one_process_and_reference(runs, name):
    want = runs["want"]
    for r in runs["ranks"][name]:
        assert np.abs(r["async_params"] - want["async"]["params"]).max() <= 1e-5
        assert np.abs(r["async_params"] - want["jparams"]).max() <= 1e-5
        np.testing.assert_allclose(r["async_losses"], want["async"]["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["async_losses"], want["jlosses"], rtol=1e-6)
        for k in ("tables", "cdfs", "hists"):
            np.testing.assert_array_equal(r[f"async_{k}"], want["async"][k])
        np.testing.assert_array_equal(r["async_losses"], runs["ranks"][name][0]["async_losses"])


def test_fsdp_is_bitwise_the_replicated_layout_at_data_2(runs):
    for r in runs["ranks"]["2x1"]:
        assert str(r["async_local"]) == str(r["repl_local"])
        np.testing.assert_array_equal(r["async_losses"], r["repl_losses"])
        assert int(r["repl_n_local"]) == runs["want"]["async"]["params"].shape[0]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_fused_and_unfused_agree_at_data_2(runs, mode):
    for r in runs["ranks"]["2x1"]:
        np.testing.assert_array_equal(r[f"{mode}_True"], r[f"{mode}_False"])
        assert np.abs(r[f"{mode}_True"] - runs["want"][f"{mode}_2"]).max() <= 1e-5


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_match_one_process_at_data_2(runs, arch):
    want = runs["want"][arch]
    for r in runs["ranks"]["2x1"]:
        d = int(r["data"])
        np.testing.assert_allclose(float(r[f"{arch}_loss"]), want["loss"], rtol=1e-6)
        assert np.abs(r[f"{arch}_grad"] - want["grad"]).max() <= \
            1e-5 * np.abs(want["grad"]).max()
        np.testing.assert_array_equal(r[f"{arch}_ids"], want["ids"][d])
        if want["routes"][d] is not None:
            np.testing.assert_array_equal(r[f"{arch}_routes"], want["routes"][d])


def test_clip_norm_and_run_at_data_2_match_one_process(runs):
    for r in runs["ranks"]["2x1"]:
        np.testing.assert_allclose(float(r["sq_norm"]), runs["want"]["sq"], rtol=1e-6)
        assert np.abs(r["clip_params"] - runs["want"]["clip"]).max() <= 1e-5


@pytest.mark.parametrize("name", ["2x1", "2x2"])
def test_counted_bytes_equal_the_plan(runs, name):
    data, model = LAYOUTS[name]
    mesh = make_mesh((data, model), ("data", "model"))
    cfg = config("mha")
    train = port_collective_bytes(cfg, "train", B, S, mesh)["counted"]
    pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
    dec = port_collective_bytes(cfg, "decode", B, S, mesh)["counted"]
    run_want = {k: TICKS * v for k, v in train.items() if v}
    serve_want = {k: pre[k] + FSDP_GEN * dec[k] for k in pre if pre[k] + FSDP_GEN * dec[k]}
    assert train["fsdp_gather"] > 0 and train["fsdp_grad"] > 0 and pre["fsdp_gather"] > 0
    for r in runs["ranks"][name]:
        assert {k: v for k, v in json.loads(str(r["async_bytes"])).items() if v} == run_want
        assert {k: v for k, v in json.loads(str(r["grad_bytes"])).items() if v} == \
            {k: v for k, v in train.items() if v}
        assert {k: v for k, v in json.loads(str(r["serve_bytes"])).items() if v} == serve_want


@pytest.mark.parametrize("name", ["2x1", "2x2"])
def test_rank_state_bytes_equal_the_plan(runs, name):
    from repro_torch.launch.dryrun import plan_run

    data, model = LAYOUTS[name]
    spec = async_spec(config("mha"), None, np.zeros((TICKS, 4), np.float32))
    planned = plan_run(spec, mesh=make_mesh((data, model), ("data", "model")))
    whole = plan_run(spec)["memory"]["argument_bytes"]
    for r in runs["ranks"][name]:
        assert int(r["async_state_bytes"]) == planned["memory"]["argument_bytes"] < whole


@pytest.mark.parametrize("restore", ["2x2", "2x1", "1x2", "one"])
def test_a_2x2_checkpoint_restores_bitwise_at_every_layout(runs, restore):
    if restore == "one":
        assert runs["want"]["ck_2x2_one_differ"] == []
        return
    for r in runs["ranks"][restore]:
        assert r["ck_2x2_differ"].tolist() == []
        if restore == "2x2":
            assert r["ck_2x2_same"].tolist() == []


def test_a_one_process_checkpoint_restores_into_2x2(runs):
    for r in runs["ranks"]["2x2"]:
        assert r["ck_one_differ"].tolist() == []


def test_the_planner_plans_fsdp_and_with_repl_params_the_replicated_layout(tmp_path):
    """``launch.dryrun --small_mesh`` plans the FSDP storage (a rank's params
    about half a model-2 rank's, the weights gathered once a decode step);
    ``--repl_params`` (the reference's flag) every weight whole over data,
    and leaves the layout option as it found it."""
    from repro_torch.launch import dryrun as D

    args = ["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--small_mesh",
            "--out", str(tmp_path)]
    assert D.main(args) == 0
    assert D.main(args + ["--repl_params"]) == 0
    assert TS.SPEC_OPTIONS["replicate_params_over_data"] is False
    fsdp = json.load(open(tmp_path / "stablelm-1_6b_decode_32k_small.json"))
    repl = json.load(open(tmp_path / "stablelm-1_6b_decode_32k_small_repl.json"))
    assert "FSDP" in fsdp["layout"] and repl["layout"].endswith("every weight whole over data")
    assert fsdp["collectives"]["counted"]["fsdp_gather"] > 0
    assert repl["collectives"]["counted"]["fsdp_gather"] == 0
    assert fsdp["collectives"]["all-gather"] > 0 == repl["collectives"]["all-gather"]
    assert fsdp["memory"]["argument_bytes"] < repl["memory"]["argument_bytes"]
