"""Checkpoint and resume of multi-process training states: tensor- and
data-parallel ranks (``use_sharding_rules(mesh)`` over a running
``make_mesh`` layout) and the sharded engine's worker-parallel ranks
(``mode="sharded_async"`` over ``make_workers_mesh(2)``), run as gloo
processes on the CPU.  Each save writes ONE checkpoint, the one a single
process writes for the same config; each rank restores its own part of it.

The configs are ``tests/torch_tp_common.py``'s: reduced stablelm-1.6b at
d_model 64 (and the four other families of ``ARCH_UPDATES``), params from
the port's ``init_params(0)``, batches from numpy, the workers' uniforms
handed in.  One subprocess spawns the ranks of each layout in turn
(``_WORKER``): data 2 x model 2 first (its checkpoint is restored at 1 x 2
and in one process), then 1 x 2, 1 x 4, data 2 x model 2 again with every
weight whole over ``data`` (``2x2-repl``: ``replicate_params_over_data``;
the first 2 x 2 runs the reference's FSDP storage over ``data``) and the
2-process sharded engine.

Gates, each exact unless it says otherwise:
* same-layout resume at 1 x 2, 1 x 4 and 2 x 2, for the fused momentum run
  of ``async_spec`` (saved at step 3 with a partial histogram, resumed
  across the step-4 refresh), fused adam and unfused momentum: every
  rank's losses and every leaf bit for bit those of the run that was not
  interrupted; the four other families at 1 x 2 the same;
* the file: its keys, shapes and stored dtypes those of a one-process save
  of the same config; each rank's blocks of its leaves (``local_shard``)
  bit for bit the rank's state at the save;
* across layouts (a 2 x 2 save restored at 1 x 2 and in one process, a
  one-process save restored at 1 x 2): each rank's restored state bit for
  bit its blocks of the whole; after 3 more ticks with the same uniforms
  the gathered params within 1e-5 of one process's (the bound of the
  tensor-parallel tests: the cross-rank sums change the order of the sums);
* across packages: the reference's ``load_train_state`` reads the
  checkpoint into its one-process template, every leaf but ``.rng`` (a
  torch generator's state, not a jax key) bit for bit the file's;
* the sharded engine at W 4 x K 8 over 2 processes, fused and unfused: a
  ``(4, 8, N)`` ring on disk, a 2-process resume bitwise on both ranks, a
  one-process restore that continues within rtol 1e-6, atol 1e-7 of the
  2-process run (``test_two_gloo_processes_match_one``'s bound) with the
  same merged histogram;
* bits, not sums: ``-0.0`` and a NaN's payload in a rank's block reach
  the file as they are; a save and a restore count nothing in
  ``COLLECTIVE_BYTES``;
* errors: a config of another width raises naming the leaf, generators
  that differ across ranks make the save raise naming ``.rng``, and a save
  that dies midway leaves ``latest`` at the previous checkpoint, which
  resumes bitwise.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.checkpoint.store import load_train_state as j_load_train_state
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run.engine import make_engine as j_make_engine
from repro.training import adapt as JA
from repro_torch import bridge
from repro_torch.launch.mesh import make_mesh, make_workers_mesh
from repro_torch.optim import transform as T
from repro_torch.run import CheckpointHook, run
from repro_torch.training import init_params
from repro_torch.training.steps import param_template
from repro_torch.tree import keystr, tree_paths
from torch_tp_common import (
    ARCHS,
    MORE,
    SAVE_AT,
    TICKS,
    VARIANTS,
    arch_config,
    blocks_of,
    ckpt_spec,
    config,
    file_leaves,
    layout_of,
    np_bits,
    restored,
    sharded_spec,
    state_bits,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4), "2x2-repl": (2, 2)}  # spawned in order
CROSS = ("2x2_to_1x2", "one_to_1x2", "2x2_to_one")

_WORKER = textwrap.dedent('''
    import dataclasses
    import json
    import os
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.mesh import make_mesh, make_workers_mesh
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, Hook, run
    from repro_torch.run import ckpt as CK
    from repro_torch.run.engine import make_engine
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS
    from repro_torch.training import merge_worker_hist

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import (  # noqa: E402
        ARCHS, MORE, SAVE_AT, TICKS, VARIANTS, arch_ckpt_spec, arch_config, blocks_differ,
        ckpt_spec, config, differ, restored, sharded_spec, state_bits)


    class Record(Hook):
        """Losses, and the state's bits at the save step."""

        def __init__(self, at=None):
            self.losses, self.at, self.saved = [], at, {}

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())
            if ctx.step == self.at:
                self.saved = state_bits(ctx.state)


    def resume_case(out, tag, make, directory):
        """Run A, saving at SAVE_AT, then B resumed from it: losses, the
        leaves that differ, the state at the save (beside the checkpoint)."""
        rec_a = Record(SAVE_AT)
        res_a = run(make(0), hooks=[rec_a, CheckpointHook(directory, every=SAVE_AT)])
        rec_b = Record()
        res_b = run(make(SAVE_AT), hooks=[rec_b], resume_from=directory, resume_step=SAVE_AT)
        out[f"{tag}_losses_a"] = np.array(rec_a.losses)
        out[f"{tag}_losses_b"] = np.array(rec_b.losses)
        out[f"{tag}_differ"] = json.dumps(differ(res_a.state, res_b.state))
        np.savez(f"{directory}/rank_{dist.get_rank()}_at_save.npz", **rec_a.saved)
        return res_a


    def tp_worker(rank, world, data, model, tmp, repl):
        torch.set_num_threads(1)
        SPEC_OPTIONS["replicate_params_over_data"] = repl
        name = f"{data}x{model}" + ("-repl" if repl else "")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{name}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        out = {}
        draws = np.load(f"{tmp}/draws.npy")
        with use_sharding_rules(mesh):
            cfg = config("mha")
            local = bridge.params_from_jax(dict(np.load(f"{tmp}/params.npz")), cfg, mesh=mesh)[0]
            for variant in VARIANTS:
                resume_case(out, variant,
                            lambda start: ckpt_spec(variant, cfg, local, draws, start),
                            f"{tmp}/ck_{name}_{variant}")
            if name == "1x2":
                for src in ("2x2", "one"):
                    directory = f"{tmp}/ck_{src}_momentum"
                    spec = ckpt_spec("momentum", cfg, local, draws, SAVE_AT, SAVE_AT + MORE)
                    out[f"cross_{src}_differ"] = json.dumps(
                        blocks_differ(directory, restored(spec, directory), cfg, mesh))
                    state = run(spec, resume_from=directory, resume_step=SAVE_AT).state
                    out[f"cross_{src}_params"] = bridge.gather_params(state.params, cfg,
                                                                      mesh).numpy()
                for arch in ARCHS:
                    acfg = arch_config(arch)
                    tree = dict(np.load(f"{tmp}/params_{arch}.npz"))
                    params = bridge.params_from_jax(tree, acfg, mesh=mesh)[0]
                    resume_case(out, arch, lambda start: arch_ckpt_spec(acfg, params, draws, start),
                                f"{tmp}/ck_{name}_{arch}")
                errors(out, cfg, local, draws, tmp)
        np.savez(f"{tmp}/rank_{name}_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    def errors(out, cfg, local, draws, tmp):
        """A config of another width, generators that differ across ranks,
        a save that dies midway."""
        wide = dataclasses.replace(cfg, d_ff=2 * cfg.d_ff)
        try:
            run(ckpt_spec("momentum", wide, None, draws, SAVE_AT),
                resume_from=f"{tmp}/ck_1x2_momentum", resume_step=SAVE_AT)
        except ValueError as e:
            out["width_error"] = str(e)
        directory = f"{tmp}/ck_crash"
        spec = ckpt_spec("momentum", cfg, local, draws, 0)
        res = run(spec, hooks=[CheckpointHook(directory, every=SAVE_AT)])
        layout = make_engine(spec).checkpoint_layout()
        state = dataclasses.replace(res.state, rng=torch.Generator().set_state(
            res.state.rng.get_state()))
        if dist.get_rank() == 1:
            torch.rand(1, generator=state.rng)
        try:
            CK.save_checkpoint(f"{tmp}/ck_rng", state, spec.pipeline, TICKS, layout=layout)
        except ValueError as e:
            out["rng_error"] = str(e)
        out["rng_wrote"] = os.path.exists(f"{tmp}/ck_rng/latest")
        # bits, not sums: -0.0 and a NaN's payload reach the file from every rank
        odd = torch.tensor([-0.0, 0.0, 1.0]).repeat(3)
        odd[1::3] = torch.tensor([0x7FC00123], dtype=torch.int32).view(torch.float32)
        params = res.state.params.clone()
        params[:9] = odd
        C.reset_collective_bytes()
        CK.save_checkpoint(f"{tmp}/ck_bits", dataclasses.replace(res.state, params=params),
                           spec.pipeline, TICKS, layout=layout)
        restored(ckpt_spec("momentum", cfg, local, draws, 0), f"{tmp}/ck_bits", step=TICKS)
        out["ckpt_counted"] = sum(C.COLLECTIVE_BYTES.values())
        out["odd_params"] = params.view(torch.int32).numpy()
        # a save at step 4 dies after the params and the optimizer state
        real = CK._leaf_stream

        def dying(layout, key, *rest):
            if key.startswith(".delayed"):
                raise RuntimeError("simulated crash mid-save")
            return real(layout, key, *rest)

        CK._leaf_stream = dying
        try:
            CK.save_checkpoint(directory, res.state, spec.pipeline, TICKS, layout=layout)
        except RuntimeError as e:
            out["crash_error"] = str(e)
        finally:
            CK._leaf_stream = real
        out["crash_latest"] = latest_step(directory)
        out["crash_left"] = json.dumps(sorted(os.listdir(directory)))
        resumed = run(ckpt_spec("momentum", cfg, local, draws, SAVE_AT), resume_from=directory)
        out["crash_differ"] = json.dumps(differ(res.state, resumed.state))


    def sharded_worker(rank, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_sharded", rank=rank,
                                world_size=world)
        mesh = make_workers_mesh(2, device="cpu")
        out = {}
        for fuse in (True, False):
            res = resume_case(out, f"sharded_{fuse}", lambda start: sharded_spec(mesh, fuse),
                              f"{tmp}/ck_sharded_{fuse}")
            p = res.state.params
            out[f"sharded_{fuse}_params"] = (p if isinstance(p, torch.Tensor) else
                                             T.pack_flat(p)).numpy()
            out[f"sharded_{fuse}_hist"] = merge_worker_hist(res.state.adapt, mesh.group).numpy()
        # a save of a rank's state without its layout would write the same files from each rank
        try:
            CK.save_checkpoint(f"{tmp}/ck_sharded_no_layout", res.state,
                               sharded_spec(mesh, False).pipeline, 6)
        except ValueError as e:
            out["no_layout_error"] = str(e)
        out["no_layout_wrote"] = os.path.exists(f"{tmp}/ck_sharded_no_layout")
        np.savez(f"{tmp}/rank_sharded_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, repl in ((2, 2, False), (1, 2, False), (1, 4, False), (2, 2, True)):
            torch.multiprocessing.spawn(tp_worker, args=(data * model, data, model, tmp, repl),
                                        nprocs=data * model, join=True)
        torch.multiprocessing.spawn(sharded_worker, args=(2, tmp), nprocs=2, join=True)
        print("OK tp checkpoint")
''')


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _flat(p):
    return p if isinstance(p, torch.Tensor) else T.pack_flat(p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's checkpoints and continued run, every layout's ranks
    (one subprocess), then one process restoring the 2 x 2 and the sharded
    engine's checkpoints."""
    tmp = tmp_path_factory.mktemp("tp_checkpoint")
    cfg = config("mha")
    params = T.pack_flat(init_params(0, cfg, "cpu"))
    np.savez(tmp / "params.npz", **bridge.params_to_numpy(params, cfg))
    for arch in ARCHS:
        acfg = arch_config(arch)
        np.savez(tmp / f"params_{arch}.npz",
                 **bridge.params_to_numpy(init_params(0, acfg, "cpu"), acfg))
    draws = np.random.default_rng(0).random((SAVE_AT + MORE, 4)).astype(np.float32)
    np.save(tmp / "draws.npy", draws)
    for variant in VARIANTS:
        run(ckpt_spec(variant, cfg, params, draws, 0),
            hooks=[CheckpointHook(str(tmp / f"ck_one_{variant}"), every=SAVE_AT)])

    def more():
        return ckpt_spec("momentum", cfg, params, draws, SAVE_AT, SAVE_AT + MORE)

    one = {"params": run(more(), resume_from=str(tmp / "ck_one_momentum")).state.params.numpy()}

    script = tmp / "tp_checkpoint_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), os.path.join(ROOT, "tests")],
                          env=env, cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK tp checkpoint" in proc.stdout
    ranks = {name: [dict(np.load(tmp / f"rank_{name}_{r}.npz")) for r in range(d * m)]
             for name, (d, m) in LAYOUTS.items()}
    ranks["sharded"] = [dict(np.load(tmp / f"rank_sharded_{r}.npz")) for r in range(2)]

    _, whole = file_leaves(tmp / "ck_2x2_momentum")
    held = state_bits(restored(more(), str(tmp / "ck_2x2_momentum")))
    one["2x2_to_one_differ"] = [k for k, v in held.items()
                                if not np.array_equal(np_bits(whole[k]), v)]
    one["2x2_to_one_params"] = run(more(), resume_from=str(tmp / "ck_2x2_momentum"),
                                   resume_step=SAVE_AT).state.params.numpy()
    for fuse in (True, False):
        res = run(sharded_spec(make_workers_mesh(device="cpu"), fuse),
                  resume_from=str(tmp / f"ck_sharded_{fuse}"), resume_step=SAVE_AT)
        one[f"sharded_{fuse}_params"] = _flat(res.state.params).numpy()
        one[f"sharded_{fuse}_hist"] = res.state.adapt.hist.sum(0).numpy()
    return dict(tmp=tmp, ranks=ranks, one=one, cfg=cfg)


def _cases():
    return [(name, variant) for name in LAYOUTS for variant in VARIANTS]


@pytest.mark.parametrize("name,variant", _cases())
def test_same_layout_resume_is_bitwise(runs, name, variant):
    for r in runs["ranks"][name]:
        assert len(r[f"{variant}_losses_a"]) == TICKS
        np.testing.assert_array_equal(r[f"{variant}_losses_b"], r[f"{variant}_losses_a"][SAVE_AT:])
        assert json.loads(str(r[f"{variant}_differ"])) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_other_families_resume_bitwise_at_1x2(runs, arch):
    for r in runs["ranks"]["1x2"]:
        np.testing.assert_array_equal(r[f"{arch}_losses_b"], r[f"{arch}_losses_a"][SAVE_AT:])
        assert json.loads(str(r[f"{arch}_differ"])) == []
    acfg = arch_config(arch)
    _, leaves = file_leaves(runs["tmp"] / f"ck_1x2_{arch}")
    n = sum(int(np.prod(s)) for _, (s, _) in tree_paths(param_template(acfg)))
    assert leaves[".params"].shape == (n,) and leaves[".delayed.ring"].shape == (4, n)
    mesh = make_mesh((1, 2), ("data", "model"))
    for r in range(2):
        at_save = dict(np.load(runs["tmp"] / f"ck_1x2_{arch}" / f"rank_{r}_at_save.npz"))
        for k, v in at_save.items():
            np.testing.assert_array_equal(blocks_of(k, leaves[k], v.shape, acfg, mesh.at(r)), v,
                                          err_msg=k)


@pytest.mark.parametrize("name,variant", _cases())
def test_the_file_is_the_one_process_checkpoint(runs, name, variant):
    """Keys, shapes and stored dtypes those of one process's save; each
    rank's blocks of the leaves its state at the save, bit for bit."""
    tmp = runs["tmp"]
    want_manifest, want = file_leaves(tmp / f"ck_one_{variant}")
    manifest, got = file_leaves(tmp / f"ck_{name}_{variant}")
    assert manifest == want_manifest
    assert [(k, v.shape, v.dtype) for k, v in got.items()] == \
        [(k, v.shape, v.dtype) for k, v in want.items()]
    data, model = LAYOUTS[name]
    mesh = make_mesh((data, model), ("data", "model"))
    for r in range(data * model):
        at_save = dict(np.load(tmp / f"ck_{name}_{variant}" / f"rank_{r}_at_save.npz"))
        assert list(at_save) == list(got)
        with layout_of(name):
            for k, v in at_save.items():
                np.testing.assert_array_equal(
                    blocks_of(k, got[k], v.shape, runs["cfg"], mesh.at(r)), v, err_msg=k)


@pytest.mark.parametrize("case", CROSS)
def test_restore_across_layouts(runs, case):
    """Each rank's restored state is its blocks of the whole, bit for bit;
    3 more ticks land within 1e-5 of one process's."""
    if case == "2x2_to_one":
        assert runs["one"]["2x2_to_one_differ"] == []
        got = [runs["one"]["2x2_to_one_params"]]
    else:
        src = case.split("_to_")[0]
        ranks = runs["ranks"]["1x2"]
        assert all(json.loads(str(r[f"cross_{src}_differ"])) == [] for r in ranks)
        got = [r[f"cross_{src}_params"] for r in ranks]
    for params in got:
        assert np.abs(params - runs["one"]["params"]).max() <= 1e-5


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_reference_reads_the_checkpoint(runs, name):
    """The reference's ``load_train_state`` reads a multi-process
    checkpoint into its one-process template: every leaf but ``.rng``
    bit for bit the file's."""
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    sched, _, adapt = JA.default_adapt_setup(0.05, 4, 4)
    link = JT.scale_by_staleness(sched, 0.05, m=4, tau_max=adapt.tau_max)
    jspec = JSpec(cfg=jcfg, pipeline=JT.chain(link, JT.scale(-0.05), JT.trace(0.9)),
                  mode="async", num_steps=TICKS, num_workers=4, ring=4, adapt=adapt, fuse=True,
                  seed=0)
    # the template's .rng is a jax key, which a generator's state cannot fill
    template = dataclasses.replace(j_make_engine(jspec).build(), rng=object())
    state, step = j_load_train_state(str(runs["tmp"] / f"ck_{name}_momentum"), template)
    assert step == SAVE_AT
    _, leaves = file_leaves(runs["tmp"] / f"ck_{name}_momentum")
    keys, got, _ = _flatten_with_keys(state)
    assert keys == list(leaves)
    for k, leaf in zip(keys, got):
        if k != ".rng":
            np.testing.assert_array_equal(np_bits(np.asarray(leaf)), np_bits(leaves[k]),
                                          err_msg=k)


@pytest.mark.parametrize("fuse", [True, False])
def test_sharded_engine_saves_one_ring_and_resumes(runs, fuse):
    """The 2-process sharded engine: one ``(W, K, N)`` ring on disk, a
    resume bitwise on both ranks, a one-process restore that continues as
    the 2-process run did."""
    _, leaves = file_leaves(runs["tmp"] / f"ck_sharded_{fuse}")
    n = sum(int(np.prod(s)) for _, (s, _) in tree_paths(param_template(runs["cfg"])))
    rings = [v for k, v in leaves.items() if k.startswith(".delayed.ring")]
    if fuse:
        assert leaves[".delayed.ring"].shape == (4, 8, n)
    assert {v.shape[:2] for v in rings} == {(4, 8)}
    assert sum(int(np.prod(v.shape[2:])) for v in rings) == n
    assert leaves[".adapt.hist"].shape[0] == 4 and leaves[".adapt.hist"].sum() > 0
    ranks = runs["ranks"]["sharded"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"sharded_{fuse}_losses_b"],
                                      r[f"sharded_{fuse}_losses_a"][SAVE_AT:])
        assert json.loads(str(r[f"sharded_{fuse}_differ"])) == []
    np.testing.assert_allclose(runs["one"][f"sharded_{fuse}_params"],
                               ranks[0][f"sharded_{fuse}_params"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(runs["one"][f"sharded_{fuse}_hist"],
                                  ranks[0][f"sharded_{fuse}_hist"])


def test_a_multi_process_save_without_its_layout_raises(runs):
    """``save_checkpoint`` of a rank's state with no layout, on each rank
    of the 2-process sharded engine (a workers mesh, not a data x model
    one), raises before it writes anything."""
    for r in runs["ranks"]["sharded"]:
        assert "layout=engine.checkpoint_layout()" in str(r["no_layout_error"])
        assert not bool(r["no_layout_wrote"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_over_params_names_what_the_builders_make_over_the_params(variant):
    """The leaves the engine hands the tensor-parallel layout as over the
    params: the params, the optimizer state's buffers or mirrors of them
    and the ring; nothing else (not adam's count, the step or the tables)."""
    from repro_torch.checkpoint import key_paths
    from repro_torch.run.engine import make_engine
    from repro_torch.training.steps import over_params

    cfg = config("mha")
    draws = np.zeros((TICKS, 4), np.float32)
    state = make_engine(ckpt_spec(variant, cfg, None, draws, 0)).build_template()
    over = over_params(state)
    paths = [p for p, _ in tree_paths(param_template(cfg))]
    if variant == "unfused":
        opt = [k for k, _ in key_paths(state.opt_state, ".opt_state")]
        want = {**{".params" + keystr(p): (p, 0) for p in paths},
                **{k: (p, 0) for k, p in zip(opt, paths)},
                **{".delayed.ring" + keystr(p): (p, 1) for p in paths}}
        assert len(opt) == len(paths)
    else:
        bufs = ["['m']", "['v']"] if variant == "adam" else [""]
        want = {".params": (None, 0), ".delayed.ring": (None, 1),
                **{f".opt_state['bufs']{b}": (None, 0) for b in bufs}}
    assert over == want


def test_sharded_engine_ranks_write_their_own_rows(runs):
    """Each worker's ring rows and histogram row on disk are its rank's;
    a rank's histogram holds zeros in the rows of the other rank's workers
    (so the merged histogram counts every tau once)."""
    tmp = runs["tmp"]
    _, leaves = file_leaves(tmp / "ck_sharded_True")
    hist = leaves[".adapt.hist"]
    ring = np_bits(leaves[".delayed.ring"])
    for r in range(2):
        at_save = dict(np.load(tmp / "ck_sharded_True" / f"rank_{r}_at_save.npz"))
        mine = at_save[".adapt.hist"]
        np.testing.assert_array_equal(mine[2 * r:2 * r + 2], hist[2 * r:2 * r + 2])
        assert not np.delete(mine, [2 * r, 2 * r + 1], axis=0).any()
        np.testing.assert_array_equal(at_save[".delayed.ring"], ring[2 * r:2 * r + 2])


def test_a_config_mismatch_names_the_leaf(runs):
    for r in runs["ranks"]["1x2"]:
        assert "leaf .params: checkpoint shape" in str(r["width_error"])


def test_generators_that_differ_make_the_save_raise(runs):
    for r in runs["ranks"]["1x2"]:
        msg = str(r["rng_error"])
        assert "leaf .rng" in msg and "ranks [1]" in msg
        assert not bool(r["rng_wrote"])


def test_a_crash_mid_save_leaves_the_previous_checkpoint_resumable(runs):
    for r in runs["ranks"]["1x2"]:
        assert "simulated crash" in str(r["crash_error"])
        assert int(r["crash_latest"]) == SAVE_AT
        left = json.loads(str(r["crash_left"]))
        assert f"step_{TICKS:08d}.npz" not in left and f"step_{TICKS:08d}.npz.tmp" in left
        assert json.loads(str(r["crash_differ"])) == []


def test_the_save_moves_bits_not_sums(runs):
    """-0.0 and a NaN's payload in each rank's block reach the file as
    they are (a gather that summed into zeros would write +0.0)."""
    _, leaves = file_leaves(runs["tmp"] / "ck_bits", step=TICKS)
    mesh = make_mesh((1, 2), ("data", "model"))
    for r, rank in enumerate(runs["ranks"]["1x2"]):
        got = blocks_of(".params", leaves[".params"], rank["odd_params"].shape, runs["cfg"],
                        mesh.at(r))
        np.testing.assert_array_equal(got, rank["odd_params"])
        assert got[0] == np.int32(-2**31) and got[1] == 0x7FC00123


def test_the_checkpoint_collectives_are_not_counted(runs):
    """A save and a restore at 1 x 2 add nothing to ``COLLECTIVE_BYTES``,
    which holds the step's all-reduces to ``port_collective_bytes``."""
    for rank in runs["ranks"]["1x2"]:
        assert int(rank["ckpt_counted"]) == 0
