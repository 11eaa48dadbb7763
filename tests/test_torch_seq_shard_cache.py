"""Port parity, the reference's ``--seq_shard_cache`` decode layout
(``SPEC_OPTIONS["seq_shard_cache"]``), run as gloo processes on the CPU
against one process of the port and against the reference's serve.

Under the option the reference's ``cache_spec_for`` splits a ``k`` / ``v``
cache leaf's capacity: over ``model`` where its kv heads do not split over
``model`` (every kv head whole on every rank), else over ``data`` for a
batch of one row (its kv heads over ``model``), each only where the axes
divide the capacity.  A rank holds the slots ``[r C / n, (r + 1) C / n)``,
writes a token only where it holds its slot, and attends over its slots
with a partial softmax combined over those axes (a max of the row maximum,
then one sum of the row sums and weighted values); where the capacity is
split over ``model`` the query heads are gathered first and every one
attends under the whole GQA grouping.

The cases (``torch_tp_common.SSC_CASES``), each at d_model 64 in f32, its
params the reference's ``init_params`` carried over as numpy (the ranks
take their blocks with ``bridge.params_from_jax(..., mesh=...)``), served
by ``launch.serve.serve`` under ``use_sharding_rules`` with a running
layout, one spawn of its ranks per layout (``_WORKER``):

* reduced recurrentgemma-9b (one kv head) at data 1 x model 2 and 1 x 4,
  batch 2, prompt 80 past the window of 64 (the local layer's ring wraps);
* reduced stablelm-1.6b with one kv head at 1 x 2, batch 2, prompt 6 and
  10 steps: a full cache of 16 whose slots 8-15 (rank 1) are all empty at
  the first two steps;
* reduced gemma2-27b at 2 x 1 and 2 x 2 (FSDP storage over data), batch 1,
  prompt 72: its global caches over data, 40 of 80 slots a rank, and its
  local rings, 32 of 64, with softcap 50;
* reduced whisper-large-v3 at 2 x 1, batch 1: the self cache (12 of 24
  slots) and the cross K/V (32 of 64 frames) over data;
* capacities that do not divide the axis: stablelm with one kv head at a
  capacity of 15 (every leaf whole: the serve bitwise equal to the one
  without the option) and gemma2 at 79 (its global leaves whole, its local
  rings split).

Bounds: greedy ids equal and logits within 1e-4 + 1e-4 |ref| of one
process's and of the reference's (prefill and steps; the combine sums in
another order); every rank's cache leaves of exactly the shape
``local_shape(cache_spec_for(...))`` of the one-process leaf, and equal to
their block of one process's cache after the serve within 1e-5 of max
|cache|; the bytes every rank handed to the collectives
(``COLLECTIVE_BYTES``) equal ``launch.analysis.port_collective_bytes``
exactly, ``kv_combine`` nonzero where a leaf is split and zero where none
is; a rank's cache bytes equal to the planner's per-card argument bytes of
the same leaves.  The planner's ``--seq_shard_cache`` and ``--tag``: the
record's name and ``spec_options``, the per-card argument bytes less than
without by exactly the leaves the spec splits, the combine in the
collective term.
"""

import json
import math
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
from repro.models import model as JM
from repro.sharding import specs as JS
from repro.training import init_params as j_init_params
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.data import make_batch_for
from repro_torch.launch import dryrun as D
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.input_specs import specs_for_cfg
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.sharding import specs as TS
from repro_torch.sharding.collectives import COLLECTIVE_BYTES
from repro_torch.sharding.specs import cache_spec_for, leaf_paths, local_shape, local_shard
from repro_torch.training.steps import param_template
from torch_tp_common import SSC_CASES, serve_cache, ssc_capacity, ssc_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = sorted({layout for _, layout, _, _, _ in SSC_CASES.values()})
ODD = ("kv1-odd-1x2", "gemma2-odd-2x1")  # capacities that do not divide the axis

_WORKER = textwrap.dedent('''
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
    from repro_torch.sharding.specs import SPEC_OPTIONS, leaf_paths
    from repro_torch.training.steps import _template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import SSC_CASES, serve_cache, ssc_config  # noqa: E402


    def counted():
        return np.array([C.COLLECTIVE_BYTES[k] for k in sorted(C.COLLECTIVE_BYTES)])


    def one_serve(out, tag, cfg, params, batch, gen):
        """The serve's logits, ids and bytes, and the cache after it."""
        C.reset_collective_bytes()
        with torch.no_grad():
            res = serve(cfg, params, batch, gen=gen)
        out[f"{tag}_bytes"] = counted()
        out[f"{tag}_logits"] = res["logits"].numpy()
        out[f"{tag}_ids"] = res["tokens"].numpy()
        if res["prefill_logits"] is not None:
            out[f"{tag}_prefill"] = res["prefill_logits"].numpy()
        cache = serve_cache(cfg, params, batch, gen)
        leaves = leaf_paths(cache)
        out[f"{tag}_cache_paths"] = json.dumps([p for p, _ in leaves])
        for i, (_, t) in enumerate(leaves):
            out[f"{tag}_cache_{i}"] = t.numpy()


    def worker(rank, world, data, model, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{data}x{model}",
                                rank=rank, world_size=world)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        out = {"data": mesh.index("data"), "model": mesh.index("model")}
        with use_sharding_rules(mesh):
            for name, (arch, layout, _, _, gen) in SSC_CASES.items():
                if layout != (data, model):
                    continue
                cfg = ssc_config(arch)
                tree = dict(np.load(f"{tmp}/params_{arch}.npz"))
                batch = {k: torch.from_numpy(v)
                         for k, v in np.load(f"{tmp}/batch_{name}.npz").items()}
                local, _ = bridge.params_from_jax(tree, cfg, mesh=mesh)
                params = T.flat_view(local, _template(cfg, mesh))
                SPEC_OPTIONS["seq_shard_cache"] = True
                try:
                    one_serve(out, name, cfg, params, batch, gen)
                finally:
                    SPEC_OPTIONS["seq_shard_cache"] = False
                if name.split("-")[1] == "odd":  # and as today, without the option
                    one_serve(out, name + "-off", cfg, params, batch, gen)
        np.savez(f"{tmp}/rank_{data}x{model}_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model in json.loads(sys.argv[3]):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, tmp),
                                        nprocs=data * model, join=True)
        print("OK seq_shard_cache")
''')


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def options():
    """Set ``seq_shard_cache`` in both packages' SPEC_OPTIONS; restore them
    after."""
    old_j, old_t = dict(JS.SPEC_OPTIONS), dict(TS.SPEC_OPTIONS)

    def set_option(on):
        JS.SPEC_OPTIONS["seq_shard_cache"] = TS.SPEC_OPTIONS["seq_shard_cache"] = on

    yield set_option
    JS.SPEC_OPTIONS.update(old_j)
    TS.SPEC_OPTIONS.update(old_t)


def _reference_serve(jcfg, jparams, jbatch, B, S, gen):
    """The reference's serve: prefill and ``gen`` greedy steps (f32 cache);
    for whisper the launcher's cache from the encoder and steps from the
    first prompt token at 0 (no prefill logits)."""
    step = jax.jit(j_make_serve_step(jcfg))
    if jcfg.is_encoder_decoder:
        cache = JM.init_decode_state(jparams, jcfg, B, S + gen, cache_dtype=jnp.float32,
                                     batch=jbatch)
        pre, tok, start = None, jbatch["tokens"][:, 0], 0
    else:
        start = S + (jcfg.num_prefix_embeddings if jcfg.frontend == "vision" else 0)
        logits, cache = JM.prefill(jparams, jbatch, jcfg, start + gen, cache_dtype=jnp.float32)
        pre, tok = np.asarray(logits), jnp.argmax(logits, axis=-1).astype(jnp.int32)
    steps, ids = [], []
    for i in range(gen):
        out = step(jparams, cache, tok, jnp.int32(start + i))
        tok, cache = out["next_token"], out["cache"]
        steps.append(np.asarray(out["logits"]))
        ids.append(np.asarray(tok))
    return pre, np.stack(steps, axis=1), np.stack(ids, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and one process's serves of every case, and every
    rank's (one subprocess spawning the ranks of each layout in turn)."""
    tmp = tmp_path_factory.mktemp("seq_shard_cache")
    want, trees = {}, {}
    for name, (arch, _, B, S, gen) in SSC_CASES.items():
        jcfg, cfg = ssc_config(arch, j_reduced, j_get_config), ssc_config(arch)
        if arch not in trees:
            jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
            keys, leaves, _ = _flatten_with_keys(jparams)
            trees[arch] = (jparams, {k: np.asarray(v) for k, v in zip(keys, leaves)})
            np.savez(tmp / f"params_{arch}.npz", **trees[arch][1])
        jparams, tree = trees[arch]
        jbatch = j_make_batch_for(jcfg, batch=B, seq=S, seed=0)
        batch = make_batch_for(cfg, batch=B, seq=S, seed=0)
        np.savez(tmp / f"batch_{name}.npz", **{k: v.numpy() for k, v in batch.items()})
        flat, _ = bridge.params_from_jax(tree, cfg)
        params = T.flat_view(flat, param_template(cfg))
        with torch.no_grad():
            res = serve(cfg, params, batch, gen=gen)
        cache = serve_cache(cfg, params, batch, gen)
        jpre, jlogits, jids = _reference_serve(jcfg, jparams, jbatch, B, S, gen)
        want[name] = dict(
            prefill=None if res["prefill_logits"] is None else res["prefill_logits"].numpy(),
            logits=res["logits"].numpy(), ids=res["tokens"].numpy(), jprefill=jpre,
            jlogits=jlogits, jids=jids, cache={p: t.numpy() for p, t in leaf_paths(cache)})

    script = tmp / "ssc_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp), os.path.join(ROOT, "tests"),
                           json.dumps(LAYOUTS)],
                          env=env, cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK seq_shard_cache" in proc.stdout
    ranks = {(d, m): [dict(np.load(tmp / f"rank_{d}x{m}_{r}.npz")) for r in range(d * m)]
             for d, m in LAYOUTS}
    return dict(want=want, ranks=ranks)


def _ranks(runs, name):
    return runs["ranks"][SSC_CASES[name][1]]


def _rank_cache(r, tag):
    paths = json.loads(str(r[f"{tag}_cache_paths"]))
    return {p: r[f"{tag}_cache_{i}"] for i, p in enumerate(paths)}


def _rows(r, name, key, whole):
    """The rows and the vocab block of ``whole`` (B, ..., V) that rank ``r``
    holds of ``key``: its data group's rows where the batch splits over
    data (a batch of one row is whole on every data rank), its vocab block
    where ``model`` splits the vocab."""
    _, (data, model), B, _, _ = SSC_CASES[name]
    got = r[key]
    if B % data == 0:
        rows = B // data
        whole = whole[int(r["data"]) * rows:(int(r["data"]) + 1) * rows]
    if got.shape[-1] != whole.shape[-1]:
        v = got.shape[-1]
        whole = whole[..., int(r["model"]) * v:(int(r["model"]) + 1) * v]
    return got, whole


def _split(name, path, shape):
    """The spec of a whole cache leaf under the option and the case's
    layout, and the layout."""
    _, (data, model), B, _, _ = SSC_CASES[name]
    mesh = make_mesh((data, model), ("data", "model"))
    return cache_spec_for(path, shape, mesh, B), mesh


CASES = list(SSC_CASES)


@pytest.mark.parametrize("name", CASES)
def test_serve_matches_one_process_and_reference(runs, name):
    want = runs["want"][name]
    for r in _ranks(runs, name):
        for key, ours, ref in (("prefill", want["prefill"], want["jprefill"]),
                               ("logits", want["logits"], want["jlogits"])):
            if ours is None:
                assert ref is None and f"{name}_{key}" not in r
                continue
            for whole in (ours, ref):
                got, w = _rows(r, name, f"{name}_{key}", whole)
                np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
        for whole in (want["ids"], want["jids"]):
            got, w = _rows(r, name, f"{name}_ids", whole)
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("name", CASES)
def test_caches_are_the_ranks_block_of_one_process(runs, name, options):
    """Every leaf a rank holds after the serve has the spec's local shape
    of the one-process leaf (the reference's ``cache_spec_for``, read by
    both packages alike), and its values are that block of one process's
    cache within 1e-5 of max |cache|.  The reference's spec misreads the
    reduced RG-LRU state (``h`` of width 64, ``<= 64``) as a Mamba state
    (``tests/test_torch_tp_archs.py``), so that leaf's shape is held to
    the layout of the rank's channels instead."""
    options(True)
    arch, (data, model), B, _, _ = SSC_CASES[name]
    whole = runs["want"][name]["cache"]
    fake = _FakeMesh((data, model))
    split = 0
    for rank, r in enumerate(_ranks(runs, name)):
        got = _rank_cache(r, name)
        assert list(got) == list(whole)
        for path, w in whole.items():
            spec, mesh = _split(name, path, w.shape)
            assert _norm(spec) == _norm(JS.cache_spec_for(path, w.shape, fake, B)), path
            if arch == "recurrentgemma-9b" and path.endswith("/h"):
                assert got[path].shape == w.shape[:-1] + (w.shape[-1] // model,), path
                continue
            assert got[path].shape == local_shape(w.shape, spec, mesh), path
            block = local_shard(torch.from_numpy(w), spec, mesh.at(rank)).numpy()
            assert np.abs(got[path] - block).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), path
            split += path.rsplit("/", 1)[-1] in ("k", "v") and got[path].shape[-3] < w.shape[-3]
    assert (split == 0) == (name == "kv1-odd-1x2"), split


@pytest.mark.parametrize("name", CASES)
def test_counted_bytes_equal_the_plan(runs, name, options):
    options(True)
    arch, (data, model), B, S, gen = SSC_CASES[name]
    cfg = ssc_config(arch)
    mesh = make_mesh((data, model), ("data", "model"))
    pre = port_collective_bytes(cfg, "prefill", B, S, mesh)["counted"]
    dec = port_collective_bytes(cfg, "decode", B, S, mesh,
                                capacity=ssc_capacity(cfg, S, gen))["counted"]
    want = [pre.get(k, 0) + gen * dec.get(k, 0) for k in sorted(COLLECTIVE_BYTES)]
    for r in _ranks(runs, name):
        assert r[f"{name}_bytes"].tolist() == want
    assert (dec["kv_combine"] == 0) == (name == "kv1-odd-1x2")
    # the query heads are gathered where the capacity splits over model and
    # the query heads split too
    assert (dec["kv_gather"] > 0) == (arch in ("recurrentgemma-9b", "kv1")
                                      and name != "kv1-odd-1x2")


@pytest.mark.parametrize("name", CASES)
def test_cache_bytes_equal_the_planners(runs, name, options):
    """A rank's ``k`` / ``v`` leaves hold the bytes the planner's argument
    bytes per card give the same leaves of the whole cache
    (``dryrun.argument_bytes``, which reads the specs)."""
    options(True)
    arch, (data, model), B, S, gen = SSC_CASES[name]
    cfg = ssc_config(arch)
    mesh = make_mesh((data, model), ("data", "model"))
    kv = {p: np.zeros(w.shape, np.float32) for p, w in runs["want"][name]["cache"].items()
          if p.rsplit("/", 1)[-1] in ("k", "v")}
    meta = {p: torch.empty(w.shape, dtype=torch.float32, device="meta") for p, w in kv.items()}
    planned = D.argument_bytes(meta, mesh, B)[0]
    for r in _ranks(runs, name):
        got = _rank_cache(r, name)
        assert sum(got[p].nbytes for p in kv) == planned


@pytest.mark.parametrize("name", ODD)
def test_a_leaf_the_spec_keeps_whole_is_as_today(runs, name):
    """Where the axes do not divide a leaf's capacity the leaf stays whole,
    as without the option: every leaf of kv1 at a capacity of 15 (the
    serve bitwise equal to the one without the option, and no combine),
    gemma2's global leaves at 79 (its local rings of 64 split)."""
    for r in _ranks(runs, name):
        on, off = _rank_cache(r, name), _rank_cache(r, name + "-off")
        for path in off:
            ring = "pos0" in path and name.startswith("gemma2")  # the local layers
            if path.rsplit("/", 1)[-1] in ("k", "v") and ring:
                assert on[path].shape[-3] * 2 == off[path].shape[-3], path
            else:
                assert on[path].shape == off[path].shape, path
        if name == "kv1-odd-1x2":
            for key in ("logits", "ids", "bytes", "prefill"):
                np.testing.assert_array_equal(r[f"{name}_{key}"], r[f"{name}-off_{key}"])
            for path in off:
                np.testing.assert_array_equal(on[path], off[path])


def test_a_rank_holds_only_empty_slots_at_the_first_step():
    """kv1-1x2's geometry: a full cache of 16 positions, rank 1's slots
    8-15 all empty at the first two steps (positions 6 and 7), written from
    the third on (``test_serve_matches_one_process_and_reference`` holds
    its serve)."""
    arch, _, _, S, gen = SSC_CASES["kv1-1x2"]
    cap = ssc_capacity(ssc_config(arch), S, gen)
    assert cap == 16 and S + 1 < cap // 2 <= S + gen - 1


class _FakeMesh:
    """The reference's duck-typed mesh (tests/test_sharding.py)."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = axes
        self.devices = np.zeros(shape)
        self._shape = dict(zip(axes, shape))

    @property
    def shape(self):
        return self._shape


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


# ---------------------------------------------------------------------------
# The planner's --seq_shard_cache and --tag
# ---------------------------------------------------------------------------

PLANS = [("recurrentgemma-9b", "decode_32k", ["--cards", "4"], "card4"),
         ("gemma2-27b", "long_500k", ["--small_mesh"], "small")]


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """Each of :data:`PLANS` planned without and with ``--seq_shard_cache
    --tag t``."""
    out = tmp_path_factory.mktemp("plans")
    recs = {}
    for arch, shape, flags, tag in PLANS:
        for extra, suffix in (([], ""), (["--seq_shard_cache", "--tag", "t"], "_t")):
            assert D.main(["--arch", arch, "--shape", shape, *flags, *extra,
                           "--out", str(out)]) == 0
            with open(out / f"{arch.replace('.', '_')}_{shape}_{tag}{suffix}.json") as f:
                recs[(arch, bool(extra))] = json.load(f)
    assert not TS.SPEC_OPTIONS["seq_shard_cache"]  # restored
    return recs


@pytest.mark.parametrize("arch,shape,flags,tag", PLANS)
def test_planner_records_carry_the_tag_and_the_options(plans, arch, shape, flags, tag):
    on, off = plans[(arch, True)], plans[(arch, False)]
    assert on["status"] == off["status"] == "ok"
    assert on["spec_options"] == {"seq_shard_cache": True, "replicate_params_over_data": False}
    assert off["spec_options"]["seq_shard_cache"] is False


@pytest.mark.parametrize("arch,shape,flags,tag", PLANS)
def test_planner_cache_bytes_shrink_by_the_leaves_the_spec_splits(plans, arch, shape, flags,
                                                                  tag, options):
    """Per-card argument bytes with the flag are those without it less,
    for every ``k`` / ``v`` leaf the spec splits, the bytes of its block
    without the split less those with it; and the collective term counts
    the combine (and recurrentgemma's query gather over model)."""
    from repro_torch.configs import INPUT_SHAPES, get_config

    seq, batch, _ = INPUT_SHAPES[shape]
    mesh = D._mesh_for(cards=4, small_mesh=tag == "small")[0]
    args = specs_for_cfg(D._serving(get_config(arch), "decode"), shape)
    saved = 0
    for path, t in leaf_paths(args[1]):
        if path.rsplit("/", 1)[-1] not in ("k", "v"):
            continue
        sizes = []
        for on in (False, True):
            options(on)
            sizes.append(math.prod(local_shape(tuple(t.shape), cache_spec_for(
                path, tuple(t.shape), mesh, batch), mesh)) * t.element_size())
        saved += sizes[0] - sizes[1]
    assert saved > 0
    on, off = plans[(arch, True)], plans[(arch, False)]
    assert off["memory"]["argument_bytes"] - on["memory"]["argument_bytes"] == saved
    assert on["collectives"]["counted"]["kv_combine"] > 0
    assert off["collectives"]["counted"]["kv_combine"] == 0
    assert (on["collectives"]["counted"]["kv_gather"] > 0) == (arch == "recurrentgemma-9b")
    assert on["collectives"]["all-reduce"] > off["collectives"]["all-reduce"]
