"""Port parity, the sharding rules: ``repro_torch.sharding`` against
``repro.sharding``.

The specs are pure functions of a leaf's path, its shape and the layout, so
they are held EXACTLY: for every arch, full width and reduced, every leaf of
every step's arguments (the train state with its ring and tables, params,
batches, decode caches) gets the reference's ``PartitionSpec`` as a tuple,
on the reference's pod layouts (16 x 16 and 2 x 16 x 16) and the port's
(1 x 4, 2 x 2), with each ``SPEC_OPTIONS`` switch off and on.  The trees on
both sides are shape-only (``jax.eval_shape`` and ``meta`` tensors), and the
paths are compared first: the port's ``leaf_paths`` must give the
reference's ``_path_str`` of every leaf, in the same order.  A one-axis
tuple entry (``("data",)``) and the bare name are the same sharding; this
JAX's ``PartitionSpec`` stores the name, so both sides are compared in that
form (:func:`_norm`).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import input_specs as JI
from repro.sharding import ctx as JCTX
from repro.sharding import specs as JS
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, reduced
from repro_torch.launch import input_specs as TI
from repro_torch.launch.mesh import make_mesh, make_production_mesh, make_small_mesh
from repro_torch.sharding import ctx as TCTX
from repro_torch.sharding import specs as TS


class FakeMesh:
    """The reference's duck-typed mesh (tests/test_sharding.py)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)
        self._shape = dict(zip(axes, shape))

    @property
    def shape(self):
        return self._shape


LAYOUTS = {
    "pod-16x16": ((16, 16), ("data", "model")),
    "pods-2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "node-1x4": ((1, 4), ("data", "model")),
    "ci-2x2": ((2, 2), ("data", "model")),
}
OPTIONS = [dict(seq_shard_cache=False, replicate_params_over_data=False),
           dict(seq_shard_cache=True, replicate_params_over_data=True),
           dict(seq_shard_cache=True, replicate_params_over_data=False)]


@pytest.fixture
def options():
    """Set both packages' SPEC_OPTIONS together; restore them after."""
    old_j, old_t = dict(JS.SPEC_OPTIONS), dict(TS.SPEC_OPTIONS)

    def set_options(opts):
        JS.SPEC_OPTIONS.update(opts)
        TS.SPEC_OPTIONS.update(opts)

    yield set_options
    JS.SPEC_OPTIONS.update(old_j)
    TS.SPEC_OPTIONS.update(old_t)


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuple entries as the bare axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _j_leaves(specs):
    return [_norm(s) for s in jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JS.P))]


def _j_specs(tree, mesh, batch):
    paths = [JS._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return list(zip(paths, _j_leaves(JS.auto_specs(tree, mesh, batch))))


def _spec_leaves(tree):
    """The specs of a tree of specs, in leaf order."""
    return [_norm(s) for _, s in TS.leaf_paths(tree)]


def _configs(arch, size):
    if size == "full":
        return j_get_config(arch), get_config(arch)
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_every_leaf_spec_matches_reference(arch, size, options):
    jcfg, tcfg = _configs(arch, size)
    for shape_name, (_, batch, _) in INPUT_SHAPES.items():
        jtree = JI.specs_for_cfg(jcfg, shape_name)
        ttree = TI.specs_for_cfg(tcfg, shape_name)
        jpaths = [JS._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        tpaths = [p for p, _ in TS.leaf_paths(ttree)]
        assert tpaths == jpaths, (shape_name, sorted(set(tpaths) ^ set(jpaths))[:8])
        for opts in OPTIONS:
            options(opts)
            for shape, axes in LAYOUTS.values():
                want = _j_specs(jtree, FakeMesh(shape, axes), batch)
                got = list(zip(tpaths, _spec_leaves(TS.auto_specs(ttree, make_mesh(shape, axes),
                                                                   batch))))
                assert got == want, (shape_name, opts, shape,
                                     [(g, w) for g, w in zip(got, want) if g != w][:4])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_param_cache_and_worker_specs_match_reference(layout, options):
    """``tree_specs`` on params, ``cache_specs`` on a decode cache and
    ``worker_specs`` on a per-worker ring, for every arch at full width."""
    shape, axes = LAYOUTS[layout]
    jmesh, tmesh = FakeMesh(shape, axes), make_mesh(shape, axes)
    wmesh_j, wmesh_t = FakeMesh((4,), ("workers",)), make_mesh((4,), ("workers",))
    for opts in OPTIONS[:2]:
        options(opts)
        for arch in ASSIGNED_ARCHS:
            jcfg, tcfg = _configs(arch, "full")
            jp, _, _, _ = JI.specs_for_cfg(jcfg, "decode_32k")
            tp, tcache, _, _ = TI.specs_for_cfg(tcfg, "decode_32k")
            jcache = JI.specs_for_cfg(jcfg, "decode_32k")[1]
            for jfn, tfn, jt, tt in (
                    (lambda t, m: JS.tree_specs(t, m), lambda t, m: TS.tree_specs(t, m), jp, tp),
                    (lambda t, m: JS.cache_specs(t, m, 128), lambda t, m: TS.cache_specs(t, m, 128),
                     jcache, tcache)):
                want = _j_leaves(jfn(jt, jmesh))
                assert _spec_leaves(tfn(tt, tmesh)) == want, arch
            ring_j = jax.tree.map(lambda s: jax.ShapeDtypeStruct((4, 2) + s.shape, s.dtype), jp)
            want = _j_leaves(JS.worker_specs(ring_j, wmesh_j))
            ring_t = _prepend(tp, (4, 2))
            assert _spec_leaves(TS.worker_specs(ring_t, wmesh_t)) == want, arch
            # no workers axis on a data x model layout: everything replicates
            assert set(_spec_leaves(TS.worker_specs(ring_t, tmesh))) == {()}


def _prepend(tree, lead):
    import torch

    if isinstance(tree, dict):
        return {k: _prepend(v, lead) for k, v in tree.items()}
    return torch.empty(lead + tuple(tree.shape), dtype=tree.dtype, device="meta")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rules_spec_on_every_logical_name(layout):
    shape, axes = LAYOUTS[layout]
    jr = JCTX.ShardingRules(FakeMesh(shape, axes), dict(JCTX.DEFAULT_RULES))
    tr = TCTX.ShardingRules(make_mesh(shape, axes), dict(TCTX.DEFAULT_RULES))
    assert TCTX.DEFAULT_RULES == JCTX.DEFAULT_RULES
    names = list(JCTX.DEFAULT_RULES) + [None, "unknown"]
    for name in names:
        assert _norm(tr.spec([name])) == _norm(jr.spec([name])), name
    assert _norm(tr.spec(names)) == _norm(jr.spec(names))


def test_rules_context_and_shard_activation():
    import torch

    mesh = make_small_mesh(device="cpu")
    assert TCTX.current_rules() is None
    with TCTX.use_sharding_rules(mesh):
        rules = TCTX.current_rules()
        assert rules.mesh is mesh and rules.spec(["batch", "heads"]) == (("data",), "model")
        x = torch.ones(2, 3)
        assert TCTX.shard_activation(x, ("batch", "d_model")) is x
        with TCTX.use_sharding_rules(mesh, {"batch": "model"}):
            assert TCTX.current_rules().spec(["batch"]) == ("model",)
    assert TCTX.current_rules() is None


def test_layouts_and_local_blocks():
    """The production layout is one node of 4 cards (data 1 x model 4), the
    CI layout data 2 x model 2; ``local_shape`` divides each sharded dim by
    its axes' sizes and ``local_shard`` takes this rank's block."""
    import torch

    prod, small = make_production_mesh(device="cpu"), make_small_mesh(device="cpu")
    assert prod.devices.shape == (1, 4) and prod.axis_names == ("data", "model")
    assert small.devices.shape == (2, 2) and small.devices.size == 4
    assert not prod.running and not small.running
    spec = TS.param_spec_for("stack/pos0/moe/w_up_e", (24, 64, 2048, 1408), small)
    assert spec == (None, "model", None, ("data",))
    assert TS.local_shape((24, 64, 2048, 1408), spec, small) == (24, 32, 2048, 704)
    t = torch.arange(4 * 6).reshape(4, 6)
    ranked = dataclasses.replace(small, coords={"data": 1, "model": 0})
    np.testing.assert_array_equal(TS.local_shard(t, ("model", ("data",)), ranked).numpy(),
                                  t[:2, 3:].numpy())
