"""Port parity: the checkpoint store (``checkpoint/store.py``) and its on-disk
format.

Contracts, all exact:
* npz arrays are named by the reference's key paths, bf16 leaves are
  ``uint16`` views under ``"bfloat16"`` in the ``ckpt.v2`` manifest, and a
  round trip keeps every bit;
* a structure mismatch names the paths, a shape mismatch raises, a missing
  manifest refuses;
* trees saved by the port load with the reference's ``load_pytree`` and the
  other way round, bit for bit;
* for sync/async x fused/unfused a port TrainState checkpoint has exactly the
  reference's names, in its order, with its shapes and stored dtypes — all but
  ``.rng``: a torch generator's state is not a jax key, so it raises when
  crossed, and every other leaf crosses bit for bit in both directions.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JC
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro.optim import transform as JT
from repro.run import RunSpec as JSpec
from repro.run.engine import make_engine as j_make_engine
from repro.training import make_adapt as j_make_adapt
from repro_torch.checkpoint import store as TC
from repro_torch.configs import get_config, reduced
from repro_torch.core import staleness as TS
from repro_torch.core import step_size as TSS
from repro_torch.optim import transform as TT
from repro_torch.run import RunSpec
from repro_torch.run.engine import make_engine
from repro_torch.training import make_adapt

TAU_MAX, RING, LR = 31, 8, 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(3, 4, generator=g),
        "nested": {"h": torch.randn(5, generator=g).to(torch.bfloat16),
                   "count": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
        "pair": (torch.randn(2, generator=g), None, torch.randn(7, generator=g).to(torch.bfloat16)),
        "scalar": torch.tensor(11, dtype=torch.int32),
    }


def _jax_like(tree):
    def conv(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16)).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    if isinstance(tree, dict):
        return {k: _jax_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_jax_like(v) for v in tree)
    return conv(tree)


def _bits_np(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bits_t(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


class TestStore:
    def test_names_manifest_and_bf16_roundtrip(self, tmp_path):
        tree = _port_tree()
        TC.save_pytree(str(tmp_path / "ck"), tree)
        data = np.load(str(tmp_path / "ck.npz"))
        assert sorted(data.files) == sorted([
            "['w']", "['nested']['h']", "['nested']['count']", "['pair'][0]", "['pair'][2]",
            "['scalar']"])
        assert data["['nested']['h']"].dtype == np.uint16
        with open(tmp_path / "ck.json") as f:
            manifest = json.load(f)
        assert manifest["schema"] == "ckpt.v2" and manifest["num_leaves"] == 6
        assert manifest["dtypes"] == {"['nested']['h']": "bfloat16", "['pair'][2]": "bfloat16"}
        back = TC.load_pytree(str(tmp_path / "ck"), tree)
        for (ka, a), (kb, b) in zip(TC.key_paths(tree), TC.key_paths(back)):
            assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(_bits_t(a), _bits_t(b))
        assert back["pair"][1] is None and isinstance(back["pair"], tuple)

    def test_structure_mismatch_names_paths(self, tmp_path):
        TC.save_pytree(str(tmp_path / "ck"), {"a": torch.ones(3), "b": torch.zeros(2)})
        with pytest.raises(ValueError) as e:
            TC.load_pytree(str(tmp_path / "ck"), {"a": torch.ones(3), "c": torch.zeros(2)})
        msg = str(e.value)
        assert "['c']" in msg and "['b']" in msg
        assert "does not match the restore template" in msg

    def test_shape_mismatch_and_dtype_cast(self, tmp_path):
        TC.save_pytree(str(tmp_path / "ck"), {"a": torch.arange(4, dtype=torch.float32)})
        with pytest.raises(ValueError, match=r"leaf \['a'\]: checkpoint shape"):
            TC.load_pytree(str(tmp_path / "ck"), {"a": torch.zeros(5)})
        back = TC.load_pytree(str(tmp_path / "ck"), {"a": torch.zeros(4, dtype=torch.bfloat16)})
        assert back["a"].dtype == torch.bfloat16
        assert back["a"].tolist() == [0.0, 1.0, 2.0, 3.0]

    def test_missing_manifest_refuses(self, tmp_path):
        TC.save_pytree(str(tmp_path / "ck"), {"a": torch.ones(2, dtype=torch.bfloat16)})
        os.remove(tmp_path / "ck.json")
        with pytest.raises(FileNotFoundError, match="manifest"):
            TC.load_pytree(str(tmp_path / "ck"), {"a": torch.ones(2, dtype=torch.bfloat16)})

    def test_meta_template_restores_onto_device_and_generator_state(self, tmp_path):
        gen = torch.Generator().manual_seed(5)
        torch.rand(3, generator=gen)
        tree = {"p": torch.randn(6), "rng": gen}
        TC.save_pytree(str(tmp_path / "ck"), tree)
        like = {"p": torch.empty(6, device="meta"), "rng": torch.Generator()}
        back = TC.load_pytree(str(tmp_path / "ck"), like, device="cpu")
        assert back["p"].device.type == "cpu" and torch.equal(back["p"], tree["p"])
        assert torch.equal(torch.rand(4, generator=back["rng"]), torch.rand(4, generator=gen))

    def test_chunked_stream_keeps_every_byte(self, tmp_path, monkeypatch):
        """Leaves larger than a chunk are written and read in pieces."""
        monkeypatch.setattr(TC, "CHUNK_BYTES", 64)
        tree = {"big": torch.randn(1001), "bits": torch.randn(333).to(torch.bfloat16)}
        TC.save_pytree(str(tmp_path / "ck"), tree)
        data = np.load(str(tmp_path / "ck.npz"))
        np.testing.assert_array_equal(data["['big']"], tree["big"].numpy())
        back = TC.load_pytree(str(tmp_path / "ck"), tree)
        assert torch.equal(back["big"], tree["big"])
        np.testing.assert_array_equal(_bits_t(back["bits"]), _bits_t(tree["bits"]))

    def test_port_trees_load_in_the_reference(self, tmp_path):
        tree = _port_tree(1)
        TC.save_pytree(str(tmp_path / "ck"), tree)
        back = JC.load_pytree(str(tmp_path / "ck"), _jax_like(tree))
        ref_leaves = [leaf for _, leaf in TC.key_paths(tree)]
        for a, b in zip(ref_leaves, jax.tree.leaves(back)):
            np.testing.assert_array_equal(_bits_t(a), _bits_np(b))
        assert back["nested"]["h"].dtype == jnp.bfloat16

    def test_reference_trees_load_in_the_port(self, tmp_path):
        jtree = _jax_like(_port_tree(2))
        JC.save_pytree(str(tmp_path / "ck"), jtree)
        back = TC.load_pytree(str(tmp_path / "ck"), _port_tree(9))
        for a, b in zip(jax.tree.leaves(jtree), [leaf for _, leaf in TC.key_paths(back)]):
            np.testing.assert_array_equal(_bits_np(a), _bits_t(b))
        assert back["nested"]["h"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# TrainState checkpoints across packages
# ---------------------------------------------------------------------------

def _states(mode, fuse):
    """The same run's initial state built by each package (reduced
    stablelm-1.6b, d_model 64, the specs of tests/test_run.py)."""
    jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    out = []
    for pkg in ("ref", "port"):
        S, SS, T = (JS, JSS, JT) if pkg == "ref" else (TS, TSS, TT)
        sched = SS.make_schedule("poisson_momentum", LR, S.Poisson(3.0), K=1.0, tau_max=TAU_MAX)
        if mode == "sync":
            pipe, adapt, ring = T.chain(T.scale(-LR), T.trace(0.9)), None, 0
        else:
            pipe = T.chain(T.scale_by_staleness(sched, LR, m=4, tau_max=TAU_MAX), T.scale(-LR))
            make = j_make_adapt if pkg == "ref" else make_adapt
            adapt, ring = make(sched, S.Poisson(3.0), cdf_support=RING, tau_max=TAU_MAX), RING
        kw = dict(pipeline=pipe, mode=mode, num_steps=3, num_workers=4, ring=ring, adapt=adapt,
                  fuse=fuse, seed=0)
        if pkg == "ref":
            out.append(j_make_engine(JSpec(cfg=jcfg, **kw)).build())
        else:
            out.append(make_engine(RunSpec(cfg=cfg, device="cpu", **kw)).build())
    return out


CELLS = [("sync", False), ("sync", True), ("async", False), ("async", True)]


@pytest.mark.parametrize("mode,fuse", CELLS, ids=[f"{m}-{'fused' if f else 'unfused'}"
                                                  for m, f in CELLS])
def test_train_state_checkpoints_have_the_reference_layout(tmp_path, mode, fuse):
    jstate, tstate = _states(mode, fuse)
    JC.save_pytree(str(tmp_path / "ref"), jstate)
    TC.save_pytree(str(tmp_path / "port"), tstate)
    with open(tmp_path / "ref.json") as f:
        jman = json.load(f)
    with open(tmp_path / "port.json") as f:
        tman = json.load(f)
    assert tman["keys"] == jman["keys"]
    assert tman["dtypes"] == jman["dtypes"]
    assert tman["generators"] == {".rng": "cpu"}
    jd, td = np.load(str(tmp_path / "ref.npz")), np.load(str(tmp_path / "port.npz"))
    for k in jman["keys"]:
        if k == ".rng":
            assert jd[k].dtype == np.uint32 and td[k].dtype == np.uint8
            continue
        assert (td[k].shape, td[k].dtype) == (jd[k].shape, jd[k].dtype), k
    names = set(jman["keys"])
    assert ".step" in names and ".rng" in names
    assert (".params" in names) if fuse else any(n.startswith(".params[") for n in names)
    if mode == "async":
        assert {".adapt.alpha_table", ".adapt.tau_cdf", ".adapt.hist"} <= names

    # .rng cannot cross: the port refuses the reference's jax key, naming it
    with pytest.raises(ValueError, match=r"leaf \.rng: .*not a torch\.Generator state"):
        TC.load_pytree(str(tmp_path / "ref"), tstate)
    # ... and the reference cannot read a generator state as its key
    with pytest.raises(AssertionError, match=r"leaf \.rng"):
        JC.load_pytree(str(tmp_path / "port"), jstate)

    # every other leaf crosses bit for bit, both ways
    JC.save_pytree(str(tmp_path / "ref_norng"), dataclasses.replace(jstate, rng=None))
    TC.save_pytree(str(tmp_path / "port_norng"), dataclasses.replace(tstate, rng=None))
    into_port = TC.load_pytree(str(tmp_path / "ref_norng"), dataclasses.replace(tstate, rng=None))
    into_ref = JC.load_pytree(str(tmp_path / "port_norng"), dataclasses.replace(jstate, rng=None))
    jleaves = dict(zip([k for k in jman["keys"] if k != ".rng"], jax.tree.leaves(
        dataclasses.replace(jstate, rng=None))))
    for k, leaf in TC.key_paths(into_port):
        np.testing.assert_array_equal(_bits_t(leaf), _bits_np(jleaves[k]), err_msg=k)
    tleaves = dict(TC.key_paths(dataclasses.replace(tstate, rng=None)))
    back = dict(zip(tleaves, jax.tree.leaves(into_ref)))
    for k, leaf in tleaves.items():
        np.testing.assert_array_equal(_bits_np(back[k]), _bits_t(leaf), err_msg=k)
