"""Checkpoint/resume inside the port, the Run API's hooks and the launchers'
checkpoint and bench flags (``run/ckpt.py``, ``run/hooks.py``,
``run/engine.py``, ``launch/train.py``, ``launch/serve.py``).

The load-bearing guarantee, as in tests/test_run.py for the reference: a run
interrupted at step 3 and resumed from its checkpoint is BIT-IDENTICAL to the
uninterrupted run — losses, every leaf of the final TrainState (the
generator's state included) and the host estimator — for sync/async x
fused/unfused, across a ``refresh_every=2`` boundary, on the CPU.  Bench rows
and their config hashes are held to the reference's, exactly.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from repro import bench_schema as JB
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import staleness as JS
from repro.core import step_size as JSS
from repro.data import make_batch_for as j_make_batch_for
from repro.optim import transform as JT
from repro.run import BenchHook as JBenchHook
from repro.run import RunSpec as JSpec
from repro.run import run as j_run
from repro_torch import bench_schema as TB
from repro_torch.checkpoint import key_paths, latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.core.staleness import Poisson
from repro_torch.core.step_size import make_schedule
from repro_torch.data import make_batch_for
from repro_torch.optim import transform as T
from repro_torch.run import (
    BenchHook,
    CheckpointHook,
    EvalHook,
    Hook,
    LogHook,
    PrebuiltEngine,
    RunSpec,
    make_engine,
    run,
)
from repro_torch.training import init_train_state, make_adapt, make_step

TAU_MAX, RING, LR = 31, 8, 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def small_cfg():
    return reduced(get_config("stablelm-1.6b"), d_model=64)


def _spec_for(mode, cfg, *, fuse=False, num_steps=6, refresh_every=2):
    """A fresh RunSpec (fresh pipeline + adapt: estimator state starts empty)."""
    sched = make_schedule("poisson_momentum", LR, Poisson(3.0), K=1.0, tau_max=TAU_MAX)
    if mode == "sync":
        pipeline = T.chain(T.scale(-LR), T.trace(0.9))
        adapt, ring, refresh_every = None, 0, 0
    else:
        link = T.scale_by_staleness(sched, LR, m=4, tau_max=TAU_MAX)
        pipeline = T.chain(link, T.scale(-LR))
        adapt, ring = make_adapt(sched, Poisson(3.0), cdf_support=RING, tau_max=TAU_MAX), RING
    return RunSpec(
        cfg=cfg, pipeline=pipeline, mode=mode, num_steps=num_steps,
        batch_fn=lambda t: make_batch_for(cfg, batch=2, seq=16, seed=100 + t),
        num_workers=4, ring=ring, adapt=adapt, fuse=fuse, refresh_every=refresh_every,
        seed=0, device="cpu",
    )


def _bits(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return leaf.reshape(-1).view(torch.uint8) if leaf.dim() else leaf.reshape(1).view(torch.uint8)


def _assert_states_equal(a, b):
    la, lb = dict(key_paths(a)), dict(key_paths(b))
    assert list(la) == list(lb)
    for k in la:
        assert torch.equal(_bits(la[k]), _bits(lb[k])), k


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_tick(self, ctx):
        self.losses.append(float(ctx.metrics["loss"]))


CELLS = [("sync", False), ("sync", True), ("async", False), ("async", True)]


class TestResumeParity:
    @pytest.mark.parametrize("mode,fuse", CELLS,
                             ids=[f"{m}-{'fused' if f else 'unfused'}" for m, f in CELLS])
    def test_resume_bit_identical(self, mode, fuse, small_cfg, tmp_path):
        ckpt, save_at = str(tmp_path / "ck"), 3
        spec_a, track_a = _spec_for(mode, small_cfg, fuse=fuse), _Losses()
        res_a = run(spec_a, hooks=[track_a, CheckpointHook(ckpt, every=save_at)])
        if mode != "sync":
            data = np.load(os.path.join(ckpt, f"step_{save_at:08d}.npz"))
            assert int(data[".adapt.hist"].sum()) > 0, "partial histogram must be captured"
        spec_b, track_b = _spec_for(mode, small_cfg, fuse=fuse), _Losses()
        res_b = run(spec_b, hooks=[track_b], resume_from=ckpt, resume_step=save_at)
        assert res_b.start_step == save_at and res_b.step == 6
        assert track_b.losses == track_a.losses[save_at:]
        _assert_states_equal(res_a.state, res_b.state)
        if mode != "sync":
            est_a = T.staleness_link(spec_a.pipeline).estimator
            est_b = T.staleness_link(spec_b.pipeline).estimator
            assert est_a.n_seen == est_b.n_seen > 0
            np.testing.assert_array_equal(est_a.counts, est_b.counts)
            np.testing.assert_array_equal(T.staleness_link(spec_a.pipeline).schedule.table,
                                          T.staleness_link(spec_b.pipeline).schedule.table)

    def test_resume_rejects_wrong_layout(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "layout")
        run(_spec_for("async", small_cfg, fuse=True, num_steps=3, refresh_every=0),
            hooks=[CheckpointHook(ckpt, every=3)])
        with pytest.raises(ValueError, match="does not match the restore template"):
            run(_spec_for("async", small_cfg, fuse=False, num_steps=3, refresh_every=0),
                resume_from=ckpt)

    def test_resume_at_num_steps_is_noop(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "noop")
        res = run(_spec_for("sync", small_cfg, num_steps=3), hooks=[CheckpointHook(ckpt, every=3)])
        res2 = run(_spec_for("sync", small_cfg, num_steps=3), resume_from=ckpt)
        assert res2.start_step == res2.step == 3
        _assert_states_equal(res.state, res2.state)

    def test_resume_beyond_num_steps_refused(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "beyond")
        run(_spec_for("sync", small_cfg, num_steps=4), hooks=[CheckpointHook(ckpt, every=4)])
        with pytest.raises(ValueError, match="beyond num_steps"):
            run(_spec_for("sync", small_cfg, num_steps=3), resume_from=ckpt)

    def test_interrupted_save_keeps_latest_resumable(self, small_cfg, tmp_path, monkeypatch):
        import repro_torch.run.ckpt as ckpt_mod
        from repro_torch.run.ckpt import save_checkpoint

        ckpt = str(tmp_path / "crash")
        spec = _spec_for("async", small_cfg, num_steps=3, refresh_every=0)
        res = run(spec, hooks=[CheckpointHook(ckpt, every=3)])
        assert latest_step(ckpt) == 3

        def crashing_save_train_state(directory, state, step):
            raise RuntimeError("simulated crash mid-save")

        monkeypatch.setattr(ckpt_mod, "save_train_state", crashing_save_train_state)
        with pytest.raises(RuntimeError, match="simulated crash"):
            save_checkpoint(ckpt, res.state, spec.pipeline, 4)
        assert latest_step(ckpt) == 3
        monkeypatch.undo()
        res2 = run(_spec_for("async", small_cfg, num_steps=3, refresh_every=0), resume_from=ckpt)
        _assert_states_equal(res.state, res2.state)

    def test_missing_sidecar_refused_for_an_adaptive_pipeline(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "nosidecar")
        run(_spec_for("async", small_cfg, num_steps=3, refresh_every=0),
            hooks=[CheckpointHook(ckpt, every=3)])
        os.remove(os.path.join(ckpt, "step_00000003_host.npz"))
        with pytest.raises(ValueError, match="no host sidecar"):
            run(_spec_for("async", small_cfg, num_steps=3, refresh_every=0), resume_from=ckpt)


class TestTemplate:
    @pytest.mark.parametrize("mode,fuse", CELLS,
                             ids=[f"{m}-{'fused' if f else 'unfused'}" for m, f in CELLS])
    def test_build_template_allocates_nothing(self, mode, fuse, small_cfg):
        spec = _spec_for(mode, small_cfg, fuse=fuse)
        template = dict(key_paths(make_engine(spec).build_template()))
        state = dict(key_paths(make_engine(spec).build()))
        assert list(template) == list(state)
        for k, t in template.items():
            s = state[k]
            if isinstance(t, torch.Generator):
                assert k == ".rng" and t.device.type == "cpu"
                continue
            assert t.device.type == "meta", k
            assert (t.shape, t.dtype) == (s.shape, s.dtype), k

    def test_resume_never_builds_concretely(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "abstract")
        track_a = _Losses()
        res_a = run(_spec_for("async", small_cfg, fuse=True),
                    hooks=[track_a, CheckpointHook(ckpt, every=3)])
        spec_b = _spec_for("async", small_cfg, fuse=True)
        engine_b = make_engine(spec_b)

        def forbidden_build():
            raise AssertionError("resume must not build the state concretely")

        engine_b.build = forbidden_build
        track_b = _Losses()
        res_b = run(spec_b, hooks=[track_b], engine=engine_b, resume_from=ckpt, resume_step=3)
        assert track_b.losses == track_a.losses[3:]
        _assert_states_equal(res_a.state, res_b.state)


class TestEngines:
    def test_lifecycle_members(self, small_cfg):
        engine = make_engine(_spec_for("async", small_cfg))
        assert engine.retraces is None and engine.liveness() == {}

    def test_prebuilt_engine_matches_spec_run(self, small_cfg):
        spec = _spec_for("sync", small_cfg, num_steps=4)
        res = run(spec)
        pipe = T.chain(T.scale(-LR), T.trace(0.9))
        state = init_train_state(small_cfg, pipe, seed=0, device="cpu")
        engine = PrebuiltEngine(make_step(small_cfg, pipe, mode="sync"), state, pipeline=pipe,
                                spec=spec)
        assert engine.build() is state and engine.build_template() is state
        res2 = run(spec, engine=engine)
        _assert_states_equal(res.state, res2.state)


class TestHooks:
    def test_checkpointhook_at_end(self, small_cfg, tmp_path):
        ckpt = str(tmp_path / "end")
        hook = CheckpointHook(ckpt, every=2, at_end=True)
        run(_spec_for("sync", small_cfg, num_steps=5), hooks=[hook])
        assert hook.saved_steps == [2, 4, 5]
        assert latest_step(ckpt) == 5
        assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(ckpt, "*_host.npz"))) == [
            "step_00000002_host.npz", "step_00000004_host.npz", "step_00000005_host.npz"]

    def test_evalhook_cadence(self, small_cfg):
        def eval_fn(state):
            return {"param_norm": T.global_norm(state.params)}

        hook = EvalHook(eval_fn, every=2)
        res = run(_spec_for("sync", small_cfg, num_steps=5),
                  hooks=[LogHook(log_every=5, logger=lambda s: None), hook])
        assert [r["step"] for r in hook.records] == [2, 4, 5]
        assert all(isinstance(r["eval/param_norm"], float) for r in hook.records)
        assert res.records["eval"] is hook.records
        assert "loss" in res.history[-1]

    def test_benchhook_rows_equal_the_reference(self, small_cfg):
        """Same config dict -> the reference's names, units and config hash
        (its retrace row is the one left out: the port runs eagerly)."""
        config = {"cell": "unit-test", "workers": 4}
        hook = BenchHook("unit/cell", config)
        res = run(_spec_for("async", small_cfg, num_steps=4), hooks=[hook])
        TB.validate_rows(hook.rows)
        assert res.records["unit/cell"] is hook.rows

        jcfg = j_reduced(j_get_config("stablelm-1.6b"), d_model=64)
        jspec = JSpec(cfg=jcfg, pipeline=JT.chain(JT.scale(-LR)), mode="sync", num_steps=4,
                      batch_fn=lambda t: j_make_batch_for(jcfg, batch=2, seq=16, seed=100 + t))
        jhook = JBenchHook("unit/cell", config)
        j_run(jspec, hooks=[jhook])
        jrows = [r for r in jhook.rows if not r["name"].endswith("/retraces")]
        assert [r["name"] for r in hook.rows] == [r["name"] for r in jrows] == [
            "unit/cell/final_loss", "unit/cell/wall_s"]
        assert [r["unit"] for r in hook.rows] == [r["unit"] for r in jrows]
        assert [r["config"] for r in hook.rows] == [r["config"] for r in jrows]
        assert hook.rows[0]["config"] == JB.config_hash(config) == TB.config_hash(config)
        meta = hook.rows[0]["meta"]
        assert meta["updates"] == [1, 2, 3, 4] and len(meta["losses"]) == 4
        assert hook.rows[0]["value"] == meta["losses"][-1]
        assert set(meta) == {"losses", "updates", "tau_mean", "live_frac"}


@pytest.mark.parametrize("config", [
    {"arch": "stablelm-1.6b", "batch": 4, "reduced": True},
    {"b": [1, 2, {"c": None}], "a": 0.5},
    "precomputed-hash",
])
def test_bench_schema_matches_reference(tmp_path, config):
    assert TB.config_hash(config) == JB.config_hash(config)
    rows = [TB.bench_row("x/y", 1.5, "s", config, gate="lower", tol=0.1),
            TB.bench_row("x/z", 2, "count", config)]
    assert rows == [JB.bench_row("x/y", 1.5, "s", config, gate="lower", tol=0.1),
                    JB.bench_row("x/z", 2, "count", config)]
    path = TB.write_bench_json(str(tmp_path / "BENCH_t.json"), rows)
    assert JB.read_bench_json(path) == rows == TB.read_bench_json(path)
    for bad in ([{"name": "a", "value": True, "unit": "s", "config": "c"}],
                [{"name": "a", "value": 1.0, "unit": "s", "config": "c", "meta": {"gate": "up"}}],
                rows + rows[:1]):
        with pytest.raises(ValueError):
            TB.validate_rows(bad)
        with pytest.raises(ValueError):
            JB.validate_rows(bad)


# ---------------------------------------------------------------------------
# The launchers on the CPU
# ---------------------------------------------------------------------------

TRAIN = ["--reduced", "--batch", "2", "--seq", "16", "--async_psgd", "--workers", "4",
         "--ring", "4", "--refresh_every", "2", "--fuse", "--momentum", "0.9", "--device", "cpu"]


def test_train_launcher_checkpoint_and_resume(tmp_path, capsys):
    from repro_torch.launch import train

    ckpt = str(tmp_path / "ck")
    full = train.main(TRAIN + ["--steps", "5"])
    first = train.main(TRAIN + ["--steps", "3", "--checkpoint_dir", ckpt, "--checkpoint_every", "3"])
    assert latest_step(ckpt) == 3 and first.step == 3
    capsys.readouterr()
    resumed = train.main(TRAIN + ["--steps", "5", "--checkpoint_dir", ckpt, "--resume"])
    out = capsys.readouterr().out
    assert f"resuming at step 3 from {ckpt}" in out
    assert resumed.start_step == 3 and resumed.step == 5
    _assert_states_equal(full.state, resumed.state)
    assert resumed.history[-1]["loss"] == full.history[-1]["loss"]
    again = train.main(TRAIN + ["--steps", "3", "--checkpoint_dir", ckpt, "--resume"])
    assert "nothing to do: checkpoint already at step 3" in capsys.readouterr().out
    assert again.step == 3


@pytest.mark.parametrize("extra,message", [
    (["--resume"], "--resume requires --checkpoint_dir"),
    (["--checkpoint_every", "2"], "--checkpoint_every requires --checkpoint_dir"),
    (["--checkpoint_dir", "D"], "--checkpoint_dir does nothing without"),
])
def test_train_launcher_argument_errors(extra, message, capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit) as e:
        train.main(TRAIN + ["--steps", "2"] + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_train_launcher_resume_errors(tmp_path):
    from repro_torch.launch import train

    ckpt = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="no checkpoint found"):
        train.main(TRAIN + ["--steps", "2", "--checkpoint_dir", ckpt, "--resume"])
    train.main(TRAIN + ["--steps", "4", "--checkpoint_dir", ckpt, "--checkpoint_every", "4"])
    with pytest.raises(SystemExit, match="checkpoint is at step 4 but --steps is 2"):
        train.main(TRAIN + ["--steps", "2", "--checkpoint_dir", ckpt, "--resume"])


def test_serve_launcher_json_reads_back_in_the_reference(tmp_path):
    from repro_torch.launch import serve

    path = str(tmp_path / "BENCH_serve.json")
    result = serve.main(["--reduced", "--device", "cpu", "--prompt_len", "8", "--gen", "3",
                         "--batch", "2", "--json", path])
    rows = JB.read_bench_json(path)
    config = {"arch": "stablelm-1.6b", "batch": 2, "prompt_len": 8, "gen": 3, "reduced": True,
              "seed": 0}
    assert [r["name"] for r in rows] == ["serve/stablelm-1.6b/prefill_s",
                                         "serve/stablelm-1.6b/decode_s",
                                         "serve/stablelm-1.6b/tok_per_s"]
    assert [r["unit"] for r in rows] == ["s", "s", "tok/s"]
    assert all(r["config"] == JB.config_hash(config) for r in rows)
    assert rows[0]["value"] == result["prefill_s"] and rows[2]["value"] == result["tok_per_s"]
    with open(path) as f:
        assert json.load(f)["schema"] == "bench.v1"
