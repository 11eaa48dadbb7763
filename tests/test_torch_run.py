"""The slice as a whole: the port's main path,
``run(RunSpec(mode="async", fuse=True, num_workers=4, ring=4,
refresh_every=3))``, against the reference run on the same params, batches
and taus, tick by tick for 6 ticks (two host refreshes), on reduced
stablelm-1.6b.

The taus are the same because the port is handed the reference's own
uniforms: the test replays the reference's ``jax.random.split`` /
``uniform`` sequence and feeds the draws through ``RunSpec.tau_source``.

Tolerances, each with its reason:
* taus, ``tau_mean`` and ``alpha_mean``: exactly equal (same uniforms, same
  f32 CDF and alpha tables);
* alpha table after each refresh: exactly equal (same histogram, float64
  refit in both packages);
* loss: 1e-6 relative (f32 round-off of matmul/reduction order; measured
  7e-8);
* params and ring: 1e-6 absolute (the flat gradient agrees to ~1e-6 of its
  max, scaled by the step size and carried over 6 ticks; measured 1.8e-7
  and 3e-7).

Also here: the port's files import no JAX and nothing of the JAX package,
the launcher runs on the CPU, and ``chip_smoke.py`` refuses to run without
a card.
"""

import ast
import os
import pathlib
import subprocess
import sys

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
from repro.training import default_adapt_setup as j_adapt_setup
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.optim import transform as TT
from repro_torch.run import Hook, RunSpec, run
from repro_torch.training import default_adapt_setup

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, K, LR, STEPS = 4, 4, 0.05, 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _JRec(JHook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m = ctx.metrics
        self.rows.append(dict(
            loss=float(m["loss"]), tau=float(m["tau_mean"]), alpha=float(m["alpha_mean"]),
            p=np.array(ctx.state.params), ring=np.array(ctx.state.delayed.ring),
            table=np.array(ctx.state.adapt.alpha_table),
        ))


class _TRec(Hook):
    def __init__(self):
        self.rows = []

    def on_tick(self, ctx):
        m, s = ctx.metrics, ctx.state
        self.rows.append(dict(
            loss=m["loss"].item(), tau=m["tau_mean"].item(), alpha=m["alpha_mean"].item(),
            p=s.params.numpy().copy(), ring=s.delayed.ring.numpy().copy(),
            table=s.adapt.alpha_table.numpy().copy(),
        ))


@pytest.fixture(scope="module")
def trajectories():
    cfg = j_reduced(j_get_config("stablelm-1.6b"))
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    sched, _, adapt = j_adapt_setup(LR, W, K)
    pipe = JT.chain(JT.scale_by_staleness(sched, LR, m=W, tau_max=adapt.tau_max),
                    JT.scale(-LR), JT.trace(0.9))
    jrec = _JRec()
    j_run(JSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=STEPS, batch_size=2, seq_len=32,
                num_workers=W, ring=K, adapt=adapt, fuse=True, refresh_every=3, params=params,
                seed=0), hooks=[jrec])

    # the reference's draws: state.rng = split(PRNGKey(seed))[1]; per tick
    # rng, sub = split(rng); u = uniform(sub, (W,))
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    draws = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    it = iter(draws)

    tcfg = reduced(get_config("stablelm-1.6b"))
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    tsched, _, tadapt = default_adapt_setup(LR, W, K, device="cpu")
    tpipe = TT.chain(TT.scale_by_staleness(tsched, LR, m=W, tau_max=tadapt.tau_max),
                     TT.scale(-LR), TT.trace(0.9))
    trec = _TRec()
    result = run(RunSpec(cfg=tcfg, pipeline=tpipe, mode="async", num_steps=STEPS, batch_size=2,
                         seq_len=32, num_workers=W, ring=K, adapt=tadapt, fuse=True,
                         refresh_every=3, params=flat, seed=0, device="cpu",
                         tau_source=lambda: torch.from_numpy(next(it))), hooks=[trec])
    return jrec.rows, trec.rows, result, flat, tadapt


def test_async_fused_run_matches_reference_tick_by_tick(trajectories):
    jrows, trows, result, _, _ = trajectories
    assert len(jrows) == len(trows) == STEPS and result.step == STEPS
    for i, (a, b) in enumerate(zip(jrows, trows)):
        assert a["tau"] == b["tau"] and a["alpha"] == b["alpha"], f"tick {i + 1}"
        np.testing.assert_array_equal(a["table"], b["table"], err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6, err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-6, err_msg=f"tick {i + 1}")
        np.testing.assert_allclose(b["ring"], a["ring"], rtol=0, atol=1e-6, err_msg=f"tick {i + 1}")
    # the params moved, and the refreshes changed the table
    assert np.abs(trows[-1]["p"] - trows[0]["p"]).max() > 1e-3
    assert not np.array_equal(trows[0]["table"], trows[-1]["table"])


def test_run_leaves_spec_tensors_alone(trajectories):
    """The fused tick works in place; the engine copies what it takes from
    the spec, so ``spec.params`` and ``spec.adapt`` are untouched."""
    _, trows, result, flat, tadapt = trajectories
    assert result.state.params.data_ptr() != flat.data_ptr()
    assert int(tadapt.hist.sum()) == 0
    assert int(result.state.adapt.hist.sum()) == 0  # drained at tick 6
    assert int(result.state.step) == STEPS and int(result.state.delayed.step) == STEPS


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main

    result = main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "16", "--async_psgd",
                   "--workers", "4", "--ring", "4", "--fuse", "--momentum", "0.9",
                   "--refresh_every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and "online estimator" in out
    assert np.isfinite(result.history[-1]["loss"])


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        bad = {m for m in _imports(f)
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
