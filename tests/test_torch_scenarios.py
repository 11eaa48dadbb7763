"""The port's scenario matrix (``repro_torch.launch.scenarios``) against the
reference's ``repro.launch.scenarios``, on the CPU.

* the per-worker sampler tables of every staleness family and the step-size
  table of every strategy are exactly the reference's (numpy in both);
* one smoke cell per ported arch (3 steps, d_model 64) writes schema-valid
  bench.v1 rows with the reference's names and config hashes (no retrace
  row: the port runs eagerly);
* the training loss and gradient of each arch's reduced cell model equal
  the reference's to f32 round-off (loss 1e-6 relative, gradient 1e-6 of
  its largest element; measured 2.2e-7 / 9.1e-7 for recurrentgemma-9b,
  whose training the port had not been held to before);
* the same sgd cell from the reference's initial params and uniforms gives
  the reference's loss series to 1e-5 relative.  (An adam cell is not
  compared tick by tick: adam's first update is ``lr * g / (|g| + eps)``, so
  the gradient elements below ~1e-7 — 23 of recurrentgemma's 494,400 —
  take a ±lr step whose sign is f32 round-off.)
* an arch the port does not run is refused by name.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.bench_schema import bench_row as j_bench_row
from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import make_batch_for as j_make_batch_for
from repro.launch import scenarios as JSC
from repro.models import model as JM
from repro.training import init_params as j_init_params
from repro.training.adapt import worker_sampler_tables as j_tables
from repro_torch import bench_schema as TB
from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch import scenarios as TSC
from repro_torch.models import model as TM
from repro_torch.optim import transform as T
from repro_torch.training import param_template
from repro_torch.training.adapt import worker_sampler_tables as t_tables

ARCHS = ("stablelm-1.6b", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cells(**kw):
    return JSC.ScenarioCell(**kw), TSC.ScenarioCell(**kw)


@pytest.mark.parametrize("family", TSC.STALENESS_FAMILIES)
def test_worker_models_match_reference(family):
    jc, tc = _cells(arch="stablelm-1.6b", staleness=family, strategy="eq26", workers=6, ring=8)
    for a, b in zip(j_tables(JSC.worker_models(jc), support=8),
                    t_tables(TSC.worker_models(tc), support=8)):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("strategy", TSC.STRATEGY_CHOICES)
def test_cell_schedule_matches_reference(strategy):
    jc, tc = _cells(arch="stablelm-1.6b", staleness="poisson", strategy=strategy)
    np.testing.assert_array_equal(TSC.cell_schedule(tc).table, JSC.cell_schedule(jc).table)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_writes_schema_valid_rows(arch, tmp_path):
    out = str(tmp_path / "BENCH_scenarios.json")
    TSC.run_matrix([TSC.ScenarioCell(arch=arch, staleness=s, strategy="eq26", optim=o, steps=3,
                                     d_model=64)
                    for s in ("geometric", "trace") for o in ("sgd", "adam")], out, device="cpu")
    rows = TB.read_bench_json(out)  # validates the schema
    cells = {r["name"].rsplit("/", 1)[0] for r in rows}
    assert cells == {f"scenarios/{arch}/{s}/eq26/{o}" for s in ("geometric", "trace")
                     for o in ("sgd", "adam")}
    for cell in cells:
        names = {r["name"] for r in rows if r["name"].startswith(cell + "/")}
        assert names == {f"{cell}/final_loss", f"{cell}/wall_s"}
    for r in rows:
        if r["name"].endswith("/final_loss"):
            assert np.isfinite(r["value"]) and len(r["meta"]["losses"]) == 3
            _, staleness, _, optim, _ = r["name"].split("/")[1:]
            jc, _ = _cells(arch=arch, staleness=staleness, strategy="eq26", optim=optim, steps=3,
                           d_model=64)
            assert r["config"] == j_bench_row("x", 0.0, "s", jc.config())["config"]


def _reference_draws(W, steps, seed=0):
    _, rng = jax.random.split(jax.random.PRNGKey(seed))
    draws = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (W,))))
    return draws


def _bridged_params(arch, seed=0):
    jcfg = j_reduced(j_get_config(arch), d_model=64)
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)},
                                     reduced(get_config(arch), d_model=64))
    return jcfg, params, flat


@pytest.mark.parametrize("arch", ARCHS)
def test_training_loss_and_gradient_match_reference(arch):
    jcfg, params, flat = _bridged_params(arch)
    jb = j_make_batch_for(jcfg, batch=2, seq=16, seed=0)
    (jl, _), jg = jax.value_and_grad(lambda p: JM.loss_fn(p, jb, jcfg), has_aux=True)(params)
    jg = np.asarray(ravel_pytree(jg)[0])
    tcfg = reduced(get_config(arch), d_model=64)
    leaf = flat.clone().requires_grad_(True)
    tl, _ = TM.loss_fn(T.flat_view(leaf, param_template(tcfg)),
                       make_batch_for(tcfg, batch=2, seq=16, seed=0), tcfg)
    (tg,) = torch.autograd.grad(tl, leaf)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_losses_match_reference(arch):
    kw = dict(arch=arch, staleness="trace", strategy="eq26", optim="sgd", steps=4, d_model=64)
    jc, tc = _cells(**kw)
    jrows = JSC.run_cell(jc)
    _, _, flat = _bridged_params(arch, jc.seed)
    it = iter(_reference_draws(tc.workers, tc.steps))
    trows = TSC.run_cell(tc, device="cpu", params=flat,
                         tau_source=lambda: torch.from_numpy(next(it)))
    jl, tl = jrows[0]["meta"]["losses"], trows[0]["meta"]["losses"]
    assert len(tl) == len(jl) == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert trows[0]["meta"]["tau_mean"] == jrows[0]["meta"]["tau_mean"]
    assert trows[0]["config"] == jrows[0]["config"]


def test_unported_arch_is_refused(capsys):
    with pytest.raises(SystemExit):
        TSC.main(["--archs", "qwen2-moe-a2.7b", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "qwen2-moe-a2.7b" in err and "not ported" in err
    assert all(a in err for a in ASSIGNED_ARCHS)
