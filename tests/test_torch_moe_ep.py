"""Port parity, the sharded MoE: ``apply_moe``'s expert-parallel and
weights-stationary branches (the reference's ``shard_map`` branches,
``src/repro/models/moe.py:149-236``) run as gloo processes on the CPU.

The config is the reference's own variant for this check
(``tests/test_perf_variants.py``): reduced qwen2-moe-a2.7b with 4 experts,
top-2, d_ff_expert 256 and its shared expert; x is (4, 8, D) from numpy, the
params the reference's, carried over as numpy.  Three layouts:

* ``ep-1x2``: expert-parallel, data 1 x model 2 (2 processes, 2 experts each);
* ``ep-2x2``: expert-parallel, data 2 x model 2 (each rank its 2 batch rows);
* ``ws-2x2``: weights-stationary, data 2 x model 2 (d_ff also over data;
  tokens gathered over data).

Bounds, each with its reason:
* against the port's one-process ``apply_moe``: 1e-6 relative to max |out|
  (the cross-rank sum changes the order of the top-k sum), every model rank
  of a data group bitwise equal (one all-reduce result);
* against the reference's single-device ``apply_moe``: 1e-5 absolute, the
  bound of ``tests/test_torch_moe.py``;
* routes: each rank's top-k expert ids equal the one-process ids of the
  tokens it routes (its own rows; all rows when weights-stationary);
* aux: the mean over ranks of each rank's aux.  A rank routes its own rows
  (expert-parallel) or every row (weights-stationary), so at data 1 and when
  weights-stationary it is the one-process aux, and at ep-2x2 the mean of
  the one-process aux of each data shard; 1e-6 relative;
* gradients: every rank's, with the leaves replicated over data summed over
  data, equal its block of the one-process gradient within 1e-5 of each
  leaf's max |g| (``test_sharded_moe_gradient_matches_one_process``).
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

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import moe as JMOE
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as TMOE
from repro_torch.sharding import use_sharding_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPD = dict(num_experts=4, num_experts_padded=4, top_k=2, d_ff_expert=256)
AUX_W = 0.5  # the weight of aux in the gradient check's loss
LAYOUTS = {  # name -> (data, model, weights-stationary)
    "ep-1x2": (1, 2, False),
    "ep-2x2": (2, 2, False),
    "ws-2x2": (2, 2, True),
}

_WORKER = textwrap.dedent('''
    import dataclasses
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import use_sharding_rules

    UPD = dict(num_experts=4, num_experts_padded=4, top_k=2, d_ff_expert=256)
    AUX_W = 0.5


    def worker(rank, world, data, model, stationary, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{world}_{stationary}",
                                rank=rank, world_size=world)
        cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), **UPD,
                                  moe_weights_stationary=stationary)
        mesh = make_mesh((data, model), ("data", "model"), device="cpu")
        params = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/params.npz").items()}
        p = {k: v for k, v in params.items() if not k.startswith("shared.")}
        p["shared"] = {k[7:]: v for k, v in params.items() if k.startswith("shared.")}
        x = torch.from_numpy(np.load(f"{tmp}/x.npy"))
        rows = x.shape[0] // data
        d = mesh.index("data")
        local = MOE.local_expert_params(p, cfg, mesh)
        routes = []
        inner = MOE.route

        def keep(*args):
            out = inner(*args)
            routes.append(out[2].clone())
            return out

        MOE.route = keep
        with torch.no_grad(), use_sharding_rules(mesh):
            out, aux = MOE.apply_moe(local, x[d * rows:(d + 1) * rows], cfg)
        MOE.route = inner
        np.savez(f"{tmp}/out_{world}_{stationary}_{rank}.npz", out=out.numpy(),
                 aux=aux.numpy(), ids=routes[0].numpy(), data=d, model=mesh.index("model"),
                 w_up_e=np.array(local["w_up_e"].shape), w_down_e=np.array(local["w_down_e"].shape),
                 bytes=np.array([MOE.COLLECTIVE_BYTES[k] for k in ("combine", "gather", "aux")]))

        # the gradient of this group's loss <out, r_rows> + AUX_W aux; the
        # leaves replicated over data are then summed over data, as the
        # caller of a data-parallel step does
        MOE.reset_collective_bytes()
        r = torch.from_numpy(np.load(f"{tmp}/r.npy"))[d * rows:(d + 1) * rows]
        lp = {k: v.detach().clone().requires_grad_() for k, v in local.items() if k != "shared"}
        lp["shared"] = {k: v.detach().clone().requires_grad_() for k, v in local["shared"].items()}
        xl = x[d * rows:(d + 1) * rows].clone().requires_grad_()
        with use_sharding_rules(mesh):
            out, aux = MOE.apply_moe(lp, xl, cfg)
        ((out * r).sum() + AUX_W * aux).backward()
        grads = {k: v.grad for k, v in lp.items() if k != "shared"}
        grads.update({f"shared.{k}": v.grad for k, v in lp["shared"].items()})
        for k, g in grads.items():
            if data > 1 and not (stationary and k.endswith("_e")):
                dist.all_reduce(g, group=mesh.group("data"))
        np.savez(f"{tmp}/grad_{world}_{stationary}_{rank}.npz", x=xl.grad.numpy(),
                 backward_bytes=MOE.COLLECTIVE_BYTES["backward"],
                 **{k: g.numpy() for k, g in grads.items()})
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for data, model, stationary in ((1, 2, False), (2, 2, False), (2, 2, True)):
            torch.multiprocessing.spawn(worker, args=(data * model, data, model, stationary, tmp),
                                        nprocs=data * model, join=True)
        print("OK sharded MoE")
''')


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reference params and x, the one-process results of both packages, and
    every rank's output of the three layouts (one subprocess)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen2-moe-a2.7b")), **UPD)
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in jp.items() if k != "shared"}
    flat.update({f"shared.{k}": np.asarray(v) for k, v in jp["shared"].items()})
    np.savez(tmp / "params.npz", **flat)
    x = np.random.default_rng(1).normal(size=(4, 8, jcfg.d_model)).astype(np.float32)
    np.save(tmp / "x.npy", x)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    np.save(tmp / "r.npy", r)
    jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)

    tcfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), **UPD)
    tp = {k: torch.from_numpy(v.copy()) for k, v in flat.items() if not k.startswith("shared.")}
    tp["shared"] = {k[7:]: torch.from_numpy(v.copy()) for k, v in flat.items()
                  if k.startswith("shared.")}
    ids = []
    inner = TMOE.route

    def keep(*args):
        out = inner(*args)
        ids.append(out[2])
        return out

    TMOE.route = keep
    try:
        with torch.no_grad():
            tout, taux = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
            half_aux = [float(TMOE.apply_moe(tp, torch.from_numpy(x[2 * i:2 * i + 2]), tcfg)[1])
                        for i in range(2)]
    finally:
        TMOE.route = inner

    script = tmp / "moe_ep_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp)], env=env, cwd=str(tmp),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK sharded MoE" in proc.stdout
    ranks, grads = {}, {}
    for name, (data, model, stationary) in LAYOUTS.items():
        ranks[name] = [dict(np.load(tmp / f"out_{data * model}_{stationary}_{r}.npz"))
                       for r in range(data * model)]
        grads[name] = [dict(np.load(tmp / f"grad_{data * model}_{stationary}_{r}.npz"))
                       for r in range(data * model)]
    return dict(x=x, r=r, flat=flat, jout=np.asarray(jout), jaux=float(jaux), tout=tout.numpy(),
                taux=float(taux), half_aux=half_aux, ids=ids[0].numpy(), ranks=ranks,
                grads=grads, tcfg=tcfg)


def _gathered(ranks, data):
    """The layout's output rows in batch order (model rank 0 of each data
    group), after checking that every model rank holds the same rows."""
    rows = []
    for d in range(data):
        group = [r for r in ranks if int(r["data"]) == d]
        for r in group[1:]:
            np.testing.assert_array_equal(r["out"], group[0]["out"])
        rows.append(group[0]["out"])
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_moe_matches_one_process(runs, name):
    data = LAYOUTS[name][0]
    got = _gathered(runs["ranks"][name], data)
    want = runs["tout"]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_moe_matches_reference(runs, name):
    got = _gathered(runs["ranks"][name], LAYOUTS[name][0])
    np.testing.assert_allclose(got, runs["jout"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_moe_routes_and_aux(runs, name):
    data, model, stationary = LAYOUTS[name]
    ids = runs["ids"].reshape(4, 8, -1)
    rows = 4 // data
    for r in runs["ranks"][name]:
        d = int(r["data"])
        want = ids if stationary else ids[d * rows:(d + 1) * rows]
        np.testing.assert_array_equal(r["ids"], want.reshape(-1, want.shape[-1]))
    want_aux = np.mean(runs["half_aux"]) if (data > 1 and not stationary) else runs["taux"]
    for r in runs["ranks"][name]:
        np.testing.assert_allclose(float(r["aux"]), want_aux, rtol=1e-6)
    if data == 1 or stationary:
        np.testing.assert_allclose(float(r["aux"]), runs["jaux"], rtol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_local_expert_blocks_and_collective_bytes(runs, name):
    """Each rank holds E / n_model experts (and d_ff / n_data when
    weights-stationary); the all-reduces moved the sizes the layout implies:
    the (T_loc, D) combine, the (n_data, T_loc, D) gather when
    weights-stationary, and one f32 for aux."""
    data, model, stationary = LAYOUTS[name]
    cfg = runs["tcfg"]
    E, D, F = cfg.experts_padded, cfg.d_model, cfg.d_ff_expert
    f_loc = F // data if stationary else F
    t_loc = 4 * 8 // data
    for r in runs["ranks"][name]:
        assert tuple(r["w_up_e"]) == (E // model, D, f_loc)
        assert tuple(r["w_down_e"]) == (E // model, f_loc, D)
        combine = (data * t_loc if stationary else t_loc) * D * 4
        gather = data * t_loc * D * 4 if stationary else 0
        assert tuple(r["bytes"]) == (combine, gather, 4)


def _one_process_grads(runs, data, stationary):
    """The one-process gradient of the sum over data groups of each group's
    loss ``<out_d, r_d> + AUX_W aux``.  A weights-stationary rank routes
    every row, so its aux is the one-process aux of the whole batch; an
    expert-parallel rank routes its group's rows, and aux is the mean over
    groups of the one-process aux of each group's rows."""
    cfg, flat = runs["tcfg"], runs["flat"]
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in flat.items()}
    p = {k: v for k, v in leaves.items() if not k.startswith("shared.")}
    p["shared"] = {k[7:]: v for k, v in leaves.items() if k.startswith("shared.")}
    x = torch.from_numpy(runs["x"]).requires_grad_()
    r = torch.from_numpy(runs["r"])
    if stationary:
        out, aux = TMOE.apply_moe(p, x, cfg)
        loss = (out * r).sum() + data * AUX_W * aux
    else:
        rows = x.shape[0] // data
        parts = [TMOE.apply_moe(p, x[d * rows:(d + 1) * rows], cfg) for d in range(data)]
        auxes = torch.stack([a for _, a in parts])
        loss = sum((o * r[d * rows:(d + 1) * rows]).sum() for d, (o, _) in enumerate(parts))
        loss = loss + data * AUX_W * auxes.mean()
    loss.backward()
    return {"x": x.grad.numpy(), **{k: v.grad.numpy() for k, v in leaves.items()}}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_moe_gradient_matches_one_process(runs, name):
    """Every rank's gradient, once the leaves replicated over data are summed
    over data (the data-parallel step's sum), is its block of the
    one-process gradient (``_one_process_grads``): x its rows, the expert
    stacks its experts (and its d_ff slice when weights-stationary), router
    and shared expert whole.  Bound: 1e-5 of the leaf's max |g|, the
    gradient contract of ``tests/test_torch_grad_parity.py`` (the cross-rank
    sums change the order of the sums).  The backward's all-reduces moved
    what the collectives imply: the router and the (gathered) tokens over
    model, plus, when weights-stationary, the combine's and the gather's
    (n_data, T_loc, D) cotangents over data, and aux's one f32."""
    data, model, stationary = LAYOUTS[name]
    cfg = runs["tcfg"]
    want = _one_process_grads(runs, data, stationary)
    E, D, F = cfg.experts_padded, cfg.d_model, cfg.d_ff_expert
    e_loc, f_loc, rows = E // model, (F // data if stationary else F), 4 // data
    t_loc = rows * 8
    for rank, g in enumerate(runs["grads"][name]):
        d, m = divmod(rank, model)
        f0 = d * f_loc if stationary else 0
        blocks = {
            "x": want["x"][d * rows:(d + 1) * rows],
            "w_gate_e": want["w_gate_e"][m * e_loc:(m + 1) * e_loc, :, f0:f0 + f_loc],
            "w_up_e": want["w_up_e"][m * e_loc:(m + 1) * e_loc, :, f0:f0 + f_loc],
            "w_down_e": want["w_down_e"][m * e_loc:(m + 1) * e_loc, f0:f0 + f_loc, :],
        }
        for k in want:
            w = blocks.get(k, want[k])
            err = np.abs(g[k] - w).max()
            assert err <= 1e-5 * np.abs(want[k]).max(), (rank, k, err)
        tokens = (data * t_loc if stationary else t_loc) * D * 4
        back = D * E * 4 + tokens + (2 * tokens if stationary else 0) + 4
        assert int(g["backward_bytes"]) == back


def test_one_process_layout_takes_the_one_device_path():
    """A layout with no running processes (planning) leaves ``apply_moe`` on
    its one-device path, bitwise."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), **UPD)
    gen = torch.Generator().manual_seed(0)
    p = TMOE.init_moe(gen, cfg, "cpu")
    x = torch.randn(2, 4, cfg.d_model, generator=gen)
    want = TMOE.apply_moe(p, x, cfg)
    with use_sharding_rules(make_mesh((2, 2), ("data", "model"), device="cpu")):
        got = TMOE.apply_moe(p, x, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
