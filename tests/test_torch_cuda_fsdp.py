"""FSDP storage over ``data`` on the card: 2 gloo ranks sharing one card
(data 2 x model 1), reduced stablelm-1.6b at d_model 64 in f32
(``tests/torch_tp_common.py``), 4 fused async ticks (one ``fused_tick``
launch a tick on each rank, on its ``N_local``) with the same params and
uniforms:

* against the replicated layout (``replicate_params_over_data``) on the
  same two ranks: params, momentum and ring bits of each rank's FSDP blocks
  and the losses bitwise equal (with two data ranks every gradient element
  is ``a + b`` in both layouts);
* against one process on the card: losses within 1e-6 relative, the
  gathered params within 1e-5 (the CPU tests' bounds), tables and
  histograms equal.

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_fsdp.py

It skips without a card.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.kernels.adaptive_update import cuda as AU
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import transform as T
    from repro_torch.run import run
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS, localize
    from repro_torch.training import init_params
    from repro_torch.training.steps import param_template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import TICKS, Tables, async_spec, config, digest  # noqa: E402


    def ticks(cfg, flat, draws):
        """4 fused async ticks on the card: (state, tables, fused_tick launches)."""
        hook = Tables()
        AU.reset_launches()
        state = run(async_spec(cfg, flat, draws, device="cuda"), hooks=[hook]).state
        torch.cuda.synchronize()
        return state, hook.arrays(), AU.LAUNCHES["fused_tick"]


    def cut(t, cfg, mesh):
        """The FSDP blocks of a flat tensor (..., N) over the whole params."""
        rows = [T.pack_flat(localize(T.flat_view(r, param_template(cfg)), cfg, mesh))
                for r in t.reshape(-1, t.shape[-1])]
        return torch.stack(rows).reshape(tuple(t.shape[:-1]) + (-1,))


    def leaves(state):
        return [state.params, state.opt_state["bufs"], state.delayed.ring]


    def worker(rank, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=2)
        mesh = make_mesh((2, 1), ("data", "model"), device="cuda")
        torch.cuda.set_device(mesh.device)
        cfg = config("mha")
        draws = np.load(f"{tmp}/draws.npy")
        whole = torch.from_numpy(np.load(f"{tmp}/flat.npy")).cuda()
        out = {}
        with use_sharding_rules(mesh):
            local = T.pack_flat(localize(T.flat_view(whole, param_template(cfg)), cfg, mesh))
            state, tables, n = ticks(cfg, local, draws)
            out.update({f"fsdp_{k}": v for k, v in tables.items()})
            out["fsdp_ticks"], out["n_local"] = n, state.params.numel()
            out["fsdp_bits"] = np.array([digest(t.cpu()) for t in leaves(state)])
            out["params"] = bridge.gather_params(state.params, cfg, mesh).cpu().numpy()
            SPEC_OPTIONS["replicate_params_over_data"] = True
            try:
                state, tables, n = ticks(cfg, whole, draws)
            finally:
                SPEC_OPTIONS["replicate_params_over_data"] = False
            out.update({f"repl_{k}": v for k, v in tables.items()})
            out["repl_ticks"] = n
            out["repl_bits"] = np.array([digest(cut(t, cfg, mesh).cpu()) for t in leaves(state)])
        np.savez(f"{tmp}/rank_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        draws = np.random.default_rng(0).random((TICKS, 4)).astype(np.float32)
        np.save(f"{tmp}/draws.npy", draws)
        cfg = config("mha")
        flat = T.pack_flat(init_params(0, cfg, "cuda"))
        np.save(f"{tmp}/flat.npy", flat.cpu().numpy())
        state, tables, n = ticks(cfg, flat, draws)
        np.savez(f"{tmp}/one.npz", params=state.params.cpu().numpy(), ticks=n, **tables)
        torch.multiprocessing.spawn(worker, args=(tmp,), nprocs=2, join=True)
        print("OK fsdp on the card")
''')


@pytest.mark.cuda
def test_fsdp_ranks_match_the_replicated_layout_and_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    script = tmp_path / "fsdp_cuda_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path), os.path.join(ROOT, "tests")],
                          env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = dict(np.load(tmp_path / "one.npz"))
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank_{r}.npz"))
        assert int(got["fsdp_ticks"]) == int(got["repl_ticks"]) == int(one["ticks"]) == 4
        assert int(got["n_local"]) < one["params"].shape[0]
        np.testing.assert_array_equal(got["fsdp_bits"], got["repl_bits"])
        np.testing.assert_array_equal(got["fsdp_losses"], got["repl_losses"])
        np.testing.assert_allclose(got["fsdp_losses"], one["losses"], rtol=1e-6)
        assert np.abs(got["params"] - one["params"]).max() <= 1e-5
        for k in ("tables", "hists"):
            np.testing.assert_array_equal(got[f"fsdp_{k}"], one[k])
