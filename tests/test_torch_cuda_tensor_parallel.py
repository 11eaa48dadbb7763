"""Dense tensor parallelism on the card: 2 gloo ranks sharing one card
(data 1 x model 2; NCCL refuses two ranks on one card) against one process
on the card, reduced stablelm-1.6b at d_model 64 in f32, the same params
and batch (``tests/torch_tp_common.py``).

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_tensor_parallel.py

It skips without a card.  Bounds: loss within 1e-6 relative and the gathered
gradient within 1e-5 of max |g| (the CPU test's); a 4-tick async fused run
(one ``fused_tick`` launch a tick on each rank) within 1e-5 of one
process's params, its tables and histograms equal; the serve on the flash
kernel (``use_pallas=True``, one launch a layer on each rank) within 1e-4
of one process's logits, ids equal.

The scan and RG-LRU kernels on a rank's channel block: reduced
falcon-mamba-7b and recurrentgemma-9b (``torch_tp_common.arch_config``)
served by 2 ranks on the kernels (``use_pallas=True``: the selective scan on
``(B, S, D_inner / 2)``, the RG-LRU on ``(B, S, W / 2)``, one launch a
layer on each rank) against one process on the card running their plain
versions: prefill and decode logits within 1e-4 + 1e-4 |plain|, ids equal.
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
    import dataclasses
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.data import make_batch_for
    from repro_torch.kernels.adaptive_update import cuda as AU
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.run import run
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.training import init_params
    from repro_torch.training.steps import _template

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import B, GEN, S, TICKS, Tables, async_spec, config  # noqa: E402


    def results(cfg, flat, mesh, draws):
        """Loss, gradient, async run and serve of one process (mesh None) or
        of this rank, every tensor on the card."""
        dev = torch.device("cuda")
        batch = make_batch_for(cfg, batch=B, seq=S, seed=0, device=dev)
        tmpl = _template(cfg, mesh)
        leaf = flat.clone().requires_grad_()
        loss, _ = M.loss_fn(T.flat_view(leaf, tmpl), batch, cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        hook = Tables()
        AU.reset_launches()
        state = run(async_spec(cfg, flat, draws, device="cuda"), hooks=[hook]).state
        ticks = AU.LAUNCHES["fused_tick"]
        scfg = dataclasses.replace(cfg, use_pallas=True)
        FA.reset_launches()
        with torch.no_grad():
            res = serve(scfg, T.flat_view(flat, tmpl), batch, gen=GEN)
        out = {"loss": loss.detach(), "grad": g, "params": state.params, "ticks": ticks,
               "flash": FA.LAUNCHES["flash_attention"], "prefill": res["prefill_logits"],
               "logits": res["logits"], "ids": res["tokens"]}
        if mesh is not None:
            out["grad"] = bridge.gather_params(g, cfg, mesh)
            out["params"] = bridge.gather_params(state.params, cfg, mesh)
        out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        out.update({f"adapt_{k}": v for k, v in {k: np.asarray(v) for k, v in
                                                hook.arrays().items()}.items()})
        return out


    def worker(rank, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=2)
        mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
        torch.cuda.set_device(mesh.device)
        cfg = config("mha")
        with use_sharding_rules(mesh):
            flat = T.pack_flat(init_params(0, cfg, "cuda"))
            out = results(cfg, flat, mesh, np.load(f"{tmp}/draws.npy"))
        np.savez(f"{tmp}/rank_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        draws = np.random.default_rng(0).random((TICKS, 4)).astype(np.float32)
        np.save(f"{tmp}/draws.npy", draws)
        cfg = config("mha")
        flat = T.pack_flat(init_params(0, cfg, "cuda"))
        np.savez(f"{tmp}/one.npz", **results(cfg, flat, None, draws))
        torch.multiprocessing.spawn(worker, args=(tmp,), nprocs=2, join=True)
        print("OK tensor parallel on the card")
''')


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    script = tmp_path / "tp_cuda_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path), os.path.join(ROOT, "tests")],
                          env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = dict(np.load(tmp_path / "one.npz"))
    layers = 2
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank_{r}.npz"))
        np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), rtol=1e-6)
        assert np.abs(got["grad"] - one["grad"]).max() <= 1e-5 * np.abs(one["grad"]).max()
        assert np.abs(got["params"] - one["params"]).max() <= 1e-5
        for k in ("adapt_tables", "adapt_cdfs", "adapt_hists"):
            np.testing.assert_array_equal(got[k], one[k])
        assert int(got["ticks"]) == int(one["ticks"]) == 4
        assert int(got["flash"]) == int(one["flash"]) == layers
        v_loc = got["prefill"].shape[-1]
        np.testing.assert_allclose(got["prefill"], one["prefill"][:, r * v_loc:(r + 1) * v_loc],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["logits"], one["logits"][..., r * v_loc:(r + 1) * v_loc],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["ids"], one["ids"])


_BLOCK_WORKER = textwrap.dedent('''
    import dataclasses
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data import make_batch_for
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.training import init_params

    sys.path.insert(0, sys.argv[2])  # the tests directory
    from torch_tp_common import B, GEN, S, arch_config  # noqa: E402


    def results(arch, use_pallas, mesh=None):
        cfg = dataclasses.replace(arch_config(arch), use_pallas=use_pallas)
        params = init_params(0, cfg, "cuda")
        batch = make_batch_for(cfg, batch=B, seq=S, seed=0, device="cuda")
        SS.reset_launches()
        RG.reset_launches()
        with torch.no_grad():
            res = serve(cfg, params, batch, gen=GEN)
        out = {k: res[k].cpu().numpy() for k in ("prefill_logits", "logits", "tokens")}
        out["launches"] = SS.LAUNCHES["selective_scan"] + RG.LAUNCHES["rg_lru"]
        return out


    def worker(rank, tmp, arch):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{arch}", rank=rank,
                                world_size=2)
        mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
        torch.cuda.set_device(mesh.device)
        with use_sharding_rules(mesh):
            np.savez(f"{tmp}/{arch}_rank_{rank}.npz", **results(arch, True, mesh))
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp, arch = sys.argv[1], sys.argv[3]
        np.savez(f"{tmp}/{arch}_one.npz", **results(arch, False))
        torch.multiprocessing.spawn(worker, args=(tmp, arch), nprocs=2, join=True)
        print("OK channel blocks on the card")
''')


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", 2), ("recurrentgemma-9b", 3)])
def test_scan_and_rg_lru_kernels_on_a_ranks_channel_block(tmp_path, arch, layers):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    script = tmp_path / "tp_block_worker.py"
    script.write_text(_BLOCK_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path), os.path.join(ROOT, "tests"),
                           arch], env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = dict(np.load(tmp_path / f"{arch}_one.npz"))
    assert int(one["launches"]) == 0  # the plain versions
    for r in range(2):
        got = dict(np.load(tmp_path / f"{arch}_rank_{r}.npz"))
        assert int(got["launches"]) == layers  # one a recurrent layer's prefill
        for k in ("prefill_logits", "logits"):
            v_loc = got[k].shape[-1]
            np.testing.assert_allclose(got[k], one[k][..., r * v_loc:(r + 1) * v_loc],
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["tokens"], one["tokens"])
