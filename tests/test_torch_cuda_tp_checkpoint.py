"""Checkpoint and resume of multi-process states on the card: 2 gloo ranks
sharing one card (NCCL refuses two ranks on one card), full-width
stablelm-1.6b at 2 layers.

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_tp_checkpoint.py

It skips without a card.  Two runs, each a 2-rank group saving at step 3
(``CheckpointHook``) and a second group resuming there with
``resume_step=3``, across a refresh:

* the sharded engine (``mode="sharded_async"``, ``make_workers_mesh(2)``):
  phase 9's W 2 x K 4 bf16 rings, one worker a rank, 6 ticks, a refresh
  every 4; every apply one ``fused_chain`` launch (6, then 3);
* tensor parallelism at data 1 x model 2: phase 3's fused async run (W =
  K = 8, bf16 ring) for 4 ticks, a refresh every 2; one ``fused_tick``
  launch a tick on each rank's blocks (4, then 1).

Gates: on each rank the resumed losses and every leaf of the final state
bit for bit those of the run that was not interrupted (SHA-256 of each
leaf's bits); the checkpoint on disk the one-process layout (a ``(2, 4,
N)`` ring, a flat ``(N,)`` params); the launch counts above.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent('''
    import dataclasses
    import hashlib
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import key_paths
    from repro_torch.configs import get_config
    from repro_torch.core.staleness import Geometric
    from repro_torch.kernels.adaptive_update import cuda as AU
    from repro_torch.launch.mesh import make_mesh, make_workers_mesh
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, Hook, RunSpec, run
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.training import default_adapt_setup, make_worker_adapt

    LR = 0.01


    class Losses(Hook):
        def __init__(self):
            self.losses = []

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())


    def digests(state):
        out = {}
        for k, v in key_paths(state):
            t = v.get_state() if isinstance(v, torch.Generator) else v.detach().contiguous()
            b = t.reshape(-1).view(torch.uint8).cpu().numpy()
            out[k] = hashlib.sha256(b.tobytes()).hexdigest()
        return out


    def cfg2():
        return dataclasses.replace(get_config("stablelm-1.6b"), num_layers=2)


    def sharded_spec(mesh):
        sched, _, adapt = default_adapt_setup(LR, 2, 4, device="cpu")
        wadapt = make_worker_adapt(sched.table[:adapt.tau_max + 1],
                                   [Geometric(p=1.0 / 3.0), Geometric(p=0.5)], cdf_support=4)
        link = T.scale_by_staleness(sched, LR, m=2, tau_max=adapt.tau_max)
        return RunSpec(cfg=cfg2(), pipeline=T.chain(link, T.scale(-LR), T.trace(0.9)),
                       mode="sharded_async", num_steps=6, batch_size=2, seq_len=128, ring=4,
                       ring_dtype="bfloat16", adapt=wadapt, fuse=True, refresh_every=4, seed=0,
                       device="cuda", mesh=mesh)


    def tp_spec():
        sched, _, adapt = default_adapt_setup(LR, 8, 8, device="cpu")
        link = T.scale_by_staleness(sched, LR, m=8, tau_max=adapt.tau_max)
        return RunSpec(cfg=cfg2(), pipeline=T.chain(link, T.scale(-LR), T.trace(0.9)),
                       mode="async", num_steps=4, batch_size=2, seq_len=128, num_workers=8,
                       ring=8, ring_dtype="bfloat16", adapt=adapt, fuse=True, refresh_every=2,
                       seed=0, device="cuda")


    def group(rank, what, part, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{what}_{part}",
                                rank=rank, world_size=2)
        directory = f"{tmp}/ck_{what}"
        hook = Losses()
        AU.reset_launches()
        if what == "sharded":
            mesh = make_workers_mesh(2, device="cuda")
            torch.cuda.set_device(mesh.device)
            spec, rules = sharded_spec(mesh), None
        else:
            mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
            torch.cuda.set_device(mesh.device)
            spec, rules = tp_spec(), mesh
        kwargs = ({"hooks": [hook, CheckpointHook(directory, every=3)]} if part == "a" else
                  {"hooks": [hook], "resume_from": directory, "resume_step": 3})
        if rules is None:
            state = run(spec, **kwargs).state
        else:
            with use_sharding_rules(rules):
                state = run(spec, **kwargs).state
        torch.cuda.synchronize()
        out = {"losses": hook.losses, "digests": digests(state), "launches": dict(AU.LAUNCHES)}
        with open(f"{tmp}/{what}_{part}_{rank}.json", "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for what in ("sharded", "tp"):
            for part in ("a", "b"):
                torch.multiprocessing.spawn(group, args=(what, part, tmp), nprocs=2, join=True)
        print("OK resume on the card")
''')


@pytest.mark.cuda
def test_two_ranks_on_the_card_resume_bitwise(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    script = tmp_path / "cuda_tp_checkpoint.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK resume on the card" in proc.stdout

    def rec(what, part, rank):
        with open(tmp_path / f"{what}_{part}_{rank}.json") as f:
            return json.load(f)

    from repro_torch.configs import get_config
    from repro_torch.training.steps import param_template
    from repro_torch.tree import tree_paths

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_layers=2)
    n = sum(int(np.prod(s)) for _, (s, _) in tree_paths(param_template(cfg)))
    for what, kernel, counts in (("sharded", "fused_chain", (6, 3)), ("tp", "fused_tick", (4, 1))):
        for rank in range(2):
            a, b = rec(what, "a", rank), rec(what, "b", rank)
            assert b["losses"] == a["losses"][3:], what
            assert [k for k in a["digests"] if a["digests"][k] != b["digests"][k]] == [], what
            assert (a["launches"][kernel], b["launches"][kernel]) == counts, (what, a, b)
        data = np.load(tmp_path / f"ck_{what}" / "step_00000003.npz")
        assert data[".params"].shape == (n,)
        ring = data[".delayed.ring"].shape
        assert ring == ((2, 4, n) if what == "sharded" else (8, n)), ring
