"""What the tensor-parallel tests share: the reduced configs and the run
specs that the one-process and the sharded runs both take
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_tp_archs.py``
and their spawned ranks, ``tests/test_torch_cuda_tensor_parallel.py``).
Imports no JAX."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.optim import transform as T
from repro_torch.training import default_adapt_setup

B, S, GEN, TICKS = 2, 16, 8, 4


def config(variant):
    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    return dataclasses.replace(cfg, num_kv_heads=1) if variant == "kv1" else cfg


# The other families at d_model 64, each cut as the reference's ``reduced``
# cuts it, and then: recurrentgemma-9b to one (recurrent, recurrent, local)
# period and a remainder recurrent layer; whisper-large-v3's vocab to 514,
# which as its 51,866 splits over 2 ranks and not over 4; internvl2-2b's to
# 515, odd as its 92,553, so its embedding, unembedding and logits stay whole.
ARCH_UPDATES = {
    "falcon-mamba-7b": {},
    "recurrentgemma-9b": {"num_layers": 4},
    "whisper-large-v3": {"vocab_size": 514},
    "internvl2-2b": {"vocab_size": 515},
}
ARCHS = tuple(ARCH_UPDATES)


def arch_config(arch, reduce=reduced, get=get_config):
    """``arch`` reduced for the tensor-parallel tests (``ARCH_UPDATES``);
    ``reduce`` / ``get`` of the reference give its twin."""
    return dataclasses.replace(reduce(get(arch), d_model=64), **ARCH_UPDATES[arch])


def async_spec(cfg, params, draws, device="cpu"):
    """4 fused async ticks: momentum, W = K = 4, a refresh every 2, the
    uniforms handed in."""
    from repro_torch.run import RunSpec

    lr = 0.05
    sched, _, adapt = default_adapt_setup(lr, 4, 4, device="cpu")
    link = T.scale_by_staleness(sched, lr, m=4, tau_max=adapt.tau_max)
    it = iter(draws)
    return RunSpec(cfg=cfg, pipeline=T.chain(link, T.scale(-lr), T.trace(0.9)), mode="async",
                   num_steps=TICKS, batch_size=B, seq_len=S, num_workers=4, ring=4, adapt=adapt,
                   fuse=True, params=params, refresh_every=2, seed=0, device=device,
                   tau_source=lambda: torch.from_numpy(next(it)))


def arch_async_spec(cfg, params, draws, device="cpu"):
    """:func:`async_spec` for 3 ticks on the batches ``make_batch_for``
    draws (the vision prefix and the encoder frames included), step t's
    from seed t."""
    from repro_torch.data import make_batch_for

    return dataclasses.replace(
        async_spec(cfg, params, draws, device), num_steps=3,
        batch_fn=lambda t: make_batch_for(cfg, batch=B, seq=S, seed=t, device=device))


def clip_spec(cfg, params, device="cpu"):
    """2 sync fused steps whose clip binds."""
    from repro_torch.run import RunSpec

    pipe = T.chain(T.clip_by_global_norm(0.05), T.scale(-0.05), T.trace(0.9))
    return RunSpec(cfg=cfg, pipeline=pipe, mode="sync", num_steps=2, batch_size=B, seq_len=S,
                   fuse=True, params=params, seed=0, device=device)


class Tables:
    """Every tick's loss, alpha table, CDF and histogram."""

    def __init__(self):
        self.rows = []

    def on_start(self, ctx):
        pass

    def on_refresh(self, ctx):
        pass

    def on_tick(self, ctx):
        a = ctx.state.adapt
        self.rows.append((ctx.metrics["loss"].clone(), a.alpha_table.clone(), a.tau_cdf.clone(),
                          a.hist.clone()))

    def on_end(self, ctx):
        pass

    def arrays(self):
        return {f"{k}": np.stack([r[i].cpu().numpy() for r in self.rows])
                for i, k in enumerate(("losses", "tables", "cdfs", "hists"))}
