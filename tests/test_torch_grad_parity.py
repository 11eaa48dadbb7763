"""The training loss and flat gradient of every registered arch, from the
port's ``distributed.worker.make_grad_fn`` against the reference's
(``src/repro/distributed/worker.py``), on the CPU.

Each arch is reduced at d_model 64 in f32, with batch 2 x seq 16; both sides
get the reference's ``init_params`` (carried over with
:func:`repro_torch.bridge.params_from_jax`) and the same numpy batch (the
vision prefix rows and the encoder frames included, which leave the loss).
Tolerances: the loss within 1e-6 relative and the flat gradient within 1e-5
of max |g| — f32 round-off of a different reduction order (a check of all
ten measured <= 2.2e-7 and <= 4.1e-6, the largest on gemma3-27b).
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten_with_keys
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import make_batch_for as j_make_batch_for
from repro.distributed import make_grad_fn as j_make_grad_fn
from repro.training import init_params as j_init_params
from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.distributed import make_grad_fn


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_all_ten_archs_are_covered():
    assert len(ASSIGNED_ARCHS) == 10


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_worker_gradient_matches_reference(arch):
    jcfg = j_reduced(j_get_config(arch), d_model=64)
    tcfg = reduced(get_config(arch), d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    keys, leaves, _ = _flatten_with_keys(params)
    flat, _ = bridge.params_from_jax({k: np.asarray(v) for k, v in zip(keys, leaves)}, tcfg)
    jl, jg = j_make_grad_fn(jcfg)(flat.numpy(), j_make_batch_for(jcfg, batch=2, seq=16, seed=0))
    tl, tg = make_grad_fn(tcfg, "cpu")(flat, make_batch_for(tcfg, batch=2, seq=16, seed=0))
    assert isinstance(tl, float) and tg.shape == flat.shape and tg.dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
