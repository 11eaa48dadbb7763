"""Port parity, RG-LRU: the kernel's plain version against the reference's
Pallas kernel (interpret mode) and its oracle, and the recurrent block's
full-sequence, decode-step and prefill-cache paths against the reference on
the same params (reduced recurrentgemma-9b, width 256, f32).

Tolerances: the plain recurrence is held to the reference's own kernel
tolerance, 3e-5 (``tests/test_kernels.py:165``); the block paths are f32 on
both sides and agree to round-off (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.rg_lru.ops import rg_lru as j_rg_lru
from repro.kernels.rg_lru.ref import rg_lru_ref as j_rg_lru_ref
from repro.models import rglru as JR
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.rg_lru import LAUNCHES, rg_lru
from repro_torch.models import rglru as TR

F32_TOL = dict(rtol=3e-5, atol=3e-5)
ROUND_OFF = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _gates_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, W)))).astype(np.float32)  # -softplus
    return log_a, rng.standard_normal((B, S, W)).astype(np.float32)


@pytest.mark.parametrize("B,S,W", [(2, 37, 16), (1, 130, 64), (3, 5, 100)])
def test_plain_rg_lru_matches_reference_kernel_and_oracle(B, S, W):
    log_a, x = _gates_inputs(B, S, W, seed=S * 7 + W)
    got = rg_lru(torch.from_numpy(log_a), torch.from_numpy(x)).numpy()
    assert LAUNCHES["rg_lru"] == 0, "the CPU path launched (counted) a kernel"
    want_kernel = j_rg_lru(jnp.asarray(log_a), jnp.asarray(x), block_w=8, chunk=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(j_rg_lru_ref(jnp.asarray(log_a), jnp.asarray(x))),
                               **F32_TOL)


@pytest.fixture(scope="module")
def block():
    jcfg = j_reduced(j_get_config("recurrentgemma-9b"))
    tcfg = reduced(get_config("recurrentgemma-9b"))
    jp = JR.init_rglru(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (0.5 * np.random.default_rng(0).standard_normal((2, 40, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_lambda_init_is_the_reference_draw(block):
    jcfg, tcfg, jp, _, _ = block
    got = TR.init_rglru(torch.Generator().manual_seed(0), tcfg, "cpu")["lambda_"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp["lambda_"]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_rglru_matches_reference(block, use_pallas):
    jcfg, tcfg, jp, tp, x = block
    want = JR.apply_rglru(jp, jnp.asarray(x), dataclasses.replace(jcfg, use_pallas=use_pallas))
    got = TR.apply_rglru(tp, torch.from_numpy(x), dataclasses.replace(tcfg, use_pallas=use_pallas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUND_OFF)


def test_prefill_cache_matches_reference_and_h_is_the_last_output(block):
    jcfg, tcfg, jp, tp, x = block
    want_out, want_cache = JR.rglru_prefill_cache(jp, jnp.asarray(x), jcfg, jnp.float32)
    got_out, got_cache = TR.rglru_prefill_cache(tp, torch.from_numpy(x), tcfg, torch.float32)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **ROUND_OFF)
    np.testing.assert_allclose(got_cache["conv"].numpy(), np.asarray(want_cache["conv"]),
                               **ROUND_OFF)
    # the port takes h = ys[:, -1]; the reference takes its scan's final carry
    np.testing.assert_allclose(got_cache["h"].numpy(), np.asarray(want_cache["h"]), **ROUND_OFF)
    log_a, x_in = _gates_inputs(2, 40, 16, seed=1)
    ys, hT = JR.rg_lru_ref(jnp.asarray(log_a), jnp.asarray(x_in), jnp.zeros((2, 16)))
    np.testing.assert_array_equal(np.asarray(ys[:, -1]), np.asarray(hT))


def test_decode_step_matches_reference(block):
    jcfg, tcfg, jp, tp, x = block
    rng = np.random.default_rng(4)
    W = jcfg.lru_width
    conv = rng.standard_normal((2, jcfg.ssm_conv - 1, W)).astype(np.float32)
    h = rng.standard_normal((2, W)).astype(np.float32)
    want_y, want_c = JR.apply_rglru_step(jp, jnp.asarray(x[:, :1]),
                                         {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}, jcfg)
    cache = {"conv": torch.from_numpy(conv.copy()), "h": torch.from_numpy(h.copy())}
    got_y, got_c = TR.apply_rglru_step(tp, torch.from_numpy(x[:, :1]), cache, tcfg)
    assert got_c is cache, "the decode step updates its cache in place"
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **ROUND_OFF)
    for name in ("conv", "h"):
        np.testing.assert_allclose(got_c[name].numpy(), np.asarray(want_c[name]), **ROUND_OFF)
