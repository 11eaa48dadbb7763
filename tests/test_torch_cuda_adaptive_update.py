"""The streaming kernels of the adaptive_update family (``au_fused_chain``:
sgd, momentum and adam bodies; ``au_fused_update``: the ``fused_apply``
link) held BITWISE against their plain versions, on the card.

This file imports no JAX, so its ``cuda``-marked tests run on a machine with
a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_adaptive_update.py

They skip without a card.  Three sizes take the kernels' three paths: n =
2^20 (the 16-byte vector body alone), n = 100003 (the vector body and a
scalar tail of n % 4 = 3 elements) and buffers offset by one element (not
16-byte aligned: the whole-buffer scalar path).  The kernels apply the
plain versions' f32 operations in the same order with no contraction, so
every bit must agree (compared as int32 views).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.adaptive_update import cuda as C
from repro_torch.kernels.adaptive_update import ref

SCALARS = {"f_stale": 1.3, "f_keep": 1.0, "f_clip": 0.7, "m_scale": -0.05, "mu": 0.9,
           "b1": 0.9, "omb1": 0.1, "b2": 0.999, "omb2": 0.001, "eps": 1e-8, "c1": 10.0,
           "c2": 1000.0}
SIZES = {"vector": (1 << 20, 0), "tail": (100003, 0), "misaligned": (4099, 1)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _buffers(n, offset, count, device, seed):
    """``count`` f32 buffers of n elements from a numpy seed, each a view
    ``offset`` elements into its storage (1: not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        a = rng.standard_normal(n + offset).astype(np.float32)
        if i == 3:  # adam's second moment, kept off 0 as chip_smoke.py does
            a = np.abs(a) + np.float32(0.1)
        out.append(torch.from_numpy(a).to(device)[offset:])
    return out


def _scalars(kind):
    return {k: torch.tensor(SCALARS[k], dtype=torch.float32) for k in ref.SCALAR_ORDER[kind]}


def _family(kind, bufs):
    if kind == "sgd":
        return ()
    if kind == "momentum":
        return bufs[0]
    return {"m": bufs[0], "v": bufs[1]}


def _state_list(kind, fam):
    return [] if kind == "sgd" else ([fam] if kind == "momentum" else [fam["m"], fam["v"]])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _run_chain(kind, n, offset, device):
    p, g, *state = _buffers(n, offset, 2 + {"sgd": 0, "momentum": 1, "adam": 2}[kind], device, 0)
    s = _scalars(kind)
    want_p, want_b = ref.fused_chain_ref(kind, p, g, _family(kind, state), s)
    before = C.LAUNCHES["fused_chain"]
    C.fused_chain(kind, p, g, _family(kind, state), s)
    return before, [p] + state, [want_p] + _state_list(kind, want_b)


def _run_update(n, offset, device):
    p, g, v = _buffers(n, offset, 3, device, 1)
    alpha, mu = torch.tensor(0.05), torch.tensor(0.9)
    want = ref.adaptive_update_ref(p, g, v, alpha, mu)
    before = C.LAUNCHES["fused_update"]
    C.fused_update(p, g, v, alpha, mu)
    return before, [p, v], list(want)


# ---------------------------------------------------------------------------
# The card: bitwise, one launch each, no fallback
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_chain_kernel_is_bitwise_the_plain_version_on_card(cuda_device, kind, size):
    n, offset = SIZES[size]
    before, got, want = _run_chain(kind, n, offset, cuda_device)
    torch.cuda.synchronize()
    assert C.LAUNCHES["fused_chain"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_update_kernel_is_bitwise_the_plain_version_on_card(cuda_device, size):
    n, offset = SIZES[size]
    before, got, want = _run_update(n, offset, cuda_device)
    torch.cuda.synchronize()
    assert C.LAUNCHES["fused_update"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_card_tensors_never_reach_the_plain_versions(cuda_device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "fused_chain_ref", refuse)
    monkeypatch.setattr(ref, "adaptive_update_ref", refuse)
    p, g, v = _buffers(1003, 0, 3, cuda_device, 2)
    C.fused_chain("momentum", p, g, v, _scalars("momentum"))
    C.fused_update(p, g, v, torch.tensor(0.05), torch.tensor(0.9))
    torch.cuda.synchronize()
    assert torch.isfinite(p).all()


@pytest.mark.cuda
def test_chunk_counter_is_back_to_zero_after_each_launch(cuda_device):
    """The block that draws a launch's last chunk resets the counter, so
    launches in a row on one stream, and on a second stream, each start at 0."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for _ in range(2):
        _, got, want = _run_chain("momentum", 100003, 0, dev)
        torch.cuda.synchronize()
        assert int(C._chunk_counter(dev).item()) == 0
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        _, got, want = _run_update(1 << 20, 0, dev)
        side_counter = C._chunk_counter(dev)
    torch.cuda.synchronize()
    assert side_counter is not C._chunk_counter(dev)
    assert int(side_counter.item()) == 0
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
