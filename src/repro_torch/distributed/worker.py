"""Worker side of the live parameter server: pull, grad, push — and survive
(port of ``src/repro/distributed/worker.py``).

A worker is a loop over two rpcs:

    ("pull", wid)                                 -> ("work", version, t_pull,
                                                      p_flat, batch)
    ("push", wid, version, t_pull, g_flat, loss)  -> ("ack", tau) | ("stop",)

``p_flat`` and ``g_flat`` are the flat ``(N,)`` f32 buffers of the fused
layout, so a worker never sees the param tree: the loss runs through the
:func:`~repro_torch.optim.transform.flat_view` boundary and autograd returns
the gradient already packed.  Over the in-process fabric they are tensors on
the run's device; over sockets, numpy arrays (:mod:`.transport`).
``t_pull`` (the server's wall clock at dispatch) is opaque to the worker: it
echoes it back so the server can record the round-trip time behind the
version-count tau without trusting a worker clock.

Failure contract (the reference's):

* transient transport errors (``TimeoutError`` / ``ConnectionError`` /
  ``OSError``) are retried with capped exponential backoff per
  :class:`~repro_torch.distributed.faults.RetryPolicy`; a retried push may
  apply twice, which asynchronous SGD absorbs as one more stale gradient;
* ``EOFError`` means the server is GONE: the worker exits at once;
* a :class:`~repro_torch.distributed.faults.FaultPlan` injects worker-side
  faults (crash before/after push, delayed push) at the marked points.

``worker_loop`` runs as a thread over :class:`~repro_torch.distributed
.transport.InProcTransport`; ``socket_worker_main`` is the importable entry
of a ``multiprocessing`` spawn process against :class:`SocketTransport`.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.distributed.faults import FaultPlan, RetryPolicy

__all__ = ["make_grad_fn", "worker_loop", "socket_worker_main"]

_TRANSIENT = (TimeoutError, ConnectionError, OSError)


def _on(x: Any, device) -> Any:
    """A numpy array or tensor (or a dict of them) as tensors on ``device``;
    a tensor already there is returned as is (no copy)."""
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return torch.as_tensor(x).to(device)


def make_grad_fn(cfg, device: Any = "cuda") -> Callable:
    """``(p_flat, batch) -> (loss: float, g_flat)``: the gradient of the
    model's ``loss_fn`` over ``flat_view(p_flat, template)``, on ``device``.

    ``p_flat`` and the batch may be tensors or numpy arrays; ``g_flat`` is a
    ``(N,)`` f32 tensor on ``device``.  ``p_flat`` is only read: the
    gradient is taken with respect to a detached alias of it."""
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.training.steps import param_template

    template = param_template(cfg)
    device = torch.device(device)

    def grad_fn(p_flat, batch):
        leaf = _on(p_flat, device).detach().requires_grad_(True)
        loss, _aux = M.loss_fn(T.flat_view(leaf, template), _on(batch, device), cfg)
        (g_flat,) = torch.autograd.grad(loss, leaf)
        # reprolint: disable=RL001 — the worker reports its loss to the server as a host float
        return float(loss.detach()), g_flat

    return grad_fn


def _rpc_with_retry(endpoint, msg: Any, policy: RetryPolicy) -> Any | None:
    """One rpc under the retry policy.  Returns the reply, or None when the
    worker should give up cleanly: the server is gone (``EOFError``) or the
    transient-error budget is spent."""
    delay = policy.backoff_base
    for attempt in range(policy.max_retries + 1):
        try:
            return endpoint.rpc(msg, timeout=policy.rpc_timeout)
        except EOFError:
            return None  # server gone: clean exit, no retry
        except _TRANSIENT:
            if attempt == policy.max_retries:
                return None
            time.sleep(delay)
            delay = min(delay * 2.0, policy.backoff_max)
    return None  # unreachable; keeps the contract explicit


def worker_loop(
    endpoint,
    grad_fn: Callable,
    worker_id: int,
    *,
    faults: FaultPlan | None = None,
    retry: RetryPolicy | None = None,
) -> None:
    """Pull/compute/push until the server says stop, dies, or a planned
    fault kills this worker (module docstring has the failure contract).
    The pulled params and the pushed gradient are dropped as soon as they
    are used: at full width each is a multi-GB buffer."""
    policy = retry if retry is not None else RetryPolicy()
    inject = faults.for_worker(worker_id) if faults is not None else None
    try:
        while True:
            reply = _rpc_with_retry(endpoint, ("pull", worker_id), policy)
            if reply is None or reply[0] == "stop":
                return
            _, version, t_pull, p_flat, batch = reply
            del reply
            loss, g_flat = grad_fn(p_flat, batch)
            del p_flat, batch
            if inject is not None:
                if inject.fire("crash_before_push", worker_id) is not None:
                    return  # crash: the pulled batch is stranded in flight
                delayed = inject.fire("delay_push", worker_id)
                if delayed is not None:
                    time.sleep(delayed.seconds)  # straggler
            ack = _rpc_with_retry(
                endpoint, ("push", worker_id, version, t_pull, g_flat, loss), policy
            )
            del g_flat
            if ack is None or ack[0] == "stop":
                return
            if inject is not None and inject.fire("crash_after_push", worker_id) is not None:
                return  # crash with nothing in flight: the pool just shrinks
    finally:
        endpoint.close()


def socket_worker_main(
    address,
    cfg,
    worker_id: int,
    faults: FaultPlan | None = None,
    retry: RetryPolicy | None = None,
    device: str = "cuda",
    threads: int | None = None,
) -> None:
    """Entry point of a spawned worker process (importable, hence picklable
    by ``multiprocessing.get_context("spawn")``, as are the fault plan and
    retry policy riding along).  It computes on ``device`` and speaks the
    numpy wire: the params arrive as a numpy buffer and the gradient leaves
    as one."""
    from repro_torch.distributed.transport import SocketWorkerEndpoint

    if threads is not None:
        torch.set_num_threads(int(threads))
    grad_fn = make_grad_fn(cfg, device)

    def wire_grad_fn(p_flat, batch):
        loss, g_flat = grad_fn(p_flat, batch)
        return loss, g_flat.cpu().numpy()

    timeout = (retry or RetryPolicy()).rpc_timeout
    endpoint = SocketWorkerEndpoint(tuple(address), timeout=timeout)
    worker_loop(endpoint, wire_grad_fn, worker_id, faults=faults, retry=retry)
