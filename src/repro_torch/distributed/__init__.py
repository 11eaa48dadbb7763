"""Live parameter-server AsyncPSGD: real concurrency, measured staleness
(port of ``src/repro/distributed/``).

Everything else in the port *simulates* asynchrony (delay rings, sampled
taus); this package runs it: a serial-apply parameter server, W live workers
over a pluggable transport (``make_transport`` registry: threads moving
device tensors, or spawned processes over localhost TCP), and an exact
staleness stamp per applied gradient — version-count tau and wall-clock
pull/push times — streamed to a replayable trace.  With ``fuse=True`` every
push is applied by one launch of the hand-written ``fused_chain`` kernel.
It survives failures too: heartbeats and liveness reclaim on the server,
retry with backoff on the workers, and a declarative :class:`FaultPlan`
that injects crashes, delays and dropped acks on purpose.  See
:class:`~repro_torch.distributed.engine.DistributedAsyncEngine` for the
Engine seam (``RunSpec(mode="distributed")``).
"""

from repro_torch.distributed.engine import DistributedAsyncEngine
from repro_torch.distributed.faults import (
    FAULT_KINDS,
    FaultPlan,
    FaultSpec,
    RetryPolicy,
    parse_faults,
)
from repro_torch.distributed.server import ParameterServer
from repro_torch.distributed.transport import (
    InProcTransport,
    InProcWorkerEndpoint,
    SocketTransport,
    SocketWorkerEndpoint,
    make_transport,
    register_transport,
    transport_kinds,
)
from repro_torch.distributed.worker import make_grad_fn, socket_worker_main, worker_loop

__all__ = [
    "DistributedAsyncEngine",
    "ParameterServer",
    "FAULT_KINDS",
    "FaultPlan",
    "FaultSpec",
    "RetryPolicy",
    "parse_faults",
    "InProcTransport",
    "InProcWorkerEndpoint",
    "SocketTransport",
    "SocketWorkerEndpoint",
    "make_transport",
    "register_transport",
    "transport_kinds",
    "make_grad_fn",
    "socket_worker_main",
    "worker_loop",
]
