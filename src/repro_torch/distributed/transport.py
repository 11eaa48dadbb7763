"""Pluggable message fabric between the parameter server and its workers
(port of ``src/repro/distributed/transport.py``).

Both transports present the same two surfaces:

* server side — ``recv(timeout) -> (msg, reply_fn) | None`` plus ``send(msg)``
  for reply-less control messages (batches, stop, refresh calls).  The server
  loop consumes ONE stream whatever the fabric, so ordering, staleness
  stamping and shutdown live in :mod:`repro_torch.distributed.server` once.
* worker side — ``rpc(msg, timeout) -> reply``: one outstanding request per
  worker (pull params / push gradient).

Construction goes through the registry: ``make_transport(kind, **opts)``
builds the fabric named ``kind`` (:func:`transport_kinds` lists them), and a
new fabric is one ``@register_transport("name")`` entry.  Every transport
also launches ITS kind of worker (``start_worker``): threads for the
in-process fabric, ``multiprocessing.get_context("spawn")`` processes for
sockets.  Transports are context managers with an idempotent ``close()``.

Failure semantics (what :func:`repro_torch.distributed.worker.worker_loop`
retries against):

* ``EOFError``     — the server is GONE (transport closed, connection shut):
  raised at once, never after a timeout wait.  Workers exit cleanly.
* ``TimeoutError`` — no reply within the rpc deadline (a reply was dropped,
  or the server is wedged): transient, safe to retry with backoff.
* ``ConnectionError`` / ``OSError`` — wire trouble: transient; the socket
  endpoint reconnects on the next attempt.

The payloads differ by fabric (``wire``):

* ``InProcTransport`` (``wire = "tensor"``) moves the tensors themselves:
  the server hands a worker thread its params on their device and the worker
  pushes its gradient back on that device, with no round trip through the
  host.  Its bounded queue is the backpressure.
* ``SocketTransport`` (``wire = "numpy"``) carries numpy ``float32`` flat
  ``(N,)`` buffers and numpy batches, as the reference's transport does,
  length-prefixed pickles over localhost TCP.

``threads`` (both fabrics) sets the intra-op thread count of each worker
(``torch.set_num_threads`` inside the worker thread or process; None leaves
torch's default).  Sockets bind to localhost and carry pickles: this is a
single-machine research transport, not a hardened network protocol.
"""

from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Protocol

__all__ = [
    "ServerTransport",
    "WorkerEndpoint",
    "InProcTransport",
    "InProcWorkerEndpoint",
    "SocketTransport",
    "SocketWorkerEndpoint",
    "make_transport",
    "register_transport",
    "transport_kinds",
]

_DEFAULT_CAPACITY = 64
_DEFAULT_RPC_TIMEOUT = 60.0
_LEN = struct.Struct("!I")


class ServerTransport(Protocol):
    """What the server loop needs from a fabric; see module docstring."""

    def recv(self, timeout: float | None = None) -> tuple[Any, Callable | None] | None: ...

    def send(self, msg: Any) -> None: ...

    def start_worker(self, worker_id: int, cfg: Any, **opts: Any) -> Any: ...

    def close(self) -> None: ...


class WorkerEndpoint(Protocol):
    """What a worker loop needs: blocking request/reply with a deadline."""

    def rpc(self, msg: Any, timeout: float | None = None) -> Any: ...

    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# Registry: make_transport(kind, **opts)
# ---------------------------------------------------------------------------

_TRANSPORTS: dict[str, Callable[..., Any]] = {}


def register_transport(kind: str) -> Callable:
    """Class decorator: file a transport factory under ``kind``."""

    def deco(cls):
        _TRANSPORTS[kind] = cls
        return cls

    return deco


def transport_kinds() -> tuple[str, ...]:
    """The registered fabric names (argparse choices, spec validation)."""
    return tuple(_TRANSPORTS)


def make_transport(kind: str, **opts: Any):
    """Build the server side of the fabric named ``kind``."""
    try:
        factory = _TRANSPORTS[kind]
    except KeyError:
        raise ValueError(
            f"unknown transport {kind!r} (registered: {transport_kinds()})"
        ) from None
    return factory(**opts)


class _CloseableBase:
    """Idempotent close + context-manager plumbing shared by both fabrics."""

    def __init__(self):
        self._closed = threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._close_once()

    def _close_once(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# In-process: threads over one bounded queue
# ---------------------------------------------------------------------------


@register_transport("inproc")
class InProcTransport(_CloseableBase):
    """Thread fabric: one bounded FIFO of ``(msg, reply_fn)`` pairs.

    FIFO gives a total order over every pull/push/control message; the
    ``capacity`` bound is the backpressure (producers block while the server
    is ``capacity`` messages behind).  Payloads are the tensors themselves.
    """

    wire = "tensor"

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, threads: int | None = None):
        super().__init__()
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._threads = threads
        self._grad_fn = None  # one gradient function shared by every worker thread

    def recv(self, timeout: float | None = None):
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def send(self, msg: Any) -> None:
        self._queue.put((msg, None))

    def worker_endpoint(self) -> "InProcWorkerEndpoint":
        return InProcWorkerEndpoint(self._queue, self._closed)

    def start_worker(self, worker_id: int, cfg: Any, *, faults=None, retry=None,
                     device: Any = "cuda"):
        """Launch one worker THREAD over a fresh endpoint; returns the
        (daemon, already-started) thread.  The gradient function is built
        once per transport and shared by the threads."""
        from repro_torch.distributed.worker import make_grad_fn, worker_loop

        if self._grad_fn is None:
            self._grad_fn = make_grad_fn(cfg, device)
        t = threading.Thread(
            target=_with_threads,
            args=(self._threads, worker_loop, self.worker_endpoint(), self._grad_fn, worker_id),
            kwargs={"faults": faults, "retry": retry},
            daemon=True,
            name=f"ps-worker-{worker_id}",
        )
        t.start()
        return t


def _with_threads(threads: int | None, fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """Run ``fn`` with this thread's intra-op thread count set to ``threads``
    (the setting is per thread: the caller's own count is untouched)."""
    if threads is not None:
        import torch

        torch.set_num_threads(int(threads))
    return fn(*args, **kwargs)


class InProcWorkerEndpoint:
    """One worker's handle: request down the shared queue, reply back on a
    private one (one outstanding rpc per endpoint).  The wait polls in short
    slices so a closed transport surfaces as an immediate ``EOFError``
    instead of a full-timeout hang."""

    _POLL_S = 0.05

    def __init__(self, q: queue.Queue, closed: threading.Event):
        self._queue = q
        self._transport_closed = closed
        self._reply: queue.Queue = queue.Queue()

    def rpc(self, msg: Any, timeout: float | None = None) -> Any:
        if self._transport_closed.is_set():
            raise EOFError("parameter-server transport is closed")
        # A reply to an rpc we previously abandoned (timeout + retry) must
        # not satisfy THIS call: drain stale replies before sending.
        while True:
            try:
                self._reply.get_nowait()
            except queue.Empty:
                break
        self._queue.put((msg, self._reply.put))
        deadline = time.monotonic() + (timeout or _DEFAULT_RPC_TIMEOUT)
        while True:
            if self._transport_closed.is_set():
                raise EOFError("parameter-server transport closed mid-rpc")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"rpc {msg[0]!r}: no reply within {timeout}s")
            try:
                return self._reply.get(timeout=min(self._POLL_S, remaining))
            except queue.Empty:
                continue

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Sockets: length-prefixed pickles over localhost TCP
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, obj: Any, lock: threading.Lock) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with lock:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any | None:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    body = _recv_exact(sock, _LEN.unpack(head)[0])
    if body is None:
        return None
    return pickle.loads(body)


@register_transport("socket")
class SocketTransport(_CloseableBase):
    """TCP fabric: an acceptor thread adapts every worker connection onto the
    same internal bounded queue the in-proc fabric uses, and each reply_fn
    writes back down the originating connection.  ``address`` is the bound
    ``(host, port)`` to hand to spawned worker processes.  Payloads are
    numpy float32 buffers and numpy batches."""

    wire = "numpy"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 capacity: int = _DEFAULT_CAPACITY, threads: int | None = None):
        super().__init__()
        self._threads = threads
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self.address: tuple[str, int] = self._listener.getsockname()
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._read_loop, args=(conn,), daemon=True).start()

    def _read_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def reply(obj: Any) -> None:
            try:
                _send_msg(conn, obj, wlock)
            except OSError:
                pass  # worker hung up mid-reply; its retry will re-pull

        while not self._closed.is_set():
            try:
                msg = _recv_msg(conn)
            except OSError:
                return
            if msg is None:
                return  # worker hung up
            self._queue.put((msg, reply))

    def recv(self, timeout: float | None = None):
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def send(self, msg: Any) -> None:
        self._queue.put((msg, None))

    def start_worker(self, worker_id: int, cfg: Any, *, faults=None, retry=None,
                     device: Any = "cuda"):
        """Spawn one worker PROCESS against ``self.address``; returns the
        (daemon, already-started) process.  spawn, not fork: a forked child
        of a process that has initialized CUDA cannot use the card.  The
        worker computes on ``device``, as the server passes it."""
        import multiprocessing

        from repro_torch.distributed.worker import socket_worker_main

        mp = multiprocessing.get_context("spawn")
        p = mp.Process(
            target=socket_worker_main,
            args=(self.address, cfg, worker_id),
            kwargs={"faults": faults, "retry": retry, "device": str(device),
                    "threads": self._threads},
            daemon=True,
        )
        p.start()
        return p

    def _close_once(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()


class SocketWorkerEndpoint:
    """Worker-process side of :class:`SocketTransport`: one connection, one
    outstanding rpc.

    A server-side disconnect raises ``EOFError`` IMMEDIATELY (``recv``
    returns EOF the moment the peer closes — no timeout wait); a reply that
    simply never comes raises ``TimeoutError`` after ``timeout`` seconds and
    poisons the connection (a half-read frame cannot be resynchronized), so
    the endpoint drops the socket and reconnects lazily on the next rpc —
    which is what makes worker-side retry-with-backoff safe over TCP."""

    def __init__(self, address: tuple[str, int], timeout: float = _DEFAULT_RPC_TIMEOUT):
        self._address = tuple(address)
        self._timeout = timeout
        self._sock: socket.socket | None = None
        self._wlock = threading.Lock()
        self._closed = False
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(self._address, timeout=self._timeout)

    def rpc(self, msg: Any, timeout: float | None = None) -> Any:
        if self._closed:
            raise EOFError("endpoint is closed")
        if self._sock is None:
            self._connect()  # ConnectionError here is transient: retryable
        sock = self._sock
        sock.settimeout(timeout or self._timeout)
        try:
            _send_msg(sock, msg, self._wlock)
            reply = _recv_msg(sock)
        except socket.timeout:
            self._drop()  # frame boundary lost; reconnect before any retry
            raise TimeoutError(f"rpc {msg[0]!r}: no reply within {timeout or self._timeout}s")
        except OSError:
            self._drop()
            raise
        if reply is None:
            self._drop()
            raise EOFError("parameter server closed the connection")
        return reply

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._closed = True
        self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
