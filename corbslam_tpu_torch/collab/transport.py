"""Transport layer: service RPC (uplink) + topic broadcast (downlink); the
port's copy of the JAX package's `collab/transport.py`.

Replaces ROS1 (ref: XML-RPC + TCPROS; services advertised at
corbslam_server/src/main.cpp:49-55, topics at PubToClient.cpp:17-20;
client subscriptions at Cache.cc:425-440). Two implementations:

- `InProcTransport` (here): queues in one process — the hermetic
  multi-client test rig (SURVEY.md §4: the reference's
  roscore-on-localhost pattern, done in-process), also the single-host
  multi-client deployment shape where client shards and the fusion
  controller share a pod and exchange device arrays directly.
- `socket_transport.SocketServerTransport` / `SocketClientTransport`:
  the same interface over TCP for N client processes + 1 server process
  (the reference's actual deployment shape).

Unlike the reference — which clears its dirty snapshot before the RPC and
silently DROPS deltas on failure (DataDriver.cc:70-73, flagged in
SURVEY.md §5.3) — `call` returns an explicit ack and callers keep their
dirty state until acknowledged.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

from . import wire

Payload = Dict[str, np.ndarray]


class Transport:
    """Abstract star-topology transport: N clients <-> 1 server."""

    # -- uplink (client -> server RPC with ack) ---------------------------
    def call(self, service: str, cid: int, payload: Payload) -> bool:
        raise NotImplementedError

    # -- downlink (server -> all clients broadcast) -----------------------
    def publish(self, topic: str, payload: Payload) -> None:
        raise NotImplementedError

    def poll(self, topic: str, cid: int) -> List[Payload]:
        """Drain pending messages of `topic` for client `cid`."""
        raise NotImplementedError


class InProcTransport(Transport):
    """Queue-based transport for tests and single-host deployments.

    `serialize=True` round-trips every message through the binary wire
    codec (wire.pack_arrays/unpack_arrays) so the test exercises the real
    encoding; False passes arrays by reference (zero-copy fast path).
    """

    def __init__(self, serialize: bool = True, drop_calls: int = 0):
        self._handlers: Dict[str, Callable[[int, Payload], bool]] = {}
        self._queues: Dict[Tuple[str, int], List[bytes]] = defaultdict(list)
        self._clients: set = set()
        self._lock = threading.Lock()
        self.serialize = serialize
        # Fault injection: fail the next `drop_calls` service calls
        # (SURVEY.md §5.3 — the reference has no fault injection at all).
        self.drop_calls = drop_calls
        self.n_calls = 0
        self.n_published = 0

    def register_handler(self, service: str, fn: Callable[[int, Payload], bool]):
        self._handlers[service] = fn

    def register_client(self, cid: int):
        with self._lock:
            self._clients.add(cid)

    def _codec(self, payload: Payload) -> Payload:
        if not self.serialize:
            return payload
        return wire.unpack_arrays(wire.pack_arrays(payload))

    def call(self, service: str, cid: int, payload: Payload) -> bool:
        self.n_calls += 1
        if self.drop_calls > 0:
            self.drop_calls -= 1
            return False
        fn = self._handlers.get(service)
        if fn is None:
            return False
        return bool(fn(cid, self._codec(payload)))

    def publish(self, topic: str, payload: Payload) -> None:
        self.n_published += 1
        data = self._codec(payload)
        with self._lock:
            for cid in self._clients:
                self._queues[(topic, cid)].append(data)

    def poll(self, topic: str, cid: int) -> List[Payload]:
        with self._lock:
            msgs = self._queues.pop((topic, cid), [])
        return msgs
