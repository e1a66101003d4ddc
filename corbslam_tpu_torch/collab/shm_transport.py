"""Same-host transport over the native shared-memory rings (native/shm_ring.cc);
the port's copy of the JAX package's `collab/shm_transport.py`.

Deployment shape: N client processes + 1 server process on one host — the
reference's most common configuration (README.md:55-75 runs roscore,
corbslam_server and all dataset clients on one machine, yet every message
still crosses the loopback TCP stack). Here each client owns two SPSC
rings: an uplink ring it produces (CALL frames) and a downlink ring the
server produces (ACK + PUB frames). Rendezvous is a session directory:
client `k` drops `client_<k>` announcing its ring names; the server scans
it each serve cycle (the roscore name-service equivalent, minus the
daemon).

Frame layout inside a ring slot (the ring adds its own u32 length):
    u8 kind | u16 name_len | name | u64 seq | payload
kinds mirror socket_transport: CALL (uplink RPC), ACK (reply; name "1"/"0"),
PUB (broadcast).

Single-writer discipline is structural: every ring has exactly one
producing process, and server state is only touched in serve_calls().
"""

from __future__ import annotations

import os
import struct
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from . import wire
from .shm_ring import Ring, ShmRingUnavailable
from .transport import Payload, Transport

KIND_CALL = 1
KIND_ACK = 2
KIND_PUB = 3

RING_CAPACITY = 1 << 24  # 16 MB per direction


def _frame(kind: int, name: str, seq: int, payload: bytes) -> bytes:
    nb = name.encode()
    return (struct.pack("<BH", kind, len(nb)) + nb
            + struct.pack("<Q", seq) + payload)


def _parse(buf: bytes):
    kind, nlen = struct.unpack_from("<BH", buf, 0)
    off = 3
    name = buf[off:off + nlen].decode()
    off += nlen
    (seq,) = struct.unpack_from("<Q", buf, off)
    return kind, name, seq, buf[off + 8:]


def _push_blocking(ring: Ring, data: bytes, timeout: float = 30.0) -> bool:
    t0 = time.time()
    while not ring.push(data):
        if time.time() - t0 > timeout:
            return False
        time.sleep(0.0005)
    return True


class ShmServerTransport(Transport):
    """Server side: scans the session dir for clients, serves CALL frames,
    broadcasts PUB frames. Mirrors SocketServerTransport's surface."""

    def __init__(self, session_dir: Optional[str] = None):
        import tempfile

        self.session_dir = session_dir or tempfile.mkdtemp(prefix="csr_sess_")
        os.makedirs(self.session_dir, exist_ok=True)
        self._up: Dict[int, Ring] = {}    # client -> uplink (we consume)
        self._down: Dict[int, Ring] = {}  # client -> downlink (we produce)
        self._handlers: Dict[str, Callable[[int, Payload], bool]] = {}
        self._registered: set = set()
        self._seq = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> str:
        return self.session_dir

    def _scan_clients(self):
        try:
            names = os.listdir(self.session_dir)
        except FileNotFoundError:
            return
        for fn in names:
            if not fn.startswith("client_"):
                continue
            try:
                cid = int(fn.split("_")[1])
            except ValueError:
                # Mid-announce tmp file (client_<k>.tmp before os.replace)
                # or any other non-conforming name: skip, retry next scan.
                continue
            if cid in self._up:
                continue
            base = open(os.path.join(self.session_dir, fn)).read().strip()
            try:
                self._up[cid] = Ring(base + "_up")
                self._down[cid] = Ring(base + "_down")
                self._registered.add(cid)
            except ShmRingUnavailable:
                self._up.pop(cid, None)  # client mid-setup; retry next scan

    def register_handler(self, service: str, fn: Callable[[int, Payload], bool]):
        self._handlers[service] = fn

    def register_client(self, cid: int):
        self._registered.add(cid)

    @property
    def clients(self) -> List[int]:
        return sorted(self._registered)

    # -- serving ---------------------------------------------------------
    def serve_calls(self, max_calls: int = 64) -> int:
        """Drain CALL frames from every uplink ring, run handlers, push
        ACKs. Returns number of calls served."""
        self._scan_clients()
        served = 0
        for cid, ring in list(self._up.items()):
            while served < max_calls:
                buf = ring.pop()
                if buf is None:
                    break
                kind, name, seq, payload = _parse(buf)
                if kind != KIND_CALL:
                    continue
                fn = self._handlers.get(name)
                ok = bool(fn(cid, wire.unpack_arrays(payload))) if fn else False
                _push_blocking(self._down[cid],
                               _frame(KIND_ACK, "1" if ok else "0", seq, b""))
                served += 1
        return served

    def publish(self, topic: str, payload: Payload) -> None:
        self._scan_clients()
        data = wire.pack_arrays(payload)
        self._seq += 1
        f = _frame(KIND_PUB, topic, self._seq, data)
        for cid, ring in self._down.items():
            _push_blocking(ring, f)

    # server never calls/polls
    def call(self, service: str, cid: int, payload: Payload) -> bool:
        raise RuntimeError("server does not call")

    def poll(self, topic: str, cid: int) -> List[Payload]:
        raise RuntimeError("server does not poll")

    def close(self):
        for r in list(self._up.values()) + list(self._down.values()):
            r.close()
        self._up.clear()
        self._down.clear()


class ShmClientTransport(Transport):
    """Client side: owns (creates) both rings, announces them in the
    session dir, produces CALLs, consumes ACKs + PUBs."""

    def __init__(self, cid: int, session_dir: str,
                 capacity: int = RING_CAPACITY):
        self.cid = cid
        base = f"/csr_{os.path.basename(session_dir.rstrip('/'))}_c{cid}"
        self._up = Ring(base + "_up", capacity, create=True)
        self._down = Ring(base + "_down", capacity, create=True)
        ann = os.path.join(session_dir, f"client_{cid}")
        with open(ann + ".tmp", "w") as f:
            f.write(base)
        os.replace(ann + ".tmp", ann)
        self._seq = 0
        self._pubs: Dict[str, List[Payload]] = defaultdict(list)
        # call() (uplink worker thread) and poll() (main thread) both
        # consume the down ring — serialize them (SPSC holds per ring
        # across PROCESSES; within the process we lock).
        import threading

        self._dlock = threading.Lock()

    def register_client(self, cid: int):
        pass  # announcement file already did

    def _drain_down(self, want_ack_seq: Optional[int] = None,
                    timeout: float = 30.0) -> Optional[bool]:
        """Consume downlink frames; PUBs buffer locally. With a seq, block
        until that ACK arrives (or timeout -> None)."""
        t0 = time.time()
        while True:
            buf = self._down.pop()
            if buf is None:
                if want_ack_seq is None:
                    return None
                if time.time() - t0 > timeout:
                    return None
                time.sleep(0.0005)
                continue
            kind, name, seq, payload = _parse(buf)
            if kind == KIND_PUB:
                self._pubs[name].append(wire.unpack_arrays(payload))
            elif kind == KIND_ACK and want_ack_seq is not None \
                    and seq == want_ack_seq:
                return name == "1"

    def call(self, service: str, cid: int, payload: Payload) -> bool:
        with self._dlock:
            self._seq += 1
            f = _frame(KIND_CALL, service, self._seq,
                       wire.pack_arrays(payload))
            if not _push_blocking(self._up, f):
                return False
            ok = self._drain_down(want_ack_seq=self._seq)
            return bool(ok)

    def poll(self, topic: str, cid: int) -> List[Payload]:
        with self._dlock:
            self._drain_down()
            out = self._pubs.pop(topic, [])
            return out

    def publish(self, topic: str, payload: Payload) -> None:
        raise RuntimeError("client does not publish")

    def close(self):
        self._up.close()
        self._down.close()
