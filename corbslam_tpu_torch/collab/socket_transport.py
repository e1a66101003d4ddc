"""TCP socket transport: the multi-process deployment of the Transport
interface.

The reference runs N client processes + 1 server process over ROS1
(XML-RPC name service + TCPROS point-to-point; services advertised at
corbslam_server/src/main.cpp:49-55, topics at PubToClient.cpp:17-20,
client-side service calls at DataDriver.cc:183). This module (the port's
copy of the JAX package's, byte for byte the same frames) is the
equivalent: one listening server socket, N client
connections, length-prefixed binary frames carrying the same
`wire.pack_arrays` payloads the in-process transport uses — no text
archives (the reference's dominant bandwidth cost, SURVEY.md §3.3).

Frame layout (little endian):
    u32 total_len | u8 kind | u16 name_len | name | u64 seq | payload
kinds: HELLO (client id announce), CALL (uplink RPC), ACK (call reply,
name carries "1"/"0"), PUB (downlink broadcast).

Single-writer discipline: the server socket layer only QUEUES incoming
calls; `MapFusionServer` state is touched exclusively when the owner
thread calls `serve_calls()` — the socket threads never run handlers
(the reference needed mutexes for its 2-spinner handler concurrency,
MapFusion.h:98-100; here there is nothing to lock).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from . import wire
from .transport import Payload, Transport

KIND_HELLO = 0
KIND_CALL = 1
KIND_ACK = 2
KIND_PUB = 3

_HDR = struct.Struct("<IBH")


def _send_frame(sock: socket.socket, kind: int, name: str, seq: int,
                payload: bytes) -> None:
    nb = name.encode()
    body = struct.pack("<BH", kind, len(nb)) + nb + struct.pack("<Q", seq) + payload
    sock.sendall(struct.pack("<I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[Tuple[int, str, int, bytes]]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (total,) = struct.unpack("<I", hdr)
    body = _recv_exact(sock, total)
    if body is None:
        return None
    kind, nlen = struct.unpack_from("<BH", body, 0)
    off = 3
    name = body[off:off + nlen].decode(); off += nlen
    (seq,) = struct.unpack_from("<Q", body, off); off += 8
    return kind, name, seq, body[off:]


class SocketServerTransport(Transport):
    """Server end: accepts N clients, queues their CALLs for the owner
    thread, broadcasts PUBs. Use as:

        t = SocketServerTransport(port=0); t.start()
        ... register handlers ...
        while running: t.serve_calls(); server.fuse_step(); ...
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._handlers: Dict[str, Callable[[int, Payload], bool]] = {}
        self._conns: Dict[int, socket.socket] = {}
        self._conn_lock = threading.Lock()
        self._calls: "queue.Queue[Tuple[int, str, int, bytes]]" = queue.Queue()
        self._lsock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.n_calls = 0
        self.n_published = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.host, self.port))
        self._lsock.listen(64)
        self.port = self._lsock.getsockname()[1]
        th = threading.Thread(target=self._accept_loop, daemon=True)
        th.start()
        self._threads.append(th)
        return self.port

    def close(self):
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._conn_lock:
            for s in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                s, _ = self._lsock.accept()
            except OSError:
                return
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            th = threading.Thread(target=self._client_loop, args=(s,), daemon=True)
            th.start()
            self._threads.append(th)

    def _client_loop(self, s: socket.socket):
        cid = None
        try:
            first = _recv_frame(s)
            if first is None or first[0] != KIND_HELLO:
                s.close()
                return
            cid = first[2]  # seq field carries the client id
            with self._conn_lock:
                self._conns[int(cid)] = s
            while not self._stop.is_set():
                fr = _recv_frame(s)
                if fr is None:
                    return
                kind, name, seq, payload = fr
                if kind == KIND_CALL:
                    self._calls.put((int(cid), name, seq, payload))
        except OSError:
            pass
        finally:
            if cid is not None:
                with self._conn_lock:
                    self._conns.pop(int(cid), None)

    # -- Transport interface (server side) ---------------------------------
    def register_handler(self, service: str, fn: Callable[[int, Payload], bool]):
        self._handlers[service] = fn

    def register_client(self, cid: int):
        pass  # clients register themselves by connecting

    @property
    def clients(self) -> List[int]:
        with self._conn_lock:
            return sorted(self._conns)

    def serve_calls(self, max_calls: int = 64) -> int:
        """Run pending uplink calls with the registered handlers and send
        acks. MUST be called from the single server owner thread."""
        n = 0
        while n < max_calls:
            try:
                cid, name, seq, payload = self._calls.get_nowait()
            except queue.Empty:
                break
            self.n_calls += 1
            fn = self._handlers.get(name)
            ok = bool(fn(cid, wire.unpack_arrays(payload))) if fn else False
            with self._conn_lock:
                s = self._conns.get(cid)
            if s is not None:
                try:
                    _send_frame(s, KIND_ACK, "1" if ok else "0", seq, b"")
                except OSError:
                    pass
            n += 1
        return n

    def publish(self, topic: str, payload: Payload) -> None:
        self.n_published += 1
        raw = wire.pack_arrays(payload)
        with self._conn_lock:
            conns = list(self._conns.items())
        for _, s in conns:
            try:
                _send_frame(s, KIND_PUB, topic, 0, raw)
            except OSError:
                pass

    def call(self, service: str, cid: int, payload: Payload) -> bool:
        raise RuntimeError("server transport has no uplink")

    def poll(self, topic: str, cid: int) -> List[Payload]:
        raise RuntimeError("server transport has no downlink queues")


class SocketClientTransport(Transport):
    """Client end: `call` is a blocking RPC with ack (explicit failure,
    never the reference's silent drop, DataDriver.cc:70-73); `poll` drains
    broadcast topics received by the reader thread."""

    def __init__(self, cid: int, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0):
        self.cid = int(cid)
        self.timeout = timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.connect((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_frame(self._sock, KIND_HELLO, "", self.cid, b"")
        self._topics: Dict[str, List[Payload]] = defaultdict(list)
        self._acks: Dict[int, bool] = {}
        self._ack_cond = threading.Condition()
        self._seq = 0
        self._dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def close(self):
        self._dead = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _read_loop(self):
        while not self._dead:
            try:
                fr = _recv_frame(self._sock)
            except OSError:
                fr = None
            if fr is None:
                self._dead = True
                with self._ack_cond:
                    self._ack_cond.notify_all()
                return
            kind, name, seq, payload = fr
            if kind == KIND_ACK:
                with self._ack_cond:
                    self._acks[seq] = name == "1"
                    self._ack_cond.notify_all()
            elif kind == KIND_PUB:
                msg = wire.unpack_arrays(payload)
                with self._ack_cond:
                    self._topics[name].append(msg)

    # -- Transport interface (client side) ---------------------------------
    def call(self, service: str, cid: int, payload: Payload) -> bool:
        if self._dead:
            return False
        self._seq += 1
        seq = self._seq
        try:
            _send_frame(self._sock, KIND_CALL, service, seq,
                        wire.pack_arrays(payload))
        except OSError:
            return False
        with self._ack_cond:
            ok = self._ack_cond.wait_for(
                lambda: seq in self._acks or self._dead, timeout=self.timeout
            )
            if not ok or self._dead and seq not in self._acks:
                return False
            return self._acks.pop(seq, False)

    def publish(self, topic: str, payload: Payload) -> None:
        raise RuntimeError("client transport has no broadcast")

    def poll(self, topic: str, cid: int) -> List[Payload]:
        with self._ack_cond:
            msgs = self._topics.pop(topic, [])
        return msgs

    def register_handler(self, service, fn):  # pragma: no cover - server only
        raise RuntimeError("client transport runs no services")

    def register_client(self, cid: int):
        pass
