"""Live image-stream ingest — the ROS live-node capability.

The reference's live front ends subscribe to camera topics and feed the
SLAM system as frames arrive (ref: corbslam_client/Examples/ROS/ORB_SLAM2/
src/ros_stereo.cc:98 message_filters ApproximateTime sync of left/right
image topics -> GrabStereo; ros_mono.cc, ros_rgbd.cc likewise). This module
is the transport-agnostic equivalent:

* `ImageStreamServer` — a publisher process pushes (topic, timestamp,
  image) frames over TCP with a length-prefixed binary framing (same style
  as collab/socket_transport.py — no ROS, no text encoding).
* `ImageStreamClient` — receives frames into per-topic queues.
* `ApproxSync` — pairs frames of two topics whose timestamps fall within a
  slop window, dropping stale unmatched frames: the message_filters
  ApproximateTime policy reduced to the two-stream case the examples use.

The run loop lives in apps/run_stream.py.

A copy of the JAX-free `corbslam_tpu/io/stream.py` in which every socket
wait has a deadline: the publisher's accept (`wait_subscriber(timeout)`)
and sends (SEND_TIMEOUT_S), the subscriber's connect (`connect_timeout`)
and reads. The reader polls in POLL_S steps, so `close()` ends it
promptly, and ends the stream (as an end-of-stream message would) when
nothing has arrived for `idle_timeout` seconds.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

SEND_TIMEOUT_S = 30.0  # a publish that cannot hand its frame to the socket in this time fails
POLL_S = 0.1           # the subscriber's read step: how late close() and the idle deadline act

_HDR = struct.Struct("<IBHdHHB")  # total_len, kind, topic_len, ts, h, w, dtype
KIND_FRAME = 1
KIND_EOS = 2

_DTYPES = {0: np.uint8, 1: np.float32}
_DTYPE_IDS = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}


def _pack_frame(topic: str, ts: float, img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img)
    did = _DTYPE_IDS[img.dtype]
    tb = topic.encode()
    body = (struct.pack("<BHdHHB", KIND_FRAME, len(tb), ts,
                        img.shape[0], img.shape[1], did)
            + tb + img.tobytes())
    return struct.pack("<I", len(body)) + body


def _recv_exact(sock: socket.socket, n: int, alive=lambda: True) -> Optional[bytes]:
    """n bytes from `sock` (whose timeout is the poll step), or None when the
    peer closes or `alive()` turns false between polls."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if not alive():
                return None
            continue
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class ImageStreamServer:
    """Publisher side: accepts one subscriber, pushes frames.

    The ROS analog is the camera driver node publishing image topics; the
    40-second operator sleep the reference needs before replay
    (stereo_kitti.cc:68) disappears — the subscriber connects first, then
    frames flow."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._conn: Optional[socket.socket] = None

    def wait_subscriber(self, timeout: float = 60.0) -> None:
        self._srv.settimeout(timeout)
        self._conn, _ = self._srv.accept()
        self._conn.settimeout(SEND_TIMEOUT_S)
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def publish(self, topic: str, ts: float, img: np.ndarray) -> None:
        assert self._conn is not None, "no subscriber"
        self._conn.sendall(_pack_frame(topic, ts, img))

    def end(self) -> None:
        if self._conn is not None:
            body = struct.pack("<BHdHHB", KIND_EOS, 0, 0.0, 0, 0, 0)
            self._conn.sendall(struct.pack("<I", len(body)) + body)

    def close(self) -> None:
        for s in (self._conn, self._srv):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class ImageStreamClient:
    """Subscriber side: background reader thread fills per-topic queues
    (the rospy subscriber callback queue, queue_size semantics of
    ros_stereo.cc:93-96)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_size: int = 16, connect_timeout: float = 60.0,
                 idle_timeout: float = 60.0):
        self._sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self._sock.settimeout(POLL_S)
        self._idle_timeout = idle_timeout
        self._last_rx = time.monotonic()
        self._closed = threading.Event()
        self._queues: Dict[str, deque] = {}
        self._qsize = queue_size
        self._lock = threading.Lock()
        self._eos = threading.Event()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _alive(self) -> bool:
        return (not self._closed.is_set()
                and time.monotonic() - self._last_rx < self._idle_timeout)

    def _read_loop(self):
        while True:
            hdr = _recv_exact(self._sock, 4, self._alive)
            if hdr is None:
                break
            (ln,) = struct.unpack("<I", hdr)
            body = _recv_exact(self._sock, ln, self._alive)
            if body is None:
                break
            kind, tlen, ts, h, w, did = struct.unpack_from("<BHdHHB", body)
            if kind == KIND_EOS:
                break
            off = struct.calcsize("<BHdHHB")
            topic = body[off:off + tlen].decode()
            img = np.frombuffer(
                body[off + tlen:], _DTYPES[did]).reshape(h, w)
            with self._lock:
                q = self._queues.setdefault(topic, deque(maxlen=self._qsize))
                q.append((ts, img))
            self._last_rx = time.monotonic()
        self._eos.set()

    def pop_all(self, topic: str) -> List[Tuple[float, np.ndarray]]:
        with self._lock:
            q = self._queues.get(topic)
            if not q:
                return []
            out = list(q)
            q.clear()
            return out

    @property
    def ended(self) -> bool:
        return self._eos.is_set()

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._thread.join(timeout)
        try:
            self._sock.close()
        except OSError:
            pass


class ApproxSync:
    """Two-topic approximate-time pairing (message_filters
    ApproximateTime, ros_stereo.cc:98): emit (ts, a, b) for the closest
    cross-topic timestamp pairs within `slop`; frames older than the last
    emitted pair are dropped."""

    def __init__(self, slop: float = 0.02):
        self.slop = slop
        self._a: deque = deque()
        self._b: deque = deque()
        self._last_ts = -np.inf

    def push_a(self, ts: float, img) -> None:
        if ts > self._last_ts:
            self._a.append((ts, img))

    def push_b(self, ts: float, img) -> None:
        if ts > self._last_ts:
            self._b.append((ts, img))

    def pop_pairs(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        out = []
        while self._a and self._b:
            ta, ia = self._a[0]
            tb, ib = self._b[0]
            if abs(ta - tb) <= self.slop:
                out.append((min(ta, tb), ia, ib))
                self._a.popleft()
                self._b.popleft()
                self._last_ts = max(ta, tb)
            elif ta < tb:   # a too old to ever match
                self._a.popleft()
            else:
                self._b.popleft()
        return out
