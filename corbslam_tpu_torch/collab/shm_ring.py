"""ctypes binding for the native shared-memory SPSC ring (native/shm_ring.cc);
the port's copy of the JAX package's `collab/shm_ring.py`, with one change:
where the library is built.

The C++ side is the same-host transport lane of the runtime (the reference
runs its client<->server exchange through ROS1 TCPROS even on one host,
corbslam_server/src/main.cpp:49-55; here same-host frames move through an
mmap'd ring with atomic indices — no sockets on the hot path). This module
compiles `native/shm_ring.cc` with g++ on first use into
`build/shmring-<hash of the source and flags>/libshmring.so` at the root of
the checkout (ignored by git, like the CUDA kernels' library) and never
writes into `native/`; an edited source gets a new directory. The ring is
wrapped in a small Ring class.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_LIB = None
_LIB_LOCK = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "shm_ring.cc")
BUILD_ROOT = os.path.join(_ROOT, "build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lrt", "-pthread"]


class ShmRingUnavailable(RuntimeError):
    pass


def lib_path() -> str:
    """Where the library of the current source lives (built or not)."""
    with open(_SRC, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"shmring-{h}", "libshmring.so")


def _build(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ShmRingUnavailable(f"shm_ring build failed: {detail}") from e
    os.replace(tmp, path)
    return path


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(_SRC):
            raise ShmRingUnavailable(f"missing {_SRC}")
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.csr_create.restype = ctypes.c_void_p
        lib.csr_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csr_open.restype = ctypes.c_void_p
        lib.csr_open.argtypes = [ctypes.c_char_p]
        lib.csr_push.restype = ctypes.c_int
        lib.csr_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32]
        lib.csr_pop.restype = ctypes.c_int64
        lib.csr_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_uint64]
        lib.csr_peek.restype = ctypes.c_int64
        lib.csr_peek.argtypes = [ctypes.c_void_p]
        lib.csr_used.restype = ctypes.c_uint64
        lib.csr_used.argtypes = [ctypes.c_void_p]
        lib.csr_close.restype = None
        lib.csr_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class Ring:
    """One direction of a same-host channel (single producer, single
    consumer). `create=True` owns (and unlinks) the shm segment."""

    def __init__(self, name: str, capacity: int = 1 << 22,
                 create: bool = False):
        lib = _lib()
        self._lib = lib
        self.name = name
        if create:
            self._h = lib.csr_create(name.encode(), capacity)
        else:
            self._h = lib.csr_open(name.encode())
        if not self._h:
            raise ShmRingUnavailable(
                f"csr_{'create' if create else 'open'}({name}) failed")

    def push(self, data: bytes) -> bool:
        """False when the ring is full (caller retries); raises if the
        frame can never fit."""
        rc = self._lib.csr_push(self._h, data, len(data))
        if rc == -2:
            raise ValueError(f"frame of {len(data)} bytes exceeds ring capacity")
        return rc == 0

    def pop(self) -> bytes | None:
        n = self._lib.csr_peek(self._h)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.csr_pop(self._h, buf, int(n))
        if got < 0:
            return None
        return buf.raw[:got]

    def used(self) -> int:
        return int(self._lib.csr_used(self._h))

    def close(self):
        if self._h:
            self._lib.csr_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass


def available() -> bool:
    try:
        _lib()
        return True
    except ShmRingUnavailable:
        return False
