"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc for `sm_90a` at first use: one `nvcc -c`
per `.cu` file, all started together, then one link into a shared library
with a plain C interface, loaded with ctypes. The library lands in
`build/kernels-<hash>/` at the root of the checkout, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one does not.
A build failure raises with nvcc's output.

Every C entry takes device pointers and PyTorch's current stream, launches,
and returns `cudaGetLastError()`; `launch` raises when that is not 0 and adds
one to `LAUNCHES[name]` for the kernel it launched. Nothing here falls back to
the plain PyTorch versions: that choice is made by each wrapper from its
input's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts per kernel wrapper, read by chip_smoke.py around the main path.
# "covisibility" counts the K7 launches of the mapping stages
# (`mapstate.covisibility`) apart from the tracking step's ("local_map");
# K10's launches count as "sim3" (a Sim3 attempt, or its RANSAC or refinement
# alone) or "pnp"; K11's as "pose_graph" or "covis_matrix" (the covisibility
# count); K4's entry that finishes every frame's keypoints as
# "finish_keypoints"; K5's area-window mode (mono initialization) as
# "match_area" and its epipolar-band mode (triangulation) as "match_band"; K12's as
# "two_view", K13's as "triangulate"; K14's as "kmajority"; K8's launches
# of global BA as "ba_dense_gba"; K9's launch of a `transform_batch` (a block
# of keyframes) as "vocab_batch"; K10's weighted Horn as "horn".
LAUNCHES = {"pyramid": 0, "fast_cells": 0, "orb_describe": 0, "stereo_match": 0,
            "finish_keypoints": 0, "match_masked": 0, "match_area": 0, "match_band": 0,
            "pose_opt": 0, "local_map": 0, "covisibility": 0, "ba_dense": 0, "vocab": 0,
            "sim3": 0, "pnp": 0, "pose_graph": 0, "covis_matrix": 0, "two_view": 0,
            "triangulate": 0, "kmajority": 0, "ba_dense_gba": 0, "vocab_batch": 0, "horn": 0}

_lib = None
BUILD_INFO: dict = {}

VP = ctypes.c_void_p
I32 = ctypes.c_int
F32 = ctypes.c_float

# C entry points: name -> argtypes (all return int = cudaError_t).
_SIGNATURES = {
    # pyramid.cu
    "build_pyramid": [VP] * 7 + [I32] * 10 + [VP],
    # fast_cells.cu
    "fast_cell_max": [VP] * 4 + [I32] * 3 + [F32] + [I32] * 5 + [VP],
    "fast_topk": [VP] * 11 + [I32] * 6 + [VP],
    # orb_describe.cu
    "orb_describe": [VP] * 11 + [I32] * 4 + [VP],
    # stereo_match.cu
    "stereo_match": [VP] * 11 + [I32] * 3 + [F32, I32, F32] + [VP] * 7 + [VP],
    "finish_keypoints": [VP] * 3 + [I32] * 4 + [F32] * 13 + [VP] * 4 + [VP],
    # match_masked.cu
    "match_select": [VP] * 10 + [F32] + [I32] * 7 + [F32, I32] + [VP] * 8 + [VP],
    # pose_opt.cu
    "pose_opt": [VP] * 6 + [I32] * 3 + [F32] * 5 + [VP] * 4 + [VP],
    # local_map.cu
    "local_scatter_current": [VP, VP, I32, VP, I32, I32, VP, VP, VP],
    "local_candidates": [VP, I32] + [VP] * 3 + [I32] * 3 + [VP, I32] + [VP] * 2 + [VP],
    "local_weights": [VP] * 2 + [I32] * 2 + [VP] * 3 + [I32] + [VP] * 2 + [VP],
    "local_select": [VP] * 3 + [I32] * 5 + [VP] * 3 + [VP],
    "local_points": ([VP] * 2 + [I32] + [VP] * 2 + [I32] + [VP] * 7 + [I32] + [F32] * 4
                     + [I32] * 2 + [VP] + [VP]),
    "local_compact": [VP, I32, I32, VP, VP, VP, VP],
    "local_window_mask": [VP, VP, I32, VP, VP, I32, VP, I32, VP, VP],
    "local_frustum": ([VP] * 2 + [I32] + [VP] * 5 + [F32] * 4 + [I32] * 2 + [F32, I32]
                      + [VP] * 3 + [VP]),
    # ba_dense.cu
    "ba_point_major": [VP, VP] + [I32] * 4 + [VP] * 4 + [VP],
    "ba_optimize": [VP] * 11 + [I32] * 7 + [F32] * 5 + [VP, I32] + [VP] * 6 + [VP],
    # vocab.cu
    "vocab_assign": [VP, I32, VP, I32, VP, I32, VP, I32, I32, VP] + [VP],
    "vocab_hist": [VP, VP, I32, I32, VP, I32, VP] + [VP],
    "vocab_sparse": [VP, VP, I32, VP, I32, VP, VP] + [VP],
    "vocab_l1_scores": [VP, I32, VP, I32, I32, VP] + [VP],
    "vocab_transform_batch": ([VP, VP, I32, I32, VP, I32, VP, I32, VP, I32, VP, VP, I32, VP]
                              + [I32] + [VP] * 3 + [VP]),
    # ransac.cu
    "sim3_attempt": [VP] * 5 + [I32, VP, I32] + [VP] * 3 + [I32] * 4 + [F32] * 8 + [VP] * 7 + [VP],
    "pnp_ransac": [VP] * 4 + [I32, VP, I32, I32] + [F32] * 5 + [VP] * 6 + [VP],
    "horn_weighted": [VP] * 3 + [I32, I32, VP, VP] + [VP],
    # pose_graph.cu
    "pg_linearize": [VP] * 8 + [I32] + [VP] * 2 + [VP],
    "pg_optimize": ([VP] * 4 + [I32] + [VP] * 6 + [I32] + [VP] * 2 + [I32] * 2 + [F32]
                    + [VP] * 2 + [I32] + [VP]),
    "covis_push": [VP] * 3 + [I32] * 3 + [VP] * 3 + [VP],
    "covis_rows": [VP] * 3 + [I32] * 3 + [VP] * 3 + [VP],
    # two_view.cu
    "two_view": [VP] * 3 + [I32, VP, I32, F32, I32] + [F32] * 4 + [VP] * 9 + [VP],
    # triangulate.cu
    "tri_points": [VP] * 4 + [I32, I32] + [VP] * 3 + [I32] + [VP] * 3 + [F32] * 5 + [VP] + [VP],
    # kmajority.cu
    "km_train": [VP] * 3 + [I32] * 4 + [VP] * 4 + [I32, VP] + [VP],
    "km_idf": [VP, I32, VP] + [VP],
}


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for and
    absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them; returns the .so path."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"
    so = out_dir / "libcorbslam_kernels.so"
    if so.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, path=str(so))
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp_so = tmp / so.name
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp_so), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_so, so)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(so), log="\n".join(logs))
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(counter: str, fn: str, *args) -> None:
    """Call C entry `fn`; raise on a CUDA error, else count one launch."""
    err = getattr(lib(), fn)(*args, stream())
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed: cudaError {err}")
    LAUNCHES[counter] += 1


_WORK: dict = {}
# The workspace words of K10's PnP RANSAC and K12: keys and ticket in
# words 0..7, the `%globaltimer` stamps of a -DKERNEL_STAMPS build in 8..23.
STAMPED_WORDS = 24


def workspace(name: str, device, stream: int = 0, words: int = 2) -> torch.Tensor:
    """The words (int64) that kernel `name` keeps between launches on one
    stream (a best-hypothesis key, a CTA ticket, ...): zeros when made, kept
    from call to call, the launch's last CTA setting them back to 0. K10's
    Sim3 attempt ("sim3") and PnP RANSAC ("pnp") and K12 ("two_view") each
    have their own. A call asking for more words than the stream's
    workspace holds gets a larger one (zeros, made on the current stream)."""
    key = (name, torch.device(device), stream)
    work = _WORK.get(key)
    if work is None or work.numel() < words:
        work = _WORK[key] = torch.zeros(words, dtype=torch.int64, device=device)
    return work


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel operand before its pointer is passed to C: on
    `device` (any CUDA device when None), of `dtype` and `shape`, and
    contiguous when on CUDA. A wrapper whose plain version checks its CPU
    operands the same way passes their device."""
    if (t.device != device) if device is not None else not t.is_cuda:
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
