"""PyTorch / CUDA port of the collaborative SLAM engine, for NVIDIA Hopper.

`corbslam_tpu/` (JAX) is the reference; this package computes the same
functions with plain PyTorch around hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc at first use by `kernels.py`). It imports
neither `jax` nor `corbslam_tpu`.

Every public entry point takes a `device` that defaults to "cuda" and raises
when CUDA is missing. Each kernel wrapper dispatches on its input's device: a
CPU tensor runs the plain PyTorch version (the tests' path), a CUDA tensor
launches the kernel.

Ported so far: the ORB front end and the tracker on its three sensors
(`frontend`), local mapping and triangulation (`mapping`), loop closing,
relocalization and global BA (`loop`, `frontend.reloc`), place recognition
and vocabulary training (`place`), `system.CorbslamClient`, and the
collaboration layer (`collab`: the map-fusion server, the client cache and
the in-process, socket and shared-memory transports; `apps.run_collab`).
"""
