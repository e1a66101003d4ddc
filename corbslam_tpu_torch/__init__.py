"""PyTorch / CUDA port of the collaborative SLAM engine, for NVIDIA Hopper.

`corbslam_tpu/` (JAX) is the reference; this package computes the same
functions with plain PyTorch around hand-written CUDA kernels
(`csrc/*.cu`, built with nvcc at first use by `kernels.py`). It imports
neither `jax` nor `corbslam_tpu`.

Every public entry point takes a `device` that defaults to "cuda" and raises
when CUDA is missing. Each kernel wrapper dispatches on its input's device: a
CPU tensor runs the plain PyTorch version (the tests' path), a CUDA tensor
launches the kernel.

Ported so far: the stereo ORB front end (`frontend.frame.build_frame_stereo`,
`build_frame_mono`, `ops.orb.extract`) and stereo tracking against the map
(`frontend.track_ops.track_frame_stereo`, `track_frame_stereo2`,
`insert_keyframe_with_points`).
"""
