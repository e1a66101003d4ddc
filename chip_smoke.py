"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the environment and the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from corbslam_tpu_torch/csrc/ (nvcc) and
   prints nvcc's register, spill and stack-frame bytes per kernel (K6's,
   K2's, K11's pose graph and covisibility count, K5's, K1's, K4's (both
   entries), K3's, K10's Sim3 attempt and PnP RANSAC, K12's, K13's and
   K14's kernels must not spill, and K6's, K11's, K1's, K4's, K3's, the Sim3
   attempt's, PnP's, K12's, K13's and K14's have no stack frame);
3. drives the front end — `build_frame_stereo` through `entry.entry()` — on
   3 warm-up and 20 timed stereo frames with all launch counters reset just
   before, checks its kernels were launched (K1, K4's stereo match and K4's
   `finish_keypoints` once a frame), the outputs are finite and the feature
   / stereo counts are sane; every other path also makes one
   `finish_keypoints` launch a frame (the tracking path, the tracker, mono
   and RGB-D);
4. drives the tracking path — `track_frame_stereo` through
   `entry.track_entry()`: the bench camera, KITTI_STEREO at full capacity and
   the bench's PlanarWorld rendered on the card — with all counters reset
   just before: frame 0 seeds the map, frames 1..20 are tracked with a
   keyframe inserted after frames 5, 10, 15 and 20; checks every frame is
   ok with >= 1000 local-map inliers and a camera-centre error <= 0.075 m,
   all seven kernels were launched and the outputs are finite; prints the
   tracked-frame times;
5. holds the front end's entry frame, and tracked frames 1..3, against the
   plain path run on the CPU from the same state;
6. holds each kernel against its plain PyTorch version on the card, on the
   same inputs at the flagship shapes (1241x376, 2048 features, 8 levels,
   both stereo images; for K5..K7 the calls of tracked frame 12: 2048 x 2048
   frame-to-frame and descriptor matching, 2048 x 8192 projection matching,
   2048-observation pose LM, the local map over 131072 points, also with a
   1024-row window so that the compaction truncates), and times
   the kernel's wrapper, the plain version and, where one PyTorch call
   computes the same function, that call; K7's launches also one by one
   (each C entry of one wrapper call replayed alone). K6 (two runs on one
   input bit-equal, the cost within 1e-3) and K2 are also held against
   their plain versions at their edges: K6 with 1, 2048, 2049 and 8192
   observations, none valid and most behind the camera; K2 on a flat
   image, at 97x131 with 12-px cells and with levels over and under their
   budgets. K5 is also held to its plain version, exactly, at its edges
   (`match_edges`: Nq 1, Nt 2 and Nt 1 refused, a ragged tile and chunk,
   Nq 12288 with the rotation check, every target masked, equal-distance
   ties, 6 band batches with and without the epipole guard, the mutual and
   rotation checks each on and off in modes 0-2, and its workspace left
   empty). K6's row is timed as a replayed CUDA graph (its cluster
   launch). The other times are device times
   (torch.profiler: the summed time of every kernel and copy a call runs on
   the card; where that reads under 0.05 ms, whose profiler sums disagree
   from run to run, or where two profiler sessions record nothing, the
   replay of a CUDA graph of up to 100 calls between CUDA events); the
   host-inclusive time of the wrappers (CUDA events around
   eager calls) is printed beside them. K1, K3 and K4 make one launch a
   call; K3's patch, angle and descriptor buffers on the entry pair are
   printed as hashes (to compare trees bit for bit).
   The stereo kernel is also held against its plain version where every
   feature passes, so that its median cut is live, and on the edge cases of
   its row buckets (`kernel_times.stereo_edge_cases`); K1-K4 also at
   120x200 and at the orbits' 320x240;
7. drives loop closing, the loop path's main path: `entry.loop_entry()`
   (the 320x240 loop-validation config, the shipped vocab32k, global BA
   off, the room `MultiPlaneWorld` rendered on the card) over the 71-frame
   orbit with all counters reset just before, then a frame marked LOST by
   hand and one more frame; checks every orbit frame OK, a loop closed
   between keyframes more than 20 rows apart and within 3 rows of the JAX
   yardstick's 48 <-> 7, the aligned ATE <= 2 x its 0.0693 m, finite
   keyframe poses, the LOST frame relocalized, K9-K11 launched, one K10
   launch a Sim3 attempt and one a relocalization candidate (its PnP
   RANSAC); prints the detections, attempts (beside JAX's 146), sim3 log,
   relocalizations and candidates tried, the keyframe ATE after the
   closure and each loop stage's and the closure's time. Then the
   flagship schedule again with a loop closer attached (the 256 MB
   [2048, 32768] database on the card): keyframes and points must equal the
   run without it, and the ATE (within 1e-4 m) that of a run whose
   keyframes queue an idle stage in place of the loop-closing stage, which
   shifts the later mapping stages by frames;
8. drives the tracker's other two sensors at the flagship's width
   (`entry.sensor_entry`: the same camera, KITTI_STEREO and
   world, one frame per call through `process_mono` / `process_rgbd`), all
   counters reset just before each: mono over 30 frames (bootstrap at
   frame 5 +- 1 as the JAX yardstick, every later frame OK, 5 +- 1
   keyframes, similarity-aligned ATE <= 2 x 0.323 m, a finite map, K5's
   area and band modes, K12 (one launch an attempt), K13 and K8 launched;
   the bootstrap's time, each
   create_new_points call's time, frame p50 / p90 and the points printed)
   and RGB-D over 40 frames (every frame OK, 2 keyframes, points within 1 %
   of 2906, ATE <= 2 x 0.00426 m); then holds K12
   (the mono bootstrap's own matches, H branch, the same with every row of
   its draw degenerate so that the scores tie, and a seeded non-planar
   scene, F branch; one launch an attempt, two runs bit-equal, its outputs'
   hash printed; at its edges: N = 1, N at its capacity of 4096 and one
   past it refused, N = 1000, no valid match, two degenerate rows, an
   all-degenerate draw), K5's band mode (the keyframe against its 8 neighbour
   slots, 8 x 2048 x 2048) and K13 on a clone of the map at the first
   create_new_points call (K13 also at its edges: a tied pair of slots,
   K = 1, K = 11, F = 2047), K5's area mode (2048 x 2048) and K4's
   `finish_keypoints` (bit for bit, with the entry camera and with a
   distorted one, on the flagship's stereo frame, the last RGB-D frame and
   a mono frame, and at its edges: N = 1, every feature invalid, every
   depth at or under min_depth, keypoints at x.5 on the image border)
   against their plain versions, and times them;
9. holds K9-K11 against their plain versions on the loop phase's first
   closure (its match set, essential graph and map, PnP and relocalize on
   the LOST frame) and at the flagship's sizes (2048 features against the
   whole database, a Sim3 attempt (RANSAC, refinement and their combine in
   one launch, each stage alone too, two runs bit-equal) and PnP on 2048
   matches (one launch a RANSAC, two runs bit-equal, its outputs' hash
   printed; also at its edges: N = 1, N at its capacity of 8192 and one
   past it refused, N = 1000, no valid match, two degenerate rows, an
   all-degenerate draw whose counts tie), the covisibility count of
   the final map, its essential graph of 2048 vertices and 18464 edges with
   a synthetic loop edge), and times those full-width calls (K11's
   cooperative launch with CUDA events); K11 (two runs bit-equal) also at
   its edges (`pose_graph_edges`: 64, 512 and 2048 live rows of 2048, every
   vertex fixed, no weighted edge, E not a multiple of the grid, fewer
   edges than CTAs, one vertex with all 32 loop slots);
10. drives the three end-to-end loop orbits of the reference's
   tests/test_loop_e2e.py through the port's CorbslamClient
   (`entry.e2e_entry`: the 320x240 loop config, the room with photometric
   noise, a 1024-word vocabulary trained on the card by K14 from three
   frames, loop closing with global BA on K8 at C 256 / Fb 512), all
   counters reset just before each training: the stereo lap (151 frames,
   synchronous GBA; a loop more than 20 rows apart, frames 2.. OK, finite
   orthonormal keyframe poses, keyframe ATE < 0.12 m and < 1.4 x the frame
   ATE), 2.5 laps (158 frames, asynchronous GBA on its own stream: >= 2
   loops, >= 2 GBA runs, one finished or aborted, nothing left unmerged,
   keyframe ATE < 0.25 m) and the mono lap (151 frames; the reference's
   gates — free-scale Sim3, a loop more than 20 rows apart, every accepted
   s in (0.7, 1.4), similarity keyframe ATE < 0.9 m — are reported; since
   the reference itself meets them with its fixture's draw only, the run
   enforces the free scale, the bootstrap, finite orthonormal poses and
   the training and BoW launches; tests/e2e_mono_seeds.py runs it for more
   client seeds); prints for each the loop rows, the GBA
   runs, each GBA chunk's time (CUDA events on the GBA stream), each
   closure's, frame p50 / p90 and the launches; then holds K14 against its
   plain version on the stereo run's training (its centres are the run's
   vocabulary; and with row weights), B17 on the stereo lap's and the 2.5
   laps' maps, K14 and B17 at their edges (`km_edge_inputs`,
   `covis_edge_maps`), K8 against optimize_plain on that
   run's first GBA chunk (one LM iteration and the 2-iteration chunk), K8
   at bench.py's bench_gba shape (its 1536-keyframe, 196608-point map made
   from seed 0 in the port's MapState, through build_global_problem_dense:
   C 1536, Fb 512; one LM iteration, its points held to the plain
   version's own one-ulp spread, and a 2-iteration chunk run twice
   bit-equal), and K14 at the full width: a ~400k-descriptor
   corpus of the port's front end over both images of 120 frames of the
   flagship world trained 2-level at G 1024 x B 32 (level-1 centres,
   grouping, words, child table and idf exact), `train_chunked` at 32768
   words over that corpus (words and idf exact) and `build_tree` over the
   shipped vocab32k (groups exact), and times those rows (their launches
   are one call's: no path runs them);
11. drives the collaboration layer (`apps.run_collab`: the JAX package's
   collaboration config, 320x240, 512 features, 4 levels, 256 keyframes,
   32768 points, the shipped vocab32k; stereo clients without loop closing
   syncing through the in-process transport with a `MapFusionServer` on the
   card) with 2 and then 4 clients over 30 frames, all counters reset just
   before each: every client's keyframes reach the server, gids unique and
   poses and points finite on every map, every client fused and its
   alignment known, one batched K9 assignment and one histogram launch a
   `transform_batch` (a query block of up to 256 sub-map keyframes or an
   inserted chunk), one weighted-Horn launch a `detect_overlap`, no plain
   version of a kernel function on the way, and each alignment putting the
   client's map points less than half as far from their true place as no
   alignment would (median error under half the start offset's length);
   with 2 clients also the JAX yardstick: its fusions, each alignment within
   2x JAX's error against the known start offsets (or 0.05 m / 5e-3 rad),
   global keyframes within 1. Prints each client's frame
   p50 / p90, the server steps' times (host clock and CUDA events), the
   uplinks and downlinks and the server path's launches. Then one fusion at
   the flagship's width: the tracker phase's final map as client 1 and the
   same map moved by a known SE3 as client 2, through a serializing
   transport into a server with synchronous global BA (K9 batched over the
   sub-map's keyframes against N 2048, W 32768; K8 on the global map): the
   Sim3 recovered to 5e-3 in R and scale and 5e-2 m in t, fewer points than
   the union, one seam fuse and one essential graph, client 1 receiving client 2's keyframes, fixed.
   Last, batched K9 (word ids exact, BoW 1e-6) and the weighted Horn (R and
   s 1e-5, t 1e-4 m) against their plain versions on both runs' inputs and
   at their edges, and their timed rows;
12. drives the endurance run (`entry.endurance_entry` / `run_endurance`:
   the bench's 1050 frames, ~8.3 laps of the occluded, shaded SceneWorld
   room rendered on the card, a 256-row keyframe table the run overflows,
   a 1024-word vocabulary trained by K14 from three frames, loop closing
   and asynchronous global BA), all counters reset just before the
   training, fed as the bench feeds it: frames 1.. OK but at most 1 % LOST
   frames that relocalize, no reset, a compaction, a compaction that meets
   a running global BA (if none comes naturally, one is forced on the final
   map: the GBA launched with its first chunk held, then a compaction while
   it is busy) counted as aborted with nothing merged, the loop edges,
   database rows and last loop live after every compaction, >= 4 loops
   within 3 of the JAX CPU yardstick's count on the same words, a finished
   GBA run, finite orthonormal keyframe poses, no GBA thread alive after
   the shutdown, keyframe ATE <= 2 x the yardstick's, every kernel of the
   path launched; prints fps (frames 100..1049, rendering included), frame
   p50 / p90 / max, the loops' rows, GBA runs, compactions, the launches
   over the run, and writes the trained vocabulary to
   chiprun_out/endurance_vocab.npz. The loop count turns on the words, the
   draws and the frame a GBA result lands on, in JAX as in the port (the
   port's loop closer makes the reference's decisions on the reference's
   maps: tests/yardstick_endurance.py --lockstep), so each yardstick is
   the JAX run on the words the port's run used, tied to them by their
   hash: the entry's words against JAX's run on them, then a second run of
   the same frames on the bench's own words
   (assets/endurance_bench_words.npz) against the bench's run (its loop,
   ATE, reset and frame gates).
   Then the checkpoint: `save_map` of the final map (tables bit-equal),
   20 further frames of the original client under torch.profiler (device
   time, idle share and launches a frame), `load_map` into a fresh client
   with the same vocabulary (tables bit-equal), which must relocalize
   within 3 frames (K9, K10's PnP, K6), stay OK, and track frames
   1050..1059 within 0.05 m / 0.01 rad of the original client. Then the
   apps: `run_client` over 30 synthetic flagship frames with loop closing
   (30 x 12 KITTI rows, 30 metrics lines, every frame OK), `train_vocab`
   on three small worlds, SceneWorld among them, through K14's
   hierarchical path (its artifact read back equal), and `run_stream`'s
   publisher (a thread) and node on loopback for 10 frames (every tracked
   frame OK);
13. writes every measurement (per-frame times and counts, nvcc's full
   -Xptxas -v log) to chiprun_out/chip_smoke_report.json in the checkout,
   and prints the kernels' JSON line, the nvidia-smi line, and as the last
   line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero without the last line.
Without CUDA it exits non-zero before printing anything of a result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from corbslam_tpu_torch import kernels  # noqa: E402
from corbslam_tpu_torch.apps import run_collab  # noqa: E402
from corbslam_tpu_torch.collab import fusion_ops  # noqa: E402
from corbslam_tpu_torch.collab.client_cache import ClientCache  # noqa: E402
from corbslam_tpu_torch.collab.server import MapFusionServer  # noqa: E402
from corbslam_tpu_torch.collab.transport import InProcTransport  # noqa: E402
from corbslam_tpu_torch.config import CapacityConfig  # noqa: E402
from corbslam_tpu_torch.entry import (  # noqa: E402
    BENCH_FRAMES, BENCH_WARM, BENCH_WINDOW, CAM, CFG, E2E_RADIUS, E2E_TRAIN_ITERS, E2E_WORDS,
    LOOP_FRAMES, MONO_FRAMES, RGBD_FRAMES, TrackState, add_keyframe, bench_config, center_error,
    e2e_entry, endurance_entry, endurance_frame, entry, gt_pose, live_rows_ok, loop_config,
    loop_entry, orbit_pose, run_bench_schedule, run_e2e, run_endurance, run_sensor, seed_map,
    sensor_entry, stereo_pair, track_entry, track_step, tracker_entry)
from corbslam_tpu_torch.frontend import frame as frame_mod  # noqa: E402
from corbslam_tpu_torch.frontend import reloc, track_ops  # noqa: E402
from corbslam_tpu_torch.frontend.tracking import StereoTracker  # noqa: E402
from corbslam_tpu_torch.frontend.tracking import TrackState as TrackerState  # noqa: E402
from corbslam_tpu_torch.geometry import camera, se3, sim3  # noqa: E402
from corbslam_tpu_torch.io import trajectory  # noqa: E402
from corbslam_tpu_torch.kernel_times import (  # noqa: E402
    degenerate_rows, digest, flagship_graph, pnp_edge_inputs, pnp_full_width, pnp_scene,
    recorded_buffers, recorded_launches, ring_graph, sim3_full_width, stereo_edge_cases,
    two_view_edge_inputs)
from corbslam_tpu_torch.loop import gba, loop_closing  # noqa: E402
from corbslam_tpu_torch.mapping import local_mapping, triangulation  # noqa: E402
from corbslam_tpu_torch.mapstate import covisibility as covis  # noqa: E402
from corbslam_tpu_torch.mapstate import mapstate as ms  # noqa: E402
from corbslam_tpu_torch.matching import matcher  # noqa: E402
from corbslam_tpu_torch.ops import brief, descriptors, fast, orb, pyramid, stereo  # noqa: E402
from corbslam_tpu_torch.ops.orb import Features  # noqa: E402
from corbslam_tpu_torch.optim import ba_dense, pose_graph, pose_opt, reproj  # noqa: E402
from corbslam_tpu_torch.place import database, vocab  # noqa: E402
from corbslam_tpu_torch.solvers import initializer, pnp, sim3_solver  # noqa: E402
from corbslam_tpu_torch.system import CorbslamClient  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 and f64 rates outside
# the tensor cores, and the dense int8 tensor-core rate (K14's inner
# products, counted as the int8 product the reference makes of them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
INT8_OPS_PER_S = 1979e12

# Where each kernel's TPU-shaped reference lives (the JAX functions it replaces).
REPLACES = {
    "pyramid": "corbslam_tpu/ops/pyramid.py:88",
    "fast_cells": "corbslam_tpu/ops/fast.py:180",
    "orb_describe": "corbslam_tpu/ops/brief.py:149",
    "stereo_match": "corbslam_tpu/ops/stereo.py:38",
    "match_masked": "corbslam_tpu/matching/matcher.py:75",
    "pose_opt": "corbslam_tpu/optim/pose_opt.py:60",
    "local_map": "corbslam_tpu/frontend/track_ops.py:220",
    "covisibility": "corbslam_tpu/mapstate/covisibility.py:145",
    "ba_dense": "corbslam_tpu/optim/ba_dense.py:434",
    "vocab": "corbslam_tpu/place/vocab.py:447",
    "sim3": "corbslam_tpu/solvers/sim3_solver.py:233",
    "pnp": "corbslam_tpu/solvers/pnp.py:116",
    "pose_graph": "corbslam_tpu/optim/pose_graph.py:78",
    "covis_matrix": "corbslam_tpu/mapstate/covisibility.py:66",
    "finish_keypoints": "corbslam_tpu/ops/stereo.py:104",
    "match_area": "corbslam_tpu/matching/matcher.py:241",
    "match_band": "corbslam_tpu/matching/matcher.py:291",
    "two_view": "corbslam_tpu/solvers/initializer.py:187",
    "triangulate": "corbslam_tpu/mapping/triangulation.py:61",
    "kmajority": "corbslam_tpu/place/vocab.py:59",
    "kmajority_l1": "corbslam_tpu/place/vocab.py:229",
    "kmajority_l2": "corbslam_tpu/place/vocab.py:229",
    "kmajority_tree": "corbslam_tpu/place/vocab.py:349",
    "ba_dense_gba": "corbslam_tpu/optim/ba_dense.py:434",
    "ba_dense_bench_gba": "corbslam_tpu/optim/ba_dense.py:434",
    "vocab_batch": "corbslam_tpu/place/vocab.py:503",
    "horn": "corbslam_tpu/solvers/sim3_solver.py:30",
}
SOURCES = {k: f"corbslam_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCES["covisibility"] = "corbslam_tpu_torch/csrc/local_map.cu"  # K7's mapping-stage launches
SOURCES["sim3"] = SOURCES["pnp"] = "corbslam_tpu_torch/csrc/ransac.cu"  # K10
SOURCES["covis_matrix"] = "corbslam_tpu_torch/csrc/pose_graph.cu"  # K11's covisibility count
SOURCES["finish_keypoints"] = "corbslam_tpu_torch/csrc/stereo_match.cu"  # K4's finishing entry
SOURCES["match_area"] = "corbslam_tpu_torch/csrc/match_masked.cu"  # K5's area-window mode
SOURCES["match_band"] = "corbslam_tpu_torch/csrc/match_masked.cu"  # K5's epipolar-band mode
for _k in ("kmajority_l1", "kmajority_l2", "kmajority_tree"):  # K14 at the full-width shapes
    SOURCES[_k] = "corbslam_tpu_torch/csrc/kmajority.cu"
SOURCES["ba_dense_gba"] = "corbslam_tpu_torch/csrc/ba_dense.cu"  # K8 at global BA's size
SOURCES["ba_dense_bench_gba"] = "corbslam_tpu_torch/csrc/ba_dense.cu"  # K8 at bench_gba's size
SOURCES["vocab_batch"] = "corbslam_tpu_torch/csrc/vocab.cu"  # K9 over a block of keyframes
SOURCES["horn"] = "corbslam_tpu_torch/csrc/ransac.cu"  # K10's weighted Horn
FRONT_END_KERNELS = ("pyramid", "fast_cells", "orb_describe", "stereo_match", "finish_keypoints")
TRACKING_KERNELS = FRONT_END_KERNELS + ("match_masked", "pose_opt", "local_map")
REPORT = os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The kernel's own name from a mangled one: the last `_kernel`
    identifier of its length-prefixed nested name (`_ZN<len><namespace>
    19sim3_attempt_kernelE...` -> sim3_attempt_kernel), else the name as it is."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else len(mangled)
    names = []
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        names.append(mangled[start:start + int(m.group())])
        pos = start + int(m.group())
    names = [n for n in names if n.endswith("_kernel")]
    return names[-1] if names else mangled


def ptxas_summary(log: str) -> dict:
    """{kernel: (registers, spill bytes, stack frame bytes)} from nvcc's
    -Xptxas -v output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
            out.setdefault(fn, [0, 0, 0])  # a template's instances: their largest numbers
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                    r"(\d+) bytes spill loads", line)):
            out[fn][1] = max(out[fn][1], int(m.group(2)) + int(m.group(3)))
            out[fn][2] = max(out[fn][2], int(m.group(1)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn][0] = max(out[fn][0], int(m.group(1)))
    return out


# The kernels redesigned for the card must not spill, and K6's (its 6x6
# solve in registers), K11's (its 7x7 blocks and dual numbers in
# registers), K1's, K4's, K3's, K10's Sim3 attempt (its 7x7 solve in
# shared memory) and PnP RANSAC (its f64 DLT in registers and shared
# memory), K12's (its warp LU in shared memory) and K10's weighted Horn (its
# power iteration in registers) have no stack frame at all.
NO_SPILL = ("pose_opt_kernel", "fast_cell_max_kernel", "fast_topk_kernel", "pg_optimize_kernel",
            "match_select_kernel", "pyramid_kernel", "stereo_match_kernel", "orb_describe_kernel",
            "sim3_attempt_kernel", "pnp_ransac_kernel", "two_view_kernel", "km_train_kernel",
            "covis_push_kernel", "covis_rows_kernel", "finish_keypoints_kernel",
            "tri_points_kernel", "horn_weighted_kernel")
NO_STACK = ("pose_opt_kernel", "pg_optimize_kernel", "pyramid_kernel", "stereo_match_kernel",
            "orb_describe_kernel", "sim3_attempt_kernel", "pnp_ransac_kernel", "two_view_kernel",
            "km_train_kernel", "covis_push_kernel", "covis_rows_kernel", "finish_keypoints_kernel",
            "tri_points_kernel", "horn_weighted_kernel")


def check_ptxas(ptxas: dict) -> None:
    """Holds NO_SPILL to 0 spill bytes and NO_STACK to no stack frame; a
    cached build prints no ptxas log and is not checked."""
    if not ptxas:
        return
    for name in NO_SPILL:
        require(name in ptxas, f"ptxas log has no {name}")
        require(ptxas[name][1] == 0, f"{name} spills {ptxas[name][1]} bytes")
    for name in NO_STACK:
        require(ptxas[name][2] == 0, f"{name} has a {ptxas[name][2]}-byte stack frame")


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one eager fn() call, CUDA events around `reps` calls:
    host launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3):
    """Mean device time of one fn() call: the summed time of every kernel,
    copy and fill it runs on the card (torch.profiler), host time left out.
    CUPTI now and then returns no device events for a profiler session: such
    a session is run once more, and None is returned if that one records no
    device time either."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.device_time_total for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        print(f"torch.profiler recorded no device time for "
              f"{getattr(fn, '__qualname__', repr(fn))} (session {attempt + 1})", flush=True)
    return None


def bound_ms(n_bytes: float, n_ops: float, n_f64_ops: float = 0.0, n_int8_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak rate for their type
    (f32, and f64 where the kernel computes in double, on the CUDA cores;
    int8 on the tensor cores, which run beside them)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((n_ops / F32_OPS_PER_S + n_f64_ops / F64_OPS_PER_S) * 1e3,
                n_int8_ops / INT8_OPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the same inputs
# ---------------------------------------------------------------------------

def describe_bytes(pyr, kp, angle, prm) -> int:
    """Bytes K3 must move, each pixel counted once: the union of level pixels
    the 32x32 raw patches cover and of blurred pixels the steered BRIEF pairs
    read (this run's keypoints and angle bins), plus the keypoint fields and
    the offset and level tables in and the patch, angle and descriptor out."""
    B, N = kp.cell_id.shape
    dev = pyr.levels.device
    raw = torch.zeros(B, prm.total, dtype=torch.bool, device=dev)
    blur = torch.zeros_like(raw)
    r = torch.arange(-brief.RAW_PATCH // 2, brief.RAW_PATCH // 2, device=dev)
    offs = prm.brief_offsets.long()  # [bins, 256, 2, 2] (bin, pair, endpoint, (dy, dx))

    def mark(mask, b, lvl, ys, xs):
        h, w = prm.shapes[lvl]
        ys, xs = torch.broadcast_tensors(ys, xs)
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        mask[b, prm.offsets[lvl] + (ys * w + xs)[inside]] = True

    for b in range(B):
        for lvl in range(prm.n_levels):
            k0, k = prm.kp_offsets[lvl], prm.budgets[lvl]
            x, y = brief.level_coords(kp, prm, b, lvl)
            mark(raw, b, lvl, y[:, None, None] + r[None, :, None], x[:, None, None] + r[None, None, :])
            sel = offs[brief.angle_bin(angle[b, k0:k0 + k])]  # [k, 256, 2, 2]
            mark(blur, b, lvl, y[:, None, None] + sel[..., 0], x[:, None, None] + sel[..., 1])
    n_px = int(raw.sum()) + int(blur.sum())
    tables = prm.brief_offsets.numel() + prm.level_table.numel() * 4
    return 4 * n_px + tables + B * N * (16 + 4 * brief.RAW_PATCH ** 2 + 4 + 32)


def check_kernels(imgs: torch.Tensor, prm, timed: bool = True) -> tuple[list, dict]:
    """Hold K1..K4 against their plain versions on `imgs` ([2, H, W] on the
    card); with `timed`, also time kernel, plain version and library call and
    compute each kernel's bound, one row per kernel."""
    B, H, W = imgs.shape
    N = prm.n_features
    rows = []

    def row(name, err, kernel_fn, plain_fn, library_fn, bound, plain_reps=20, **extra):
        if timed:
            rows.append(dict(name=name, max_abs_err=err, bound=bound,
                             fns=(kernel_fn, plain_fn, library_fn, plain_reps), **extra))

    # K1 pyramid ---------------------------------------------------------
    pyr_k = pyramid.build_pyramid(imgs, prm)
    pyr_p = pyramid.build_pyramid_plain(imgs, prm)
    torch.cuda.synchronize()
    err = max((pyr_k.levels - pyr_p.levels).abs().max().item(),
              (pyr_k.blurred - pyr_p.blurred).abs().max().item())
    require(err <= 1e-3, f"pyramid: max |kernel - plain| {err} > 1e-3")

    F = torch.nn.functional
    k1 = torch.from_numpy(pyramid.gaussian_kernel_1d()).to(imgs.device)
    k2 = (k1[:, None] * k1[None, :])[None, None]

    def library_pyramid():
        prev = imgs[:, None]
        for lvl, hw in enumerate(prm.shapes):
            if lvl:
                prev = F.interpolate(prev, size=hw, mode="bilinear", align_corners=False,
                                     antialias=False)
            F.conv2d(F.pad(prev, (3, 3, 3, 3), mode="reflect"), k2)

    # K1 and K4 are one launch a call.
    require(launches_of(lambda: pyramid.build_pyramid(imgs, prm), "pyramid") == 1,
            "pyramid: more than one launch a call")

    # Resize: 6 flops per output pixel of levels >= 1; blur: 2 x 7 multiply-adds
    # per pixel of every level. Bytes: the images in, all levels (level 0 the
    # images' copy) and blurred levels out.
    pix = prm.total
    row("pyramid", err, lambda: pyramid.build_pyramid(imgs, prm),
        lambda: pyramid.build_pyramid_plain(imgs, prm), library_pyramid,
        bound_ms(4 * B * (H * W + 2 * pix), B * (6 * (pix - H * W) + 28 * pix)))

    # K2 fast_cells ------------------------------------------------------
    kp_k = fast.detect_pyramid(pyr_k, prm)
    kp_p = fast.detect_pyramid_plain(pyr_k, prm)
    torch.cuda.synchronize()
    for name in fast.Keypoints._fields:
        a, b = getattr(kp_k, name), getattr(kp_p, name)
        require(torch.equal(a, b.to(a.dtype)),
                f"fast_cells: field {name} differs in {(a != b.to(a.dtype)).sum().item()} places")
    # Per pixel: 16 ring differences, the arc min/max as the reference's
    # log-depth tree (2 x 77), 2 x 15 for the max/min over the 16 arcs,
    # 4 for the score, 9 for NMS; bytes: levels in, 29 bytes per slot out.
    row("fast_cells", 0.0, lambda: fast.detect_pyramid(pyr_k, prm),
        lambda: fast.detect_pyramid_plain(pyr_k, prm), None,
        bound_ms(4 * B * pix + 29 * B * N, B * pix * (16 + 154 + 30 + 4 + 9)), plain_reps=5)

    # K3 orb_describe ----------------------------------------------------
    patch_k, angle_k, desc_k = brief.describe(pyr_k, kp_k, prm)
    patch_p, angle_p, desc_p = brief.describe_plain(pyr_k, kp_k, prm)
    torch.cuda.synchronize()
    require(launches_of(lambda: brief.describe(pyr_k, kp_k, prm), "orb_describe") == 1,
            "orb_describe: more than one launch a call")
    k3_hashes = dict(patch=digest(patch_k), angle=digest(angle_k), desc=digest(desc_k))
    require(torch.equal(patch_k, patch_p), "orb_describe: raw patches differ")
    angle_err = (angle_k - angle_p).abs().max().item()
    same_bin = brief.angle_bin(angle_k) == brief.angle_bin(angle_p)
    flips = (~same_bin).float().mean().item()
    require(flips <= 0.005, f"orb_describe: {flips:.4%} angle-bin flips > 0.5%")
    require(torch.equal(desc_k[same_bin], desc_p[same_bin]),
            "orb_describe: descriptors differ where the angle bins agree")
    # 4 flops per patch pixel for the two moments, 256 compares per keypoint.
    row("orb_describe", angle_err, lambda: brief.describe(pyr_k, kp_k, prm),
        lambda: brief.describe_plain(pyr_k, kp_k, prm), None,
        bound_ms(describe_bytes(pyr_k, kp_k, angle_k, prm), B * N * (4 * 1024 + 256)),
        plain_reps=5, angle_bin_flips=flips)

    # K4 stereo_match ----------------------------------------------------
    f = Features(kp_k.xy, kp_k.resp, angle_k, kp_k.octave, desc_k, kp_k.valid, patch_k)
    fl, fr = f.select(0), f.select(1)
    bf = float(CAM.bf)
    m_k, u_err, d_err = check_stereo(fl, fr, prm.scales, bf)
    require(launches_of(lambda: stereo.stereo_match(fl, fr, prm.scales, bf), "stereo_match") == 1,
            "stereo_match: more than one launch a call")
    # Candidate pairs that pass the row/disparity/octave/validity mask need
    # 8 XOR + 8 popcount + 7 adds; every pair needs ~8 ops of mask test.
    disp = fl.xy[:, None, 0] - fr.xy[None, :, 0]
    n_masked_in = int((((fl.xy[:, None, 1] - fr.xy[None, :, 1]).abs()
                        <= 2.0 * prm.scales[fr.octave.long()][None, :])
                       & (disp >= -1.0) & (disp <= 192.0)
                       & ((fl.octave[:, None] - fr.octave[None, :]).abs() <= 1)
                       & fl.valid[:, None] & fr.valid[None, :]).sum().item())
    Nl, Nr = fl.xy.shape[0], fr.xy.shape[0]
    # Bytes: xy, octave, valid and descriptor of both sides; the 11x11 centre
    # window of every left patch and the 11x21 slide window of each right
    # patch chosen at least once; idx, dist, u_right, depth and ok out.
    n_right_used = int(torch.unique(m_k.idx).numel())
    row("stereo_match", u_err, lambda: stereo.stereo_match(fl, fr, prm.scales, bf),
        lambda: stereo.stereo_match_plain(fl, fr, prm.scales, bf), None,
        bound_ms((Nl + Nr) * (8 + 4 + 1 + 32) + 4 * (Nl * 121 + n_right_used * 231) + Nl * 17,
                 8 * Nl * Nr + 23 * n_masked_in + Nl * 11 * 121 * 3),
        depth_max_abs_err=d_err, candidate_pairs=n_masked_in, right_patches_used=n_right_used)

    time_rows(rows)
    return rows, dict(ok_count=int(m_k.ok.sum()), valid_count=int(kp_k.valid[0].sum()),
                      padded_slots=int((kp_k.resp == 0).sum()), k3_hashes=k3_hashes)


def check_stereo(fl, fr, scales, bf):
    """K4 against its plain version on the card: idx, dist and ok exact,
    u_right and depth within 1e-3 (the same f32 operations in the same
    order; depth differs only by PyTorch's scalar division, which multiplies
    by the reciprocal)."""
    m_k = stereo.stereo_match(fl, fr, scales, bf)
    m_p = stereo.stereo_match_plain(fl, fr, scales, bf)
    torch.cuda.synchronize()
    require(torch.equal(m_k.idx, m_p.idx), "stereo_match: match indices differ")
    require(torch.equal(m_k.dist, m_p.dist), "stereo_match: distances differ")
    require(torch.equal(m_k.ok, m_p.ok), "stereo_match: ok masks differ")
    u_err = (m_k.u_right - m_p.u_right).abs().max().item()
    d_err = (m_k.depth - m_p.depth).abs().max().item()
    require(u_err <= 1e-3, f"stereo_match: max |u_right kernel - plain| {u_err} > 1e-3")
    require(d_err <= 1e-3, f"stereo_match: max |depth kernel - plain| {d_err} > 1e-3")
    return m_k, u_err, d_err


def check_stereo_median(prm, n_noisy: int = 40) -> dict:
    """K4 where every feature passes before the cut, so K4's last CTA takes
    the median (the two middle values averaged for even N) and the 2.1 x
    median cut is live: every left feature has an exact right twin 7 px to
    the left, and the right patches of the first `n_noisy` carry heavy noise
    (the construction of tests/test_torch_stereo.py). At N = 2048 and 2047."""
    out = {}
    for n in (prm.n_features, prm.n_features - 1):
        rng = np.random.default_rng(n)
        xy_l = np.stack([rng.uniform(60, 1180, n), rng.uniform(20, 356, n)], -1).astype(np.float32)
        desc = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        patch_l = rng.uniform(0, 255, size=(n, 32, 32)).astype(np.float32)
        patch_r = patch_l + rng.normal(0, 1.0, size=patch_l.shape).astype(np.float32)
        patch_r[:n_noisy] += rng.normal(0, 40.0, size=(n_noisy, 32, 32)).astype(np.float32)
        dev = prm.scales.device
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        fl = Features(t(xy_l), zeros, zeros, torch.zeros(n, dtype=torch.int32, device=dev),
                      t(desc), torch.ones(n, dtype=torch.bool, device=dev), t(patch_l))
        fr = fl._replace(xy=t(xy_l - np.array([7.0, 0.0], np.float32)), patch=t(patch_r))
        m_k, u_err, d_err = check_stereo(fl, fr, prm.scales, float(CAM.bf))
        # Distance 0 to every twin and a disparity of 7 +- 5 px pass every
        # pre-cut test, so the features the cut removed prove it was live.
        require(bool((m_k.dist == 0).all()), "median case: a twin was not matched")
        removed = int((~m_k.ok).sum())
        require(0 < removed <= n_noisy and bool(m_k.ok[n_noisy:].all()),
                f"median case N={n}: the cut removed {removed} features, expected 1..{n_noisy} noisy ones")
        out[n] = dict(removed=removed, uright_max_abs_err=u_err, depth_max_abs_err=d_err)
    return out


def check_small_geometry(dev) -> dict:
    """The kernels at a small geometry whose level-0 budget exceeds its cell
    count (112 slots, 104 cells), so fast_topk's zero-padded slots and
    partial tiles are held against the plain versions too; at the e2e and
    loop orbits' image size and levels (320x240, `entry.loop_config`) on a
    textured pair; and the mono entry point on the card against the plain
    path on the CPU."""
    from corbslam_tpu_torch.config import OrbConfig

    cfg = OrbConfig(n_features=256, n_levels=3)
    pair = stereo_pair(seed=7, shift=6, h=120, w=200)
    imgs = orb.as_images(list(pair), dev)
    _, info = check_kernels(imgs, orb.params(cfg, 120, 200, str(dev)), timed=False)
    require(info["padded_slots"] >= 2 * 8, f"small geometry padded only {info['padded_slots']} slots")
    ocfg = loop_config().orb
    orbit = orb.as_images(list(stereo_pair(seed=11, shift=9, h=240, w=320)), dev)
    _, info["orbit_size"] = check_kernels(orbit, orb.params(ocfg, 240, 320, str(dev)), timed=False)
    mono = compare_frames(frame_mod.build_frame_mono(pair[0], CAM, cfg, device="cuda"),
                          frame_mod.build_frame_mono(pair[0], CAM, cfg, device="cpu"))
    return dict(info, mono_vs_cpu=mono)


def stereo_edges(dev) -> dict:
    """K4 against its plain version on `kernel_times.stereo_edge_cases` (the
    inputs tests/test_torch_stereo.py holds the plain version to against the
    reference): idx, dist and ok exact, u_right and depth within 1e-3."""
    out = {}
    for name, (left, right, scales) in stereo_edge_cases().items():
        def feats(side):
            n = side["xy"].shape[0]
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            zeros = torch.zeros(n, dtype=torch.float32, device=dev)
            return Features(t(side["xy"]), zeros, zeros, t(side["octave"]), t(side["desc"]),
                            t(side["valid"]), t(side["patch"]))

        m_k, u_err, d_err = check_stereo(feats(left), feats(right),
                                         torch.from_numpy(scales).to(dev), float(CAM.bf))
        out[name] = dict(ok=int(m_k.ok.sum()), matched=int((m_k.dist < 512).sum()),
                         uright_max_abs_err=u_err, depth_max_abs_err=d_err)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def frame_pairs(n: int):
    """n stereo pairs of varied texture and disparity shift (4..40 px)."""
    return [stereo_pair(seed=100 + i, shift=4 + (i * 9) % 37) for i in range(n)]


def compare_frames(fd_gpu, fd_cpu) -> dict:
    """A frame built on the card against the plain path's on the CPU."""
    g = {k: v.cpu() for k, v in fd_gpu._asdict().items()}
    c = fd_cpu._asdict()
    nv_g, nv_c = int(g["fvalid"].sum()), int(c["fvalid"].sum())
    ok_g, ok_c = int((g["uright"] >= 0).sum()), int((c["uright"] >= 0).sum())
    require(abs(nv_g - nv_c) <= 0.01 * nv_c, f"valid count {nv_g} vs CPU {nv_c}")
    require(abs(ok_g - ok_c) <= 0.01 * ok_c, f"stereo-ok count {ok_g} vs CPU {ok_c}")

    # Levels >= 1 differ by float rounding between the two, so FAST ranks
    # may reorder slots, and PyTorch's CUDA division by a scalar multiplies
    # by its reciprocal: pair features by (octave, x, y to 0.01 px).
    def keyed(d):
        return {(int(o), round(x, 2), round(y, 2)): i for i, (o, (x, y), v) in
                enumerate(zip(d["octave"].tolist(), d["xy"].tolist(), d["fvalid"].tolist())) if v}
    kg, kc = keyed(g), keyed(c)
    shared = [(kg[k], kc[k]) for k in kg.keys() & kc.keys()]
    require(len(shared) >= 0.99 * nv_c, f"only {len(shared)} of {nv_c} keypoints shared with CPU")
    ig, ic = (torch.tensor(v) for v in zip(*shared))
    require(bool((g["desc"][ig] == c["desc"][ic]).all(-1).float().mean() >= 0.99),
            "descriptors of shared keypoints differ from the CPU plain path")
    both_ok = (g["uright"][ig] >= 0) & (c["uright"][ic] >= 0)
    u_err = disp_err = 0.0
    if bool(both_ok.any()):
        u_err = (g["uright"][ig][both_ok] - c["uright"][ic][both_ok]).abs().max().item()
        # Depth held in disparity (bf / depth), the unit of u_right's bound.
        bf = float(CAM.bf)
        disp_err = (bf / g["depth"][ig][both_ok] - bf / c["depth"][ic][both_ok]).abs().max().item()
    require(u_err <= 1e-2, f"u_right vs CPU {u_err} > 1e-2 px")
    require(disp_err <= 1e-2, f"disparity bf/depth vs CPU {disp_err} > 1e-2 px")
    return dict(valid_gpu=nv_g, valid_cpu=nv_c, ok_gpu=ok_g, ok_cpu=ok_c,
                shared=len(shared), uright_max_abs_err=u_err, disparity_max_abs_err=disp_err)


def run_main_path(fwd, entry_imgs) -> dict:
    pairs = frame_pairs(20)
    kernels.reset_launches()
    for _ in range(3):
        fd = fwd(*entry_imgs)
    torch.cuda.synchronize()
    entry_fd = fd
    times, valid, ok = [], [], []
    for img_l, img_r in pairs:
        t0 = time.perf_counter()
        fd = fwd(img_l, img_r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for name, t in fd._asdict().items():
            if t.is_floating_point():
                require(bool(torch.isfinite(t).all()), f"non-finite values in {name}")
        valid.append(int(fd.fvalid.sum()))
        ok.append(int((fd.uright >= 0).sum()))
    launches = {k: kernels.LAUNCHES[k] for k in FRONT_END_KERNELS}
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the front end")
    for name in ("pyramid", "stereo_match", "finish_keypoints"):  # one launch a frame each
        require(launches[name] == 3 + len(pairs),
                f"{name}: {launches[name]} launches over {3 + len(pairs)} frames")
    ev, eo = int(entry_fd.fvalid.sum()), int((entry_fd.uright >= 0).sum())
    require(ev >= 1800, f"entry input: {ev} valid features < 1800")
    require(eo >= 1500, f"entry input: {eo} stereo matches < 1500")
    require(min(valid) >= 1800 and min(ok) >= 1500,
            f"timed frames: min valid {min(valid)}, min stereo-ok {min(ok)}")
    return dict(
        frames=len(pairs), warmup=3, launches=launches,
        frame_ms_p50=float(np.percentile(times, 50)),
        frame_ms_p90=float(np.percentile(times, 90)),
        frame_ms=times, valid=valid, stereo_ok=ok,
        entry_valid=ev, entry_stereo_ok=eo, entry_frame=entry_fd,
    )


# ---------------------------------------------------------------------------
# Phase 5: the tracking path (track_frame_stereo on the bench sequence)
# ---------------------------------------------------------------------------

TRACK_FRAMES = 20
# A fixed keyframe schedule stands in for the keyframe policy, which comes
# with the tracker (StereoTracker): a keyframe after these tracked frames.
KEYFRAME_AFTER = (5, 10, 15, 20)
CHECK_FRAME = 12   # the kernels are held against their plain versions on this frame's inputs
CPU_FRAMES = 3     # frames 1..3 are tracked again by the plain path on the CPU
TRUNCATED_L = 1024  # a local-map window smaller than the frame's local map


def state_to(st: TrackState, device) -> TrackState:
    """An independent copy of the tracking state on `device`."""
    cp = lambda t: t.to(device, copy=True)  # noqa: E731
    return TrackState(ms.MapState(ms.KeyFrames(*map(cp, st.m.kf)), ms.MapPoints(*map(cp, st.m.mp)),
                                  cp(st.m.n_kf), cp(st.m.n_mp)),
                      frame_mod.FrameData(*map(cp, st.prev)), cp(st.velocity), cp(st.ref_kf),
                      cp(st.local_rows), cp(st.local_ok))


def translation_error(Tcw: torch.Tensor, i: int) -> float:
    """Distance in metres between the translation of Tcw and that of frame
    i's true pose in the map seeded at frame 0 (the other error definition
    beside `center_error`; it also moves with the rotation error)."""
    T_gt = se3.compose(gt_pose(i), se3.inverse(gt_pose(0)))
    return float(torch.linalg.norm(Tcw[:3, 3] - T_gt[:3, 3]))


def summary_row(summary: torch.Tensor, i: int) -> dict:
    s = summary.cpu()
    T = s[8:].view(4, 4)
    return dict(frame=i, n_track=int(s[0]), used_ref=int(s[1]), n_local=int(s[2]),
                ref_kf=int(s[3]), ok=int(s[6]), err_m=center_error(T, i),
                t_err_m=translation_error(T, i), Tcw=s[8:].tolist())


def run_tracking_path(te, dev) -> dict:
    """Seed at frame 0, track frames 1..20 with the keyframe schedule, all
    launch counters reset just before; returns per-frame rows, the tracked
    frames' times (keyframe insertion not included), the launches, the CPU
    copy of the state before frame 1 and the card state before CHECK_FRAME."""
    imgs = [te.world.render_stereo(gt_pose(i)) for i in range(TRACK_FRAMES + 1)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    st = seed_map(te, *imgs[0], dev)
    n_seed = int(st.m.n_mp)
    cpu_start = state_to(st, "cpu")
    check_state, rows, times = None, [], []
    for i in range(1, TRACK_FRAMES + 1):
        if i == CHECK_FRAME:
            check_state = state_to(st, dev)
        t0 = time.perf_counter()
        st, summary = track_step(te, st, *imgs[i], dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i in KEYFRAME_AFTER:
            st = add_keyframe(te, st, i)
        rows.append(summary_row(summary, i))
        for name, t in [("summary", summary), ("velocity", st.velocity), ("Tcw", st.prev.Tcw)]:
            require(bool(torch.isfinite(t).all()), f"frame {i}: non-finite {name}")
    launches = dict(kernels.LAUNCHES)
    for name, t in [("mp.pos", st.m.mp.pos), ("mp.normal", st.m.mp.normal),
                    ("kf.Tcw", st.m.kf.Tcw)]:
        require(bool(torch.isfinite(t).all()), f"non-finite map field {name}")
    for name in TRACKING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the tracking path")
    require(launches["finish_keypoints"] == TRACK_FRAMES + 1,
            f"tracking: {launches['finish_keypoints']} finish_keypoints launches over "
            f"{TRACK_FRAMES + 1} frames")
    require(all(r["ok"] for r in rows), f"a frame was not ok: {[r['ok'] for r in rows]}")
    require(min(r["n_local"] for r in rows) >= 1000,
            f"n_local below 1000: {[r['n_local'] for r in rows]}")
    max_err = max(r["err_m"] for r in rows)
    require(max_err <= 0.075, f"largest camera-centre error {max_err:.4f} m > 0.075 m")

    # Build-only time of the same frames, for the track-only share.
    build = []
    for i in range(1, TRACK_FRAMES + 1):
        t0 = time.perf_counter()
        frame_mod.build_frame_stereo(*imgs[i], te.cam, te.cfg.orb, device=dev)
        torch.cuda.synchronize()
        build.append((time.perf_counter() - t0) * 1e3)
    timed = slice(3, TRACK_FRAMES)  # frames 4..20
    track_only = [a - b for a, b in zip(times[timed], build[timed])]
    return dict(
        frames=TRACK_FRAMES, keyframe_after=KEYFRAME_AFTER, seed_points=n_seed,
        final_points=int(st.m.n_mp), final_keyframes=int(st.m.n_kf), launches=launches,
        frame_ms=times, build_ms=build,
        frame_ms_p50=float(np.percentile(times[timed], 50)),
        frame_ms_p90=float(np.percentile(times[timed], 90)),
        track_only_ms_p50=float(np.percentile(track_only, 50)),
        track_only_ms_p90=float(np.percentile(track_only, 90)),
        max_err_m=max_err, rows=rows, imgs=imgs, cpu_start=cpu_start, check_state=check_state)


def center_distance(Ta: torch.Tensor, Tb: torch.Tensor) -> float:
    """Distance in metres between the camera centres of two poses."""
    return float(torch.linalg.norm(se3.translation(se3.inverse(Ta))
                                   - se3.translation(se3.inverse(Tb))))


def compare_tracking_with_cpu(te, tp: dict) -> list:
    """Frames 1..CPU_FRAMES again through the plain path on the CPU, from the
    card's state before frame 1: poses within 1e-3 m, n_local within 2 %."""
    st = tp["cpu_start"]
    out = []
    for i in range(1, CPU_FRAMES + 1):
        img_l, img_r = (im.cpu() for im in tp["imgs"][i])
        st, summary = track_step(te, st, img_l, img_r, "cpu")
        if i in KEYFRAME_AFTER:
            st = add_keyframe(te, st, i)
        c, g = summary_row(summary, i), tp["rows"][i - 1]
        d = center_distance(torch.tensor(c["Tcw"]).view(4, 4), torch.tensor(g["Tcw"]).view(4, 4))
        require(d <= 1e-3, f"frame {i}: card and CPU poses {d:.2e} m apart > 1e-3 m")
        require(abs(c["n_local"] - g["n_local"]) <= 0.02 * g["n_local"],
                f"frame {i}: n_local card {g['n_local']} vs CPU {c['n_local']}")
        out.append(dict(frame=i, center_diff_m=d, n_local_card=g["n_local"],
                        n_local_cpu=c["n_local"], n_track_card=g["n_track"],
                        n_track_cpu=c["n_track"]))
    return out


# ---------------------------------------------------------------------------
# Phase 6: K5..K7 against their plain versions on one tracked frame's inputs
# ---------------------------------------------------------------------------

def same_match(q: dict, name: str):
    k, p = matcher.match_select(**q), matcher.match_select_plain(**q)
    torch.cuda.synchronize()
    for f in ("idx", "dist", "ok"):
        a, b = getattr(k, f), getattr(p, f)
        require(torch.equal(a, b.to(a.dtype)),
                f"match_masked ({name}): {f} differs in {(a != b.to(a.dtype)).sum().item()} places")
    return k


def match_cost(q: dict) -> tuple:
    """(bytes, ops, unmasked pairs) of one K5 call, counted from these inputs
    as the work the function needs. Ops: each query's validity; for a valid
    query, each target's validity; with a window, the window test of each
    valid query x valid target pair; XOR, popcount and the running top-2
    only for the pairs that pass. Bytes: the flags once, the window fields
    and angles of valid rows, the descriptors of rows in at least one pair
    that passes, idx / dist / ok out."""
    Nq, Nt = q["desc_q"].shape[0], q["desc_t"].shape[0]
    n_vq, n_vt = int(q["valid_q"].sum()), int(q["valid_t"].sum())
    w = q.get("window")
    mask = matcher.geometry_mask(w, q["valid_q"], q["valid_t"]).T
    n_pass = int(mask.sum())
    t_used, q_used = int(mask.any(1).sum()), int(mask.any(0).sum())
    # Per valid row, the window's fields (projection: xy / uv and octave;
    # area: xy; band: xy and octave) and the angle.
    geo_bytes, geo_ops = {matcher.Window: (12, 10), matcher.AreaWindow: (8, 6),
                          matcher.EpipolarBand: (12, 20)}.get(type(w), (0, 0))
    per_row = geo_bytes + (4 if q.get("angle_q") is not None else 0)
    n_bytes = Nq + Nt + (n_vq + n_vt) * per_row + (q_used + t_used) * 32 + Nq * 9
    # The window test: 2 sub + 3 mul + 1 add + 1 compare + 1 sub + 2
    # compares (area: 6; band with the epipole guard: ~20); an unmasked pair:
    # 8 XOR + 8 popc + 7 adds and the top-2 (~4).
    ops = Nq + n_vq * Nt + n_vq * n_vt * geo_ops + n_pass * 27
    return n_bytes, ops, n_pass


def band_cost(st, nbf, xy_q, scales) -> tuple:
    """(bytes, ops) of K5's batched band search of a keyframe against its
    neighbours (`triangulation.search`), counted from these inputs as
    `match_cost` counts one search; the keyframe's descriptors and
    keypoints are shared by the batches and counted once."""
    K, F = nbf.unbound.shape
    valid_q = st.unbound1[None] & st.nb_use[:, None]
    ops, n_bytes, q_used = 0, K * F * (1 + 1 + 9) + K * 11 * 4, torch.zeros_like(st.unbound1)
    for k in range(K):
        band = matcher.EpipolarBand(st.F12[k], nbf.xy[k], xy_q, nbf.octave[k], scales,
                                    st.epipole[k])
        mask = matcher.geometry_mask(band, valid_q[k], nbf.unbound[k])
        n_vq, n_vt = int(valid_q[k].sum()), int(nbf.unbound[k].sum())
        ops += F + n_vq * F + n_vq * n_vt * 20 + int(mask.sum()) * 27
        n_bytes += n_vt * 12 + int(mask.any(0).sum()) * 32
        q_used |= mask.any(1)
    n_bytes += int((valid_q.any(0)).sum()) * 8 + int(q_used.sum()) * 32
    return n_bytes, ops


def pose_errors(k, p, cam, X, obs, inv_s2, stereo_mask, valid) -> dict:
    """K6 against the plain version: translation and rotation differences,
    and inlier flips, allowed only where the final chi2 lies within 1e-3
    (relative) of its gate."""
    dt = float((k.Tcw[:3, 3] - p.Tcw[:3, 3]).abs().max())
    drot = float(torch.linalg.norm(k.Tcw[:3, :3] - p.Tcw[:3, :3]) / 2 ** 0.5)
    res = reproj.linearize(cam, p.Tcw, X, obs, inv_s2, stereo_mask)
    c2 = reproj.chi2(res.r, res.w)
    d2 = reproj.chi2_threshold(stereo_mask)
    flips = k.inliers != p.inliers
    near = (c2 - d2).abs() <= 1e-3 * d2
    return dict(t_max_abs=dt, rot_rad=drot, flips=int(flips.sum()), flips_off_gate=int(
        (flips & ~near).sum()), n_inliers_kernel=int(k.n_inliers), n_inliers_plain=int(p.n_inliers),
        n_valid=int(valid.sum()))


def same_pose(cam, T0, inputs, name: str) -> tuple:
    """K6 against its plain version: the pose within 1e-4 m / 1e-5 rad,
    inlier flips only at the chi2 gate, the cost within 1e-3 (relative;
    costs both under 1e-6 count as zero: a pose that fits its observations
    leaves f32 rounding); and a second kernel run on the same input
    bit-equal to the first."""
    k = pose_opt.optimize_pose(cam, T0, *inputs)
    p = pose_opt.optimize_pose_plain(cam, T0, *inputs)
    k2 = pose_opt.optimize_pose(cam, T0, *inputs)
    torch.cuda.synchronize()
    e = pose_errors(k, p, cam, *inputs)
    require(e["t_max_abs"] <= 1e-4 and e["rot_rad"] <= 1e-5,
            f"pose_opt ({name}): pose differs by {e['t_max_abs']:.2e} m / {e['rot_rad']:.2e} rad")
    require(e["flips_off_gate"] == 0, f"pose_opt ({name}): {e['flips_off_gate']} inlier flips "
            "away from the chi2 gate")
    ck, cp = float(k.cost), float(p.cost)
    e["cost_rel"] = abs(ck - cp) / max(abs(cp), 1e-30) if ck != cp else 0.0
    require(e["cost_rel"] <= 1e-3 or max(abs(ck), abs(cp)) <= 1e-6,
            f"pose_opt ({name}): cost {ck} against {cp}")
    for f in pose_opt.PoseOptResult._fields:
        require(torch.equal(getattr(k, f), getattr(k2, f)),
                f"pose_opt ({name}): two runs on one input differ in {f}")
    return k, e


# K6's and K2's edges, as tests/test_torch_pose_opt.py and test_torch_orb.py
# hold the plain versions to JAX's: name -> (K, noise px, outlier share,
# stereo share, T0 perturbation, edge).
POSE_EDGES = {
    "k1": (1, 0.0, 0.0, 1.0, [0.0] * 6, None),
    "k2048": (2048, 0.3, 0.1, 0.6, [0.2, -0.1, 0.15, 0.02, -0.01, 0.02], None),
    "k2049": (2049, 0.3, 0.1, 0.6, [-0.1, 0.2, 0.1, -0.01, 0.02, 0.01], None),
    "k8192": (8192, 0.3, 0.1, 0.6, [0.15, 0.1, -0.2, 0.01, -0.02, 0.02], None),
    "all_invalid": (300, 0.2, 0.0, 1.0, [0.2, -0.1, 0.1, 0.02, 0.01, -0.02], "invalid"),
    "most_behind": (400, 0.2, 0.0, 0.6, [0.1, -0.1, 0.2, 0.01, -0.01, 0.02], "behind"),
}
# name -> (h, w, cell, n_features, n_levels): a flat image (no corner, every
# cell tied at 0), widths that are no multiple of a tile, and levels over
# and under their budgets (cells 99, 70, 48, 35 against 88, 64, 56, 48).
FAST_EDGES = {
    "flat": (120, 200, 16, 256, 3),
    "97x131_cell12": (97, 131, 12, 200, 3),
    "over_and_under_budget": (97, 131, 12, 256, 4),
}


def pose_scene(seed: int, n: int, noise: float, outliers: float, stereo_share: float, dxi,
               edge, dev) -> tuple:
    """tests/test_torch_pose_opt.py's scene in the port's f32: points in
    front of a true camera, noisy (u, v, u_right), outliers; `edge` "invalid"
    clears `valid`, "behind" mirrors 90 % of the points behind the camera.
    Returns (T0, (X, obs, inv_sigma2, is_stereo, valid)) on `dev`."""
    rng = np.random.default_rng(seed)
    stereo = rng.random(n) < stereo_share if stereo_share < 1.0 else np.ones(n, bool)
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                  rng.uniform(8, 40, n)], -1).astype(np.float32)
    Tt = se3.exp(torch.tensor([0.3, -0.1, 0.2, 0.02, -0.04, 0.01])).numpy()
    pc = X @ Tt[:3, :3].T + Tt[:3, 3]
    u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
    uvr = np.stack([u, CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy, u - CAM.bf / pc[:, 2]], -1)
    uvr += rng.normal(scale=noise, size=uvr.shape) if noise else 0.0
    n_out = int(outliers * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uvr[idx, :2] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.integers(0, 8, n))).astype(np.float32)
    valid = rng.random(n) < 0.95 if n > 1 else np.ones(n, bool)
    if edge == "invalid":
        valid[:] = False
    if edge == "behind":
        pc[rng.random(n) < 0.9, 2] *= -1.0
        X = ((pc - Tt[:3, 3]) @ Tt[:3, :3]).astype(np.float32)
    T0 = se3.retract(torch.from_numpy(Tt), torch.tensor(dxi, dtype=torch.float32))
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    return T0.to(dev), (t(X), t(uvr), t(inv_s2), t(stereo, torch.bool), t(valid, torch.bool))


def pose_fast_edges(dev) -> dict:
    """K6 (`same_pose`: the tolerances, the cost, two runs bit-equal) on
    POSE_EDGES and K2 (every Keypoints field exact, on K1's pyramid of
    the image) on FAST_EDGES, kernel against plain version on the card."""
    from corbslam_tpu_torch.config import OrbConfig
    from corbslam_tpu_torch.io import synthetic

    out = {}
    for i, (name, (n, noise, o, sh, dxi, edge)) in enumerate(POSE_EDGES.items()):
        T0, inputs = pose_scene(i, n, noise, o, sh, dxi, edge, dev)
        k, e = same_pose(CAM, T0, inputs, f"edge {name}")
        if edge == "invalid":
            require(int(k.n_inliers) == 0 and float(k.cost) == 0.0,
                    "pose_opt (edge all_invalid): inliers or cost without a valid observation")
        out[f"pose_opt {name}"] = e
    for name, (h, w, cell, nf, nl) in FAST_EDGES.items():
        img = (np.full((h, w), 128.0, np.float32) if name == "flat"
               else synthetic.random_texture(h, w, seed=13))
        prm = orb.params(OrbConfig(n_features=nf, n_levels=nl, cell_size=cell), h, w, str(dev))
        pyr = pyramid.build_pyramid(orb.as_images([img, img[:, ::-1].copy()], dev), prm)
        kp_k, kp_p = fast.detect_pyramid(pyr, prm), fast.detect_pyramid_plain(pyr, prm)
        torch.cuda.synchronize()
        for f in fast.Keypoints._fields:
            a, b = getattr(kp_k, f), getattr(kp_p, f)
            require(torch.equal(a, b.to(a.dtype)), f"fast_cells (edge {name}): field {f} "
                    f"differs in {(a != b.to(a.dtype)).sum().item()} places")
        if name == "flat":
            require(not bool(kp_k.valid.any()), "fast_cells (edge flat): a corner on a flat image")
        out[f"fast_cells {name}"] = dict(valid=int(kp_k.valid.sum()),
                                         cells=[gy * gx for gy, gx in prm.grids],
                                         budgets=list(prm.budgets))
    return out


def match_scene(dev, seed: int, Nq: int, Nt: int, B: int = 0, ties: int = 0) -> dict:
    """Queries and targets of K5's edge cases, made from a seed: each target
    is a query (row j mod Nq) with up to 40 of its 256 bits flipped, its uv
    within ~2 px of that query's keypoint in a 400 x 300 image, its octave
    within 1 of the query's, its angle turned by 0.3 rad (+- 0.05, a fifth
    of them at random); 90 % of rows valid on each side. `ties` targets
    repeat target 0 (descriptor and uv): equal distances, the lower index
    first. With B > 0 the targets, their flags and the query flags get a
    leading batch axis of B (each batch its own draw)."""
    g = np.random.default_rng(seed)
    dq = g.integers(0, 256, (Nq, 32), dtype=np.uint8)
    xy_q = g.uniform([0, 0], [400, 300], (Nq, 2)).astype(np.float32)
    oct_q = g.integers(0, 8, Nq).astype(np.int32)
    ang_q = g.uniform(-np.pi, np.pi, Nq).astype(np.float32)

    def targets():
        src = np.arange(Nt) % Nq
        flip = g.random((Nt, 256)) < g.integers(0, 41, Nt)[:, None] / 256.0
        dt = dq[src] ^ np.packbits(flip, axis=1)
        uv = (xy_q[src] + g.normal(0, 2.0, (Nt, 2))).astype(np.float32)
        ot = np.clip(oct_q[src] + g.integers(-1, 2, Nt), 0, 7).astype(np.int32)
        at = (ang_q[src] - 0.3 + g.normal(0, 0.05, Nt)).astype(np.float32)
        wild = g.random(Nt) < 0.2
        at[wild] = g.uniform(-np.pi, np.pi, int(wild.sum()))
        if ties:
            dt[1:ties + 1], uv[1:ties + 1], ot[1:ties + 1] = dt[0], uv[0], ot[0]
        return dt, uv, ot, at, g.random(Nt) < 0.9, g.random(Nq) < 0.9

    drawn = [targets() for _ in range(max(B, 1))]
    stack = (lambda i: np.stack([d[i] for d in drawn])) if B else (lambda i: drawn[0][i])
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(desc_q=t_(dq), xy_q=t_(xy_q), oct_q=t_(oct_q), ang_q=t_(ang_q),
                desc_t=t_(stack(0)), uv_t=t_(stack(1)), oct_t=t_(stack(2)), ang_t=t_(stack(3)),
                valid_t=t_(stack(4)), valid_q=t_(stack(5)))


def scene_query(sc: dict, mode: str, mutual: bool = True, rotation: bool = False,
                max_dist: int = 80, ratio: float = 0.9) -> dict:
    """A `match_select` query of a `match_scene`: mode "valid" (no window),
    "window" (projection window, 15 px, octave +-1) or "area" (20 px)."""
    scales = torch.tensor([1.2 ** k for k in range(8)], dtype=torch.float32,
                          device=sc["xy_q"].device)
    win = None
    if mode == "window":
        win = matcher.Window(sc["uv_t"], sc["xy_q"], sc["oct_q"], sc["oct_t"], scales, 15.0, 1, 1)
    elif mode == "area":
        win = matcher.AreaWindow(sc["uv_t"], sc["xy_q"], 20.0)
    return dict(desc_q=sc["desc_q"], desc_t=sc["desc_t"], valid_q=sc["valid_q"],
                valid_t=sc["valid_t"], max_dist=max_dist, ratio=ratio, mutual=mutual, window=win,
                angle_q=sc["ang_q"] if rotation else None,
                angle_t=sc["ang_t"] if rotation else None)


def same_band(sc: dict, epipole: bool, name: str) -> dict:
    """K5's batched band mode against `band_search_plain` on a `match_scene`
    with a batch axis: F12 of a sideways camera move per batch (epipolar
    lines near-horizontal), with or without an epipole guard."""
    dev = sc["desc_q"].device
    B = sc["desc_t"].shape[0]
    F = torch.zeros(B, 3, 3, device=dev)
    for b in range(B):
        tx, ty = 1.0, 0.002 * (b + 1)
        F[b] = torch.tensor([[0.0, 0.0, ty], [0.0, 0.0, -tx], [-ty, tx, 0.0]])
    e = torch.tensor([[200.0, 150.0]], device=dev).expand(B, 2).contiguous() if epipole else None
    scales = torch.tensor([1.2 ** k for k in range(8)], dtype=torch.float32, device=dev)
    args = (sc["desc_q"], sc["valid_q"], sc["xy_q"], sc["desc_t"], sc["valid_t"], sc["uv_t"],
            sc["oct_t"], F, e, scales, 60, 1.0, True)
    k, p = matcher.band_search(*args), matcher.band_search_plain(*args)
    torch.cuda.synchronize()
    for f in ("idx", "dist", "ok"):
        a, b = getattr(k, f), getattr(p, f)
        require(torch.equal(a, b.to(a.dtype)),
                f"match_band ({name}): {f} differs in {(a != b.to(a.dtype)).sum().item()} places")
    return dict(ok=int(k.ok.sum()))


def match_edges(dev) -> dict:
    """K5 against its plain version on the card, exactly (idx, dist, ok), at
    its edges: Nq 1, Nt 2 (the least it takes; Nt 1 is refused), Nq not a
    multiple of the 16-row tile and Nt not one of the 2048-target chunk,
    Nq 12288 (the finish's limit, with the rotation check), every target
    masked, equal-distance ties, B = 6 band batches with and without the
    epipole guard, and the mutual and rotation checks each on and off in
    every window mode; then the workspace is back to its empty state."""
    out = {}
    cases = [("nq1", 1, 2048, 0, "window", True, True),
             ("nt2", 2048, 2, 0, "valid", True, False),
             ("nq1_nt2", 1, 2, 0, "area", True, True),
             ("ragged", 2047, 3001, 0, "window", True, True),
             ("nq12288", 12288, 4096, 0, "area", True, True)]
    for mode in ("valid", "window", "area"):
        for mutual in (True, False):
            for rotation in (True, False):
                cases.append((f"{mode}_mutual{int(mutual)}_rot{int(rotation)}", 2048, 2048, 0,
                              mode, mutual, rotation))
    for i, (name, nq, nt, ties, mode, mutual, rotation) in enumerate(cases):
        sc = match_scene(dev, 100 + i, nq, nt, ties=ties)
        if nq == 1:
            sc["valid_q"][:] = True
        out[name] = int(same_match(scene_query(sc, mode, mutual, rotation), name).ok.sum())
    # Ties: targets 0..40 hold one descriptor and uv, the only ones near
    # query 0 (Nt <= Nq); no ratio test and no mutual check, so query 0
    # keeps its tie and takes the lowest index.
    sc = match_scene(dev, 96, 64, 64, ties=40)
    sc["valid_q"][0] = True
    sc["valid_t"][:41] = True
    res = same_match(scene_query(sc, "window", mutual=False, ratio=1.0), "ties")
    require(bool(res.ok[0]) and int(res.idx[0]) == 0, f"match_masked (ties): query 0 took "
            f"target {int(res.idx[0])}, not the lowest of its tied targets")
    out["ties"] = int(res.ok.sum())
    sc = match_scene(dev, 99, 512, 1024)
    sc["valid_t"] = torch.zeros_like(sc["valid_t"])
    res = same_match(scene_query(sc, "window"), "all_masked")
    require(not bool(res.ok.any()) and bool((res.dist == 512).all()),
            "match_masked (all_masked): a match without a candidate")
    out["all_masked"] = 0
    try:
        matcher.match_select(**scene_query(match_scene(dev, 98, 16, 1), "valid"))
        raise AssertionError("match_select took Nt = 1")
    except ValueError:
        out["nt1"] = "refused"
    sc = match_scene(dev, 97, 2048, 2048, B=6)
    out["band6_epipole"] = same_band(sc, True, "B 6, epipole")
    out["band6"] = same_band(sc, False, "B 6")
    torch.cuda.synchronize()
    cols, tick = matcher.k5_workspace(dev, 1, 2, kernels.stream())
    require(bool((cols == matcher.COL_EMPTY).all()) and not bool(tick.any()),
            "match_masked: the workspace was not restored")
    return out


def pose_graph_edges(dev) -> dict:
    """K11 against its plain version (`same_graph`, two runs bit-equal) at
    its edges: `ring_graph` at 2048 rows with 64, 512 and 2048 live (the
    rest fixed and unweighted), every vertex fixed, no weighted edge, 100
    rows (E 932, not a multiple of the grid), 5 rows (E 19, fewer edges
    than CTAs), both 0.15 m apart as the 2048-row ring's, and one vertex
    carrying all 32 loop slots."""
    rg = ring_graph(2048, device=dev)
    cases = {f"live{L}": ring_graph(2048, device=dev, live=L) for L in (64, 512)}
    cases.update(live2048=rg, all_fixed=rg._replace(fixed=torch.ones_like(rg.fixed)),
                 no_weighted_edge=rg._replace(e_valid=torch.zeros_like(rg.e_valid)),
                 rows100=ring_graph(100, radius=50.0 * 100 / 2048, device=dev),
                 rows5=ring_graph(5, 2, 4, radius=50.0 * 5 / 2048, device=dev),
                 hub=ring_graph(2048, device=dev, live=512, hub=True))
    out = {}
    for name, g in cases.items():
        out[name] = same_graph(g, t_rel=True)
    return out


def check_tracking_kernels(te, st: TrackState, img_l, img_r, timed: bool = True):
    """Replays the kernel calls of `_track_core` for one frame on the card's
    state and holds K5 (all three callers), K6 (both calls) and K7 against
    their plain versions; with `timed`, rows for the kernels' line."""
    cam, cfg, _ = te
    dev = st.m.mp.pos.device
    m, prev = st.m, st.prev
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=dev)
    T_pred = se3.compose(st.velocity, prev.Tcw)
    q_ff = track_ops.motion_model_query(cam, m, prev, cur, T_pred, cfg)
    ff = same_match(q_ff, "frame-frame")
    match_mp = track_ops.lookup(ff.idx, prev.mp_idx)
    pin1 = track_ops.pose_inputs(cur, m.mp.pos, match_mp)
    po1, e1 = same_pose(cam, T_pred, pin1, "motion model")
    Tcw0 = po1.Tcw
    mp0 = torch.where(po1.inliers, match_mp, torch.full_like(match_mp, -1))

    q_desc, _ = track_ops.reference_kf_query(m, cur, st.ref_kf)
    desc = same_match(q_desc, "descriptor")

    args = (cam, m, mp0, st.local_rows, st.local_ok, st.ref_kf, Tcw0, cfg)
    win = track_ops.local_map_window(*args)
    win_p = track_ops.local_map_window_plain(*args)
    torch.cuda.synchronize()
    for f in ("cand", "cand_ok", "local_rows", "local_ok", "ref_kf", "cur_mask", "pmask", "rows",
              "rows_ok"):
        a, b = getattr(win, f), getattr(win_p, f)
        require(torch.equal(a, b.to(a.dtype)),
                f"local_map: {f} differs in {(a != b.to(a.dtype)).sum().item()} places")
    k7 = dict(uv_max_abs=float((win.uv - win_p.uv).abs().max()),
              visible_flips=int((win.visible != win_p.visible).sum()),
              pred_octave_flips=int((win.pred_octave != win_p.pred_octave).sum()),
              n_pmask=int(win.pmask.sum()), n_rows_ok=int(win.rows_ok.sum()),
              n_visible=int(win.visible.sum()))
    require(k7["uv_max_abs"] <= 1e-3, f"local_map: uv differs by {k7['uv_max_abs']}")
    # The compaction's truncating branch (more local-map points than L rows),
    # which the sequence's local maps (~2000 points) never reach at L = 8192.
    cfg_s = cfg.replace(capacity=dataclasses.replace(cfg.capacity, local_window_mps=TRUNCATED_L))
    args_s = (cam, m, mp0, st.local_rows, st.local_ok, st.ref_kf, Tcw0, cfg_s)
    win_s, win_sp = track_ops.local_map_window(*args_s), track_ops.local_map_window_plain(*args_s)
    torch.cuda.synchronize()
    for f in ("rows", "rows_ok", "uv", "visible", "pred_octave"):
        a, b = getattr(win_s, f), getattr(win_sp, f)
        require(torch.equal(a, b.to(a.dtype)),
                f"local_map (L = {TRUNCATED_L}): {f} differs in {(a != b).sum().item()} places")
    require(bool(win_s.rows_ok.all()), f"local_map: fewer than {TRUNCATED_L} points, so the "
            "truncating branch was not reached")

    has = mp0 >= 0
    q_pr = track_ops.local_map_query(m, cur, win, has, cfg)
    pr = same_match(q_pr, "projection")
    merged = torch.where(has, mp0, track_ops.lookup(pr.idx, win.rows))
    pin2 = track_ops.pose_inputs(cur, m.mp.pos, merged)
    _, e2 = same_pose(cam, Tcw0, pin2, "local map")
    info = dict(frame_frame_ok=int(ff.ok.sum()), descriptor_ok=int(desc.ok.sum()),
                projection_ok=int(pr.ok.sum()), pose_motion=e1, pose_local=e2, local_map=k7)
    if not timed:
        return [], info

    # Bounds from this frame's inputs.
    cost = [match_cost(q) for q in (q_ff, q_pr)]
    info["match_pairs_unmasked"] = [c[2] for c in cost]

    def pose_cost(pin):
        # Per valid observation and pass: ~45 flops for the residual and
        # chi2, ~70 with the Jacobian, ~180 to accumulate H and g; 4 rounds
        # of (1 + 10 x 2 + 1) passes. Inputs: X, obs, inv_sigma2, flags.
        kv = int(pin[4].sum())
        K = pin[0].shape[0]
        return K * 30 + 64 + K + 72, 4 * kv * (45 + 10 * (70 + 180 + 45) + 45)
    pc = [pose_cost(pin1), pose_cost(pin2)]
    M, N, F = m.mp.capacity, m.kf.capacity, m.kf.n_features
    C, L, K1 = win.cand.shape[0], win.rows.shape[0], win.local_rows.shape[0]
    n_tracked = int((mp0 >= 0).sum())
    # Keyframe rows whose observations the function reads: the distinct valid
    # candidates (the local window is a subset of them).
    cand_read = torch.unique(win.cand[win.cand_ok & m.kf.valid[win.cand.long()]])
    n_contrib = int(((m.kf.mp_idx[cand_read.long()] >= 0) & m.kf.fvalid[cand_read.long()]).sum())
    n_local = int(win.local_ok.sum())
    tested = track_ops.covis.local_map_mask_plain(m, win.local_rows, win.local_ok) & ~win.cur_mask
    n_tests = int(tested.sum())
    geo = tested.clone()
    geo[win.rows.long()] = True  # points whose pos / normal / distances are read, once each
    # K7 bytes: the features' point rows and the tracked points' anchors; the
    # candidate rows' indices and flags (4 + 1 bytes per feature), the flags
    # and window in; per point the four byte masks (valid, tracked, observed,
    # result); pos, normal and distances (32 bytes) of the observed untracked
    # points and of the compacted rows; candidates, window, rows and their
    # projections (rows 4, ok 1, uv 8, visible 1, octave 4) out.
    k7_bytes = (F * 4 + n_tracked * 4 + len(cand_read) * (F * 5 + 1) + K1 * 5 + M * 4
                + int(geo.sum()) * 32 + C * 5 + K1 * 5 + L * 18)
    # K7 ops: an anchor count per tracked feature and a top-k selection over
    # N anchor counts (N log2 C compares); a shared-point test per contributing
    # observation; dedupe and top-K1 of C candidates (C log2 C); the window's
    # scatter and 3 mask ops per point; a frustum test (~45 flops) per
    # observed untracked point; the compaction (2 ops per point); the
    # matching frustum and octave (~60) per compacted row.
    lg = lambda n: max(1, int(np.ceil(np.log2(n))))  # noqa: E731
    k7_ops = (n_tracked + N * lg(C) + 2 * n_contrib + 2 * C * lg(C) + n_local * F + M * 3
              + n_tests * 45 + M * 2 + L * 60)
    info["bound_inputs"] = dict(
        match_bytes_ops=[c[:2] for c in cost], local_map_bytes=k7_bytes, local_map_ops=k7_ops,
        tracked=n_tracked, candidate_rows_read=len(cand_read), observed_untracked=n_tests,
        geometry_rows_read=int(geo.sum()))
    info["launch_ms"] = launch_times(lambda: track_ops.local_map_window(*args))
    key_mask = win.pmask
    row_ids = torch.arange(M, device=dev)

    def library_compact():
        torch.topk(key_mask.to(torch.int64) * (M + 1) + row_ids, L)

    def plain_pose():
        pose_opt.optimize_pose_plain(cam, T_pred, *pin1)
        pose_opt.optimize_pose_plain(cam, Tcw0, *pin2)

    rows = [
        dict(name="match_masked", max_abs_err=0.0,
             bound=bound_ms(sum(c[0] for c in cost), sum(c[1] for c in cost)),
             fns=(lambda: (matcher.match_select(**q_ff), matcher.match_select(**q_pr)),
                  lambda: (matcher.match_select_plain(**q_ff),
                           matcher.match_select_plain(**q_pr)), None, 20)),
        dict(name="pose_opt", max_abs_err=max(e1["t_max_abs"], e2["t_max_abs"]),
             bound=bound_ms(sum(c[0] for c in pc), sum(c[1] for c in pc)),
             fns=(lambda: (pose_opt.optimize_pose(cam, T_pred, *pin1),
                           pose_opt.optimize_pose(cam, Tcw0, *pin2)), plain_pose, None, 3),
             graph=True),
        dict(name="local_map", max_abs_err=k7["uv_max_abs"], bound=bound_ms(k7_bytes, k7_ops),
             fns=(lambda: track_ops.local_map_window(*args),
                  lambda: track_ops.local_map_window_plain(*args), library_compact, 5)),
    ]
    return rows, info


# ---------------------------------------------------------------------------
# Phase 7: the tracker on the flagship schedule (StereoTracker + local mapping)
# ---------------------------------------------------------------------------

# The JAX reference's aligned whole-trajectory ATE on this schedule (on the
# CPU, JAX 0.9.0; the script is in PERF.md); the port must stay within 2x.
JAX_SCHEDULE_ATE_M = 0.0213
CPU_PREFIX = 8  # frames 1..7 (with the 6 forced keyframes) again on the CPU plain path
TRACKER_COUNTERS = ("pyramid", "fast_cells", "orb_describe", "stereo_match", "finish_keypoints",
                    "match_masked", "pose_opt", "local_map", "covisibility", "ba_dense")


def aligned_ate(traj) -> float:
    """bench.py's window ATE: camera centres of the Twc's aligned (rigid) to
    the ground truth's."""
    est = np.asarray([np.linalg.inv(np.asarray(T, np.float64)) for _, T in traj])
    gtw = np.asarray([np.linalg.inv(gt_pose(i).numpy().astype(np.float64))
                      for i in range(len(est))])
    return trajectory.ate_rmse(est, gtw, align=True)


def map_finite(m) -> list:
    """Names of float map fields holding a non-finite value."""
    return [f"{part}.{name}" for part in ("kf", "mp")
            for name, t in getattr(m, part)._asdict().items()
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def newest_keyframe(m) -> int:
    """The newest valid keyframe row (a culled row observes nothing)."""
    return int(torch.nonzero(m.kf.valid).max())


def run_tracker_phase() -> dict:
    """The flagship schedule (entry.run_bench_schedule) on the card: 78
    frames rendered on the card first, all counters reset just before; each
    measured frame's process_stereo wall time (its mapping stages included)
    and each window's closing flush. Keeps the first local-BA problem."""
    tracker, te = tracker_entry("cuda")
    imgs = [te.world.render_stereo(gt_pose(i)) for i in range(BENCH_FRAMES)]
    torch.cuda.synchronize()
    kept = {}
    build = tracker._stage_local_ba_build

    def build_and_keep(kf_row, st):
        build(kf_row, st)
        if not kept:
            kept.update(kf_row=kf_row, prob=st["prob"], sel=st["sel"])

    tracker._stage_local_ba_build = build_and_keep
    times, flushes = {}, []

    def step(i, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i is None:
            flushes.append(dt)
        else:
            times[i] = dt

    kernels.reset_launches()
    t0 = time.perf_counter()
    run_bench_schedule(tracker, imgs, step=step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    del tracker._stage_local_ba_build
    states = [s.name for s in tracker.frame_states]
    require(len(states) == BENCH_FRAMES and all(s == "OK" for s in states),
            f"tracker: frame states {states}")
    for name in TRACKER_COUNTERS:
        require(launches[name] > 0, f"kernel {name} was not launched by the tracker")
    require(launches["finish_keypoints"] == BENCH_FRAMES,
            f"tracker: {launches['finish_keypoints']} finish_keypoints launches over "
            f"{BENCH_FRAMES} frames")
    bad = map_finite(tracker.map)
    require(not bad, f"tracker: non-finite map fields {bad}")
    ate = aligned_ate(tracker.trajectory)
    require(ate <= 2 * JAX_SCHEDULE_ATE_M,
            f"tracker: ATE {ate:.4f} m > 2 x the JAX reference's {JAX_SCHEDULE_ATE_M} m")
    require("prob" in kept, "tracker: no local BA was built")
    # bench.py's per-frame latency: a pair's two calls amortized over its frames.
    meas = [times[i] for i in sorted(times)]
    pairs = [(meas[k] + meas[k + 1]) / 2 for k in range(0, len(meas) - 1, 2)]
    amortized = [v for v in pairs for _ in (0, 1)]
    windows = [BENCH_WINDOW / ((sum(meas[w * BENCH_WINDOW:(w + 1) * BENCH_WINDOW]) + flushes[w])
                               / 1e3) for w in range(len(flushes))]
    return dict(
        tracker=tracker, imgs=imgs, kept=kept, frame_ms=meas, flush_ms=flushes,
        frame_ms_p50=float(np.percentile(amortized, 50)),
        frame_ms_p90=float(np.percentile(amortized, 90)), frame_ms_max=float(max(amortized)),
        call_ms_max=float(max(meas)), fps_windows=windows, fps=float(max(windows)),
        wall_s=wall_s, launches=launches, keyframes=tracker.stats.n_keyframes,
        keyframe_rows=int(tracker.map.n_kf), valid_keyframes=int(tracker.map.kf.valid.sum()),
        valid_points=int(tracker.map.mp.valid.sum()), allocated_points=int(tracker.map.n_mp),
        stages=dict(tracker.stats.stages), ate_m=ate, states=states)


def tracker_to(src: StereoTracker, device) -> StereoTracker:
    """An independent copy of an idle tracker (nothing in flight, no stage
    queued) on `device`."""
    if src._pending or src._pair_buf or src._stage_q:
        raise ValueError("tracker_to: the tracker has work in flight")
    dst = StereoTracker(src.cam, src.cfg, client=src.client, device=device)
    for name, v in vars(src).items():
        if name == "device":
            continue
        if isinstance(v, ms.MapState):
            v = ms.clone(ms.MapState(ms.KeyFrames(*(t.to(device) for t in v.kf)),
                                     ms.MapPoints(*(t.to(device) for t in v.mp)),
                                     v.n_kf.to(device), v.n_mp.to(device)))
        elif isinstance(v, frame_mod.FrameData):
            v = frame_mod.FrameData(*(t.to(device, copy=True) for t in v))
        elif isinstance(v, torch.Tensor):
            v = v.to(device, copy=True)
        elif isinstance(v, (list, dict)) or dataclasses.is_dataclass(v):
            v = copy.deepcopy(v)
        setattr(dst, name, v)
    return dst


def compare_tracker_with_cpu(imgs) -> dict:
    """Frames 1..CPU_PREFIX-1 of the schedule (the 6 forced keyframes and
    their mapping stages, local-BA writebacks included, run at frame 6) by a
    fresh tracker on the card and by its copy on the CPU plain path, both
    from the card's frame 0 (the first keyframe: features built on the card,
    as the tracking phase's CPU check starts from the card's seeded map):
    per-frame states and keyframe schedule exact, n_local within 1 %, camera
    centres within 1e-3 m."""
    g = StereoTracker(CAM, bench_config(), device="cuda")
    g.process_stereo(*imgs[0], 0.0)
    c = tracker_to(g, "cpu")
    run_bench_schedule(g, imgs[:CPU_PREFIX], stop=CPU_PREFIX, start=1)
    run_bench_schedule(c, [(l.cpu(), r.cpu()) for l, r in imgs[:CPU_PREFIX]], stop=CPU_PREFIX,
                       start=1)
    sg, sc = [s.name for s in g.frame_states], [s.name for s in c.frame_states]
    n = int(g.map.n_kf)
    lg, lc = np.asarray(g.stats.inliers_history), np.asarray(c.stats.inliers_history)
    d = [center_distance(torch.from_numpy(a), torch.from_numpy(b))
         for (_, a), (_, b) in zip(g.trajectory, c.trajectory)]
    out = dict(frames=CPU_PREFIX, states=sg, keyframes=n, stages=dict(c.stats.stages),
               n_local_card=lg.tolist(), n_local_cpu=lc.tolist(), center_diff_m=d,
               map_pos_diff_m=float((g.map.mp.pos.cpu() - c.map.mp.pos).abs().max()),
               kf_pose_diff=float((g.map.kf.Tcw.cpu() - c.map.kf.Tcw).abs().max()))
    print(f"tracker vs CPU plain path (before the checks): {out}", flush=True)
    require(sg == sc, f"tracker prefix: states card {sg} vs CPU {sc}")
    require(n == int(c.map.n_kf) and torch.equal(g.map.kf.frame_id[:n].cpu(), c.map.kf.frame_id[:n])
            and torch.equal(g.map.kf.valid.cpu(), c.map.kf.valid),
            "tracker prefix: keyframe schedule differs from the CPU plain path")
    require(c.stats.stages["ba_b"] >= 1, "tracker prefix: no local-BA writeback ran")
    require(lg.shape == lc.shape and bool((np.abs(lg - lc) <= 0.01 * lc).all()),
            f"tracker prefix: n_local card {lg.tolist()} vs CPU {lc.tolist()}")
    require(max(d) <= 1e-3, f"tracker prefix: camera centres {max(d):.2e} m apart > 1e-3 m")
    return out


# ---------------------------------------------------------------------------
# Phase 8: K8 and K7's mapping launches against their plain versions
# ---------------------------------------------------------------------------

def ba_errors(k, p, cam, pb) -> dict:
    """K8 against the plain version: pose and point differences, cost
    relative difference, and inlier flips, allowed only where the final chi2
    lies within 1e-3 (relative) of its gate."""
    Tk, Tp = k.Tcw, p.Tcw
    dt = float((Tk[:, :3, 3] - Tp[:, :3, 3]).abs().max())
    drot = float((Tk[:, :3, :3] @ Tp[:, :3, :3].transpose(1, 2)
                  - torch.eye(3, device=Tk.device)).abs().max())
    dx = (k.X - p.X).abs().max(dim=1).values
    c2 = ba_dense._chi2(ba_dense._linearize(cam, pb._replace(Tcw=p.Tcw, X=p.X)))
    d2 = reproj.chi2_threshold(pb.obs_stereo)
    flips = k.inlier != p.inlier
    return dict(t_max_abs=dt, rot=drot, x_max_abs=float(dx.max()),
                x_frac_1mm=float((dx <= 1e-3).float().mean()),
                cost_rel=abs(float(k.cost) - float(p.cost)) / max(abs(float(p.cost)), 1e-12),
                flips=int(flips.sum()),
                flips_off_gate=int((flips & ((c2 - d2).abs() > 1e-3 * d2)).sum()),
                trace_kernel=k.trace.tolist(), trace_plain=p.trace.tolist(),
                inliers=int(k.inlier.sum()))


def same_ba(cam, pb, n_iters, huber_iters, name, one_step=False, cg_iters=16) -> tuple:
    k = ba_dense.optimize(cam, pb, n_iters, cg_iters, huber_iters)
    p = ba_dense.optimize_plain(cam, pb, n_iters, cg_iters, huber_iters)
    torch.cuda.synchronize()
    e = ba_errors(k, p, cam, pb)
    require(e["cost_rel"] <= 1e-3, f"ba_dense ({name}): cost differs by {e['cost_rel']:.2e} (rel)")
    require(e["flips_off_gate"] == 0, f"ba_dense ({name}): {e['flips_off_gate']} inlier flips "
            "away from the chi2 gate")
    if one_step:
        # Points: 99.5 % within 1e-3 m; a point whose active observations
        # barely fix its depth (one mono ray) moves on rounding alone.
        require(e["t_max_abs"] <= 1e-4 and e["rot"] <= 1e-4 and e["x_frac_1mm"] >= 0.995,
                f"ba_dense ({name}): one LM iteration differs by {e['t_max_abs']:.2e} m / "
                f"{e['rot']:.2e} rad, {e['x_frac_1mm']:.2%} of the points within 1e-3 m")
    return k, e


def same_twice(a, b, name: str) -> None:
    """Two K8 runs on one input: the same poses, points, inliers and cost,
    bit for bit (its sums run in a fixed order)."""
    torch.cuda.synchronize()
    for f in ("Tcw", "X", "inlier", "cost", "trace"):
        require(torch.equal(getattr(a, f), getattr(b, f)),
                f"ba_dense ({name}): two runs on one input differ in {f}")


def same_point_major(obs_mp, active, P, K, name) -> dict:
    k = ba_dense.build_point_major(obs_mp, active, P, K)
    p = ba_dense.build_point_major_plain(obs_mp, active, P, K)
    torch.cuda.synchronize()
    for a, b, f in zip(k, p, ("pm_src", "pm_ok", "active")):
        require(torch.equal(a, b), f"ba_point_major ({name}): {f} differs in "
                f"{(a != b).sum().item()} places")
    count = torch.zeros(P + 1, dtype=torch.long, device=obs_mp.device).index_add_(
        0, torch.where(active, obs_mp, torch.full_like(obs_mp, P)).reshape(-1).long(),
        torch.ones(obs_mp.numel(), dtype=torch.long, device=obs_mp.device))[:P]
    return dict(max_obs_per_point=int(count.max()), overflowing_points=int((count > K).sum()),
                dropped=int((active & ~k[2]).sum()))


def overflow_problem(dev, seed=3, C=6, Fb=64, P=40, K=4):
    """A small problem whose points are seen ~8 times (some twice in a row)
    with K = 4 table slots, so the even-stride overflow rule is live.
    Returns (BADense with its table, the active mask before the table)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, P), rng.uniform(-1, 1, P), rng.uniform(8, 12, P)], -1)
    T = np.stack([se3.exp(torch.tensor([rng.uniform(-.5, .5), 0, rng.uniform(-.3, .3), 0,
                                        rng.uniform(-.02, .02), 0], dtype=torch.float32)).numpy()
                  for _ in range(C)])
    obs_mp = rng.integers(0, P, (C, Fb)).astype(np.int32)
    pc = np.einsum("cij,cfj->cfi", T[:, :3, :3], X[obs_mp]) + T[:, None, :3, 3]
    u = CAM.fx * pc[..., 0] / pc[..., 2] + CAM.cx + rng.normal(0, 1, (C, Fb))
    v = CAM.fy * pc[..., 1] / pc[..., 2] + CAM.cy + rng.normal(0, 1, (C, Fb))
    ur = np.where(rng.random((C, Fb)) < 0.7, u - CAM.bf / pc[..., 2], -1.0)
    active = rng.random((C, Fb)) < 0.8
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    obs, raw = t(obs_mp, torch.int32), t(active, torch.bool)
    pm_src, pm_ok, act = ba_dense.build_point_major_plain(obs, raw, P, K)
    T0 = T.copy()
    T0[1:, :3, 3] += rng.normal(0, 0.05, (C - 1, 3))
    return ba_dense.BADense(
        t(T0), t(np.arange(C) == 0, torch.bool), t(X + rng.normal(0, 0.05, X.shape)),
        t(np.zeros(P, bool), torch.bool), obs, t(np.stack([u, v, ur])),
        t(np.ones((C, Fb))), t(ur > 0, torch.bool), act, pm_src, pm_ok), raw


def k8_bound(pb, trace) -> tuple:
    """K8's bound, from a problem and the CG iterations of each LM iteration
    the kernel ran (`trace`). Bytes: every slot's active flag; obs_mp, u, v,
    u_right, inverse sigma^2 and the stereo flag (21 bytes) of the active
    slots; the table's flags and its ok entries; points and their fixed
    flags; poses and flags; the poses, points, inlier mask and cost out.
    Operations per LM iteration: ~500 per active observation (linearize +
    camera blocks ~210, point blocks ~60, the RHS ~80, back-substitution
    and the cost at the new state ~150) and ~200 per active observation and
    30 per point for each Schur product (the warm start's and one per CG
    iteration)."""
    C, Fb = pb.obs_mp.shape
    P, K = pb.pm_src.shape
    n_act = int(pb.obs_active.sum())
    n_pm = int(pb.pm_ok.sum())
    k8_bytes = (C * Fb + n_act * 21 + P * K + n_pm * 4 + P * 13 + C * 65
                + C * 64 + P * 12 + C * Fb + 4)
    k8_ops = sum(n_act * 500 + (int(cg) + 1) * (n_act * 200 + P * 30) for cg, _ in trace)
    return bound_ms(k8_bytes, k8_ops)


def compaction_edges(dev) -> dict:
    """K7's compaction against its plain version where its 4096-row tiles
    and 16-byte loads meet an edge: a ragged top tile, no True row, exactly
    k True rows, every row True, fewer rows than one load, and a mask that
    starts off a 16-byte boundary. {case: True rows}."""
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, n, n_true, k in (("ragged", 4096 * 3 + 77, 900, 512), ("all_false", 5000, 0, 64),
                               ("exactly_k", 6000, 64, 64), ("all_true", 4096, 4096, 100),
                               ("tiny", 10, 3, 4), ("unaligned", 9001, 700, 1000)):
        mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        mask[1 + torch.randperm(n, generator=gen, device=dev)[:n_true]] = True
        mask = mask[1:] if name == "unaligned" else mask[1:].clone()
        a, b = covis.compact_indices(mask, k), covis.compact_indices_plain(mask, k)
        require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                f"compact_indices ({name}: {n} rows, {n_true} True, k {k}): kernel and plain "
                "differ")
        out[name] = int(mask.sum())
    return out


def check_mapping_kernels(tp: dict, timed: bool = True) -> tuple:
    """K8 on the run's first full-width local-BA problem at the schedule's
    two calls (and one LM iteration), its table, a small overflowing problem;
    K7's top_covisible_of (k 8 / 16 / 32, self weight 0 and 2**30), window
    mask and compaction on the run's final map, and the compaction at its
    edges (`compaction_edges`). Rows for the kernels' line."""
    tracker, kept = tp["tracker"], tp["kept"]
    cam, cfg = tracker.cam, tracker.cfg
    pb = kept["prob"]
    P, K = pb.pm_src.shape
    info = dict(problem=dict(C=pb.Tcw.shape[0], Fb=pb.obs_mp.shape[1], P=P, K=K,
                             active=int(pb.obs_active.sum()), kf_row=kept["kf_row"],
                             window_rows=kept["sel"].kf_rows.tolist(),
                             window_ok=kept["sel"].kf_ok.tolist()))
    info["table"] = same_point_major(pb.obs_mp, pb.obs_active, P, K, "local BA")
    _, info["one_iteration"] = same_ba(cam, pb, 1, 3, "one LM iteration", one_step=True)
    n1 = max(cfg.mapping.local_ba_iters - 2, 1)
    ka, info["call_a"] = same_ba(cam, pb, n1, 3, "schedule call a")
    same_twice(ka, ba_dense.optimize(cam, pb, n1, 16, 3), "schedule call a")
    pb2 = pb._replace(Tcw=ka.Tcw, X=ka.X, obs_active=pb.obs_active & ka.inlier)
    _, info["call_b"] = same_ba(cam, pb2, 2, 0, "schedule call b")
    small, raw = overflow_problem(pb.X.device)
    info["overflow_table"] = same_point_major(small.obs_mp, raw, small.X.shape[0], 4, "overflow")
    require(info["overflow_table"]["overflowing_points"] > 0, "overflow case has no overflow")
    _, info["overflow_optimize"] = same_ba(cam, small, 3, 2, "overflow problem")

    m = tracker.map
    q = newest_keyframe(m)
    tops = {}
    for k in (8, 16, 32):
        for sw in (0, covis.SELF_WEIGHT_PINNED):
            a = covis.top_covisible_of(m, q, k, self_weight=sw)
            b = covis.top_covisible_plain(m, q, k, self_weight=sw)
            torch.cuda.synchronize()
            require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                    f"top_covisible_of (k={k}, self_weight={sw}): kernel and plain differ")
            tops[f"k{k}_w{sw}"] = dict(rows=a[0].tolist(), ok=a[1].tolist())
    win_rows, win_ok = covis.top_covisible_of(m, q, cfg.mapping.local_ba_window,
                                              self_weight=covis.SELF_WEIGHT_PINNED)
    pmask = covis.local_map_mask(m, win_rows, win_ok)
    require(torch.equal(pmask, covis.local_map_mask_plain(m, win_rows, win_ok)),
            "local_map_mask: kernel and plain differ")
    F = m.kf.n_features
    for k in (2 * F, 4 * F):
        a, b = covis.compact_indices(pmask, k), covis.compact_indices_plain(pmask, k)
        require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                f"compact_indices (k={k}): kernel and plain differ")
    info["compaction_edges"] = compaction_edges(pmask.device)
    info["top_covisible"] = dict(q=q, window_points=int(pmask.sum()), **tops)
    if not timed:
        return [], info

    info["bound_inputs"] = dict(ba_active=int(pb.obs_active.sum()),
                                ba_pm_ok=int(pb.pm_ok.sum()))
    # K7's mapping launches of one window selection: top_covisible_of (q's
    # row and its points' anchors, the distinct valid candidates' rows once),
    # the window's rows again for the point mask (+ the M validity flags),
    # the compaction of the [M] mask; out the window, mask and 4F rows.
    M, N = m.mp.capacity, m.kf.capacity
    cand, _ = covis.candidate_covis_weights(m, q)
    cand_rows = torch.unique(cand[m.kf.valid[cand.long()]])
    n_q = int(((m.kf.mp_idx[q] >= 0) & m.kf.fvalid[q]).sum())
    n_cand_obs = int(((m.kf.mp_idx[cand_rows.long()] >= 0) & m.kf.fvalid[cand_rows.long()]).sum())
    W = win_rows.shape[0]
    n_win_obs = int(((m.kf.mp_idx[win_rows[win_ok].long()] >= 0)
                     & m.kf.fvalid[win_rows[win_ok].long()]).sum())
    k7_bytes = (F * 5 + n_q * 4 + len(cand_rows) * (F * 5 + 1) + W * 5
                + int(win_ok.sum()) * F * 5 + M + M + 4 * F * 5)
    lg = lambda n: max(1, int(np.ceil(np.log2(n))))  # noqa: E731
    C7 = cand.shape[0]
    k7_ops = (n_q + N * lg(C7) + 2 * n_cand_obs + 2 * C7 * lg(C7) + n_win_obs + M + 2 * M)
    info["bound_inputs"].update(covis_bytes=k7_bytes, covis_ops=k7_ops,
                                candidate_rows_read=len(cand_rows))
    row_ids = torch.arange(M, device=pmask.device)

    def covis_kernel():
        r, o = covis.top_covisible_of(m, q, W, self_weight=covis.SELF_WEIGHT_PINNED)
        covis.compact_indices(covis.local_map_mask(m, r, o), 4 * F)

    def covis_plain():
        r, o = covis.top_covisible_plain(m, q, W, self_weight=covis.SELF_WEIGHT_PINNED)
        covis.compact_indices_plain(covis.local_map_mask_plain(m, r, o), 4 * F)

    info["launch_ms"] = launch_times(covis_kernel)
    rows = [
        dict(name="covisibility", max_abs_err=0.0, bound=bound_ms(k7_bytes, k7_ops),
             fns=(covis_kernel, covis_plain,
                  lambda: torch.topk(pmask.to(torch.int64) * (M + 1) + row_ids, 4 * F), 5)),
        dict(name="ba_dense", max_abs_err=info["call_a"]["t_max_abs"],
             bound=k8_bound(pb, info["call_a"]["trace_kernel"]),
             fns=(lambda: ba_dense.optimize(cam, pb, n1, 16, 3),
                  lambda: ba_dense.optimize_plain(cam, pb, n1, 16, 3), None, 1),
             kernel_reps=5, events=True),
    ]
    return rows, info


def time_stages(tp: dict, reps: int = 2) -> dict:
    """Per mapping stage, for the newest keyframe of the run's final map and
    each call on its own copy of the map (the stages write in place): the
    device time of one call (torch.profiler's kernel sum), the span between
    CUDA events around one call on the stream, and the host-inclusive time."""
    from torch.profiler import ProfilerActivity, profile

    tracker = tp["tracker"]
    cam, cfg = tracker.cam, tracker.cfg
    m0, q = tracker.map, newest_keyframe(tracker.map)
    cg = cfg.mapping.local_ba_cg_iters
    sel, prob = local_mapping.local_ba_build(ms.clone(m0), q, cfg)
    n1 = max(cfg.mapping.local_ba_iters - 2, 1)
    res_a = ba_dense.optimize(cam, prob, n1, cg, 3)
    prob2 = prob._replace(Tcw=res_a.Tcw, X=res_a.X, obs_active=prob.obs_active & res_a.inlier)

    def ba_b(m):
        r = ba_dense.optimize(cam, prob2, 2, cg, 0)
        return local_mapping.local_ba_writeback(m, sel.kf_rows, sel.kf_free, sel.kf_ok,
                                                sel.mp_rows, sel.mp_ok, r.Tcw, r.X, r.inlier,
                                                prob.obs_active)

    stages = {
        "fuse": lambda m: local_mapping.fuse_into_kf(cam, m, q, cfg),
        "cull_points": lambda m: local_mapping.cull_map_points(m, q, cfg),
        "refresh": lambda m: local_mapping.refresh_point_geometry(m, q, cfg),
        "ba_build": lambda m: local_mapping.local_ba_build(m, q, cfg),
        "ba_a": lambda m: ba_dense.optimize(cam, prob, n1, cg, 3),
        "ba_b": ba_b,
        "cull_keyframes": lambda m: local_mapping.cull_keyframes(m, q, cfg),
        "sweep": local_mapping.sweep_detached,
    }
    out = {}
    for name, run in stages.items():
        maps = [ms.clone(m0) for _ in range(reps + 2)]
        run(maps[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(maps[1])
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for mm in maps[2:]:
                run(mm)
            torch.cuda.synchronize()
        us = sum(ev.device_time_total for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = dict(device_ms=us / 1e3 / reps, event_ms=start.elapsed_time(end),
                         host_ms=host)
        del maps
    return out



# ---------------------------------------------------------------------------
# Phase 9: loop closing and relocalization (K9 vocab, K10 sim3 / pnp, K11)
# ---------------------------------------------------------------------------

# The JAX yardstick of the loop phase (PERF.md): the reference's
# tracker with its LoopCloser on the same orbit, on a CPU.
JAX_LOOP = dict(kf_q=48, kf_c=7, keyframes=49, detections=36, attempts=146, ate_m=0.0693)
LOOP_KERNELS = ("vocab", "sim3", "pnp", "pose_graph", "covis_matrix")
LOOP_COUNTERS = TRACKER_COUNTERS + LOOP_KERNELS


def orbit_ate(traj) -> float:
    """Aligned ATE of the first len(traj) orbit frames (tools/loop_e2e.py's)."""
    est = np.asarray([np.linalg.inv(np.asarray(T, np.float64)) for _, T in traj])
    gtw = np.asarray([np.linalg.inv(orbit_pose(i).numpy().astype(np.float64))
                      for i in range(len(est))])
    return trajectory.ate_rmse(est, gtw, align=True)


def keyframe_ate(m) -> float:
    """Aligned ATE of the live keyframes' poses against their frames' truth."""
    rows = torch.nonzero(m.kf.valid)[:, 0]
    T = m.kf.Tcw[rows].double().cpu().numpy()
    fid = m.kf.frame_id[rows].cpu().numpy()
    gtw = np.asarray([np.linalg.inv(orbit_pose(int(i)).numpy().astype(np.float64)) for i in fid])
    return trajectory.ate_rmse(np.linalg.inv(T), gtw, align=True)


def run_loop_phase() -> dict:
    """The loop orbit (entry.loop_entry: 71 frames of the room rendered on the
    card, all counters reset just before), then a frame marked LOST by hand
    (relocalized against the database) and one more frame. Keeps the map
    before the first closure; times each loop stage and the closure."""
    tracker, le = loop_entry("cuda")
    n = LOOP_FRAMES
    imgs = [le.world.render_stereo(orbit_pose(i)) for i in range(n + 2)]
    torch.cuda.synchronize()
    lc = tracker.loop_closer
    kept, stage_ms, close_ms = {}, [], []
    close, stage = lc.close_loop, tracker._stage_loop_closing

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def close_and_keep(m, kf_q, kf_c, sb):
        if not kept:
            kept.update(m=ms.clone(m), kf_q=kf_q, kf_c=kf_c, sb=sb,
                        keyframe_ate_before_m=keyframe_ate(m))
        a, b = events()
        a.record()
        out = close(m, kf_q, kf_c, sb)
        b.record()
        torch.cuda.synchronize()
        close_ms.append(a.elapsed_time(b))
        kept.setdefault("keyframe_ate_after_m", keyframe_ate(out))
        return out

    def timed_stage(kf_row):
        a, b = events()
        a.record()
        stage(kf_row)
        b.record()
        torch.cuda.synchronize()
        stage_ms.append(a.elapsed_time(b))

    # Each relocalization candidate tried runs one PnP RANSAC.
    candidate, tried = reloc.try_relocalize_against, []

    def counted_candidate(*args, **kw):
        tried.append(args[2])
        return candidate(*args, **kw)

    lc.close_loop, tracker._stage_loop_closing = close_and_keep, timed_stage
    reloc.try_relocalize_against = counted_candidate
    frame_ms = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for i in range(n):
            t1 = time.perf_counter()
            tracker.process_stereo(*imgs[i], 0.1 * i)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        tracker.flush()
        states = [s.name for s in tracker.frame_states]
        traj = list(tracker.trajectory)
        kf_ate_orbit = keyframe_ate(tracker.map)
        tracker.state = TrackerState.LOST  # by hand: the next frame relocalizes
        for i in (n, n + 1):
            tracker.process_stereo(*imgs[i], 0.1 * i)
        tracker.flush()
        torch.cuda.synchronize()
    finally:
        reloc.try_relocalize_against = candidate
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    del lc.close_loop, tracker._stage_loop_closing
    st = lc.stats
    out = dict(
        tracker=tracker, imgs=imgs, kept=kept, frames=n, states_ok=states.count("OK"),
        keyframes=tracker.stats.n_keyframes, detections=st.n_detections,
        attempts=st.n_sim3_attempts, loops=st.n_loops_closed, last_loop=st.last_loop,
        first_loop=(kept.get("kf_q"), kept.get("kf_c")), sim3_log=list(st.sim3_log),
        relocalizations=tracker.stats.n_relocalizations, reloc_candidates=tried,
        after_lost=[s.name for s in tracker.frame_states[n:]], ate_m=orbit_ate(traj),
        keyframe_ate_m=kf_ate_orbit, keyframe_ate_final_m=keyframe_ate(tracker.map),
        keyframe_ate_around_closure_m=(kept.get("keyframe_ate_before_m"),
                                       kept.get("keyframe_ate_after_m")), frame_ms=frame_ms,
        frame_ms_p50=float(np.percentile(frame_ms, 50)),
        frame_ms_p90=float(np.percentile(frame_ms, 90)), loop_stage_ms=stage_ms,
        close_ms=close_ms, stages=dict(tracker.stats.stages), wall_s=wall_s, launches=launches)
    print(f"loop phase (before the checks): {json.dumps({k: v for k, v in out.items() if k not in ('tracker', 'imgs', 'kept')}, default=str)}", flush=True)
    require(len(states) == n and states.count("OK") == n, f"loop: frame states {states}")
    require(st.n_loops_closed >= 1 and kept, "loop: no loop closed")
    kf_q, kf_c = kept["kf_q"], kept["kf_c"]
    require(kf_q - kf_c > 20, f"loop: closure {kf_q} <-> {kf_c} is not a loop")
    require(abs(kf_q - JAX_LOOP["kf_q"]) <= 3 and abs(kf_c - JAX_LOOP["kf_c"]) <= 3,
            f"loop: closure {kf_q} <-> {kf_c}, the JAX yardstick's {JAX_LOOP['kf_q']} <-> "
            f"{JAX_LOOP['kf_c']}")
    require(out["ate_m"] <= 2 * JAX_LOOP["ate_m"],
            f"loop: ATE {out['ate_m']:.4f} m > 2 x the JAX yardstick's {JAX_LOOP['ate_m']} m")
    m = tracker.map
    require(bool(torch.isfinite(m.kf.Tcw[m.kf.valid]).all()), "loop: non-finite keyframe pose")
    require(tracker.stats.n_relocalizations >= 1 and out["after_lost"] == ["OK", "OK"],
            f"loop: the frame marked LOST did not relocalize ({out['after_lost']})")
    for name in LOOP_COUNTERS:
        require(launches[name] > 0, f"kernel {name} was not launched by the loop phase")
    require(launches["sim3"] == st.n_sim3_attempts,
            f"loop: {launches['sim3']} Sim3 launches for {st.n_sim3_attempts} attempts")
    require(launches["pnp"] == len(tried),
            f"loop: {launches['pnp']} PnP launches for {len(tried)} relocalization candidates")
    return out


def idle_stage_ate(imgs) -> float:
    """The flagship schedule with every keyframe queueing one more mapping
    stage that does nothing, where a loop closer queues its loop-closing
    stage: the aligned ATE."""
    tracker, _ = tracker_entry("cuda")
    enqueue = tracker._enqueue_mapping_stages

    def with_idle_stage(kf_row):
        enqueue(kf_row)
        tracker._stage_q.append(("idle", lambda: None))

    tracker._enqueue_mapping_stages = with_idle_stage
    run_bench_schedule(tracker, imgs)
    return aligned_ate(tracker.trajectory)


def run_flagship_with_loop_closer(kp: dict) -> dict:
    """The flagship schedule again with a LoopCloser (vocab32k, global BA off)
    on KITTI_STEREO at full capacity: its 9 keyframes never reach detection,
    so keyframes and points equal the run without it. Each keyframe's
    loop-closing stage takes a place in the stage queue (one stage a frame,
    more while more than 4 wait), so the later mapping stages run frames
    earlier and the trajectory moves: the ATE is held to a run whose
    keyframes queue a stage that does nothing in its place."""
    tracker, _ = tracker_entry("cuda", loop_closer=True)
    times = {}

    def step(i, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i is not None:
            times[i] = (time.perf_counter() - t0) * 1e3

    kernels.reset_launches()
    run_bench_schedule(tracker, kp["imgs"], step=step)
    launches = dict(kernels.LAUNCHES)
    meas = [times[i] for i in sorted(times)]
    pairs = [(meas[k] + meas[k + 1]) / 2 for k in range(0, len(meas) - 1, 2)]
    out = dict(tracker=tracker, ate_m=aligned_ate(tracker.trajectory),
               keyframes=tracker.stats.n_keyframes,
               valid_points=int(tracker.map.mp.valid.sum()),
               db_rows=int(tracker.loop_closer.db.valid.sum()),
               db_mb=tracker.loop_closer.db.bow.numel() * 4 / 2 ** 20,
               frame_ms_p50=float(np.percentile(pairs, 50)),
               frame_ms_p90=float(np.percentile(pairs, 90)), launches=launches,
               stages=dict(tracker.stats.stages))
    require(out["keyframes"] == kp["keyframes"] and out["valid_points"] == kp["valid_points"],
            f"flagship + loop closer: {out['keyframes']} keyframes / {out['valid_points']} "
            f"points, without it {kp['keyframes']} / {kp['valid_points']}")
    out["idle_stage_ate_m"] = idle_stage_ate(kp["imgs"])
    require(abs(out["ate_m"] - out["idle_stage_ate_m"]) <= 1e-4,
            f"flagship + loop closer: ATE {out['ate_m']} vs {out['idle_stage_ate_m']} with an idle "
            f"stage in its place ({kp['ate_m']} without either)")
    require(launches["vocab"] > 0 and all(s == "OK" for s in (x.name for x in tracker.frame_states)),
            "flagship + loop closer: no BoW launch or a frame not OK")
    return out


def gate_flips(inl_kernel, inl_plain, errs_and_gates) -> tuple:
    """(flips, flips off the gate): the entries whose inlier flag differs
    between kernel and plain, and those of them whose chi2 at the plain
    model lies more than 1e-3 (relative) from its gate in every camera."""
    flips = inl_kernel != inl_plain
    near = torch.zeros_like(flips)
    for e, gate in errs_and_gates:
        near |= (e - gate).abs() <= 1e-3 * gate
    return int(flips.sum()), int((flips & ~near).sum())


def same_sim3(cam, mt, idx, fix_scale: bool = True) -> dict:
    """K10's Sim3 attempt against the plain versions on one match set and
    index draw: the RANSAC alone and the refinement alone (from the plain
    RANSAC's model) on the kernel's two modes, then the whole attempt
    (`solve_and_refine_sim3`, one launch, twice: bit-equal) against the
    plain sequence. The chosen inlier counts equal, inlier flips only within
    1e-3 of the gate, R 1e-5, t 1e-4, refinement and combine 1e-4."""
    a = sim3_solver.solve_sim3_ransac(cam, cam, *mt, idx=idx, min_inliers=20, fix_scale=fix_scale)
    b = sim3_solver.solve_sim3_ransac_plain(cam, cam, *mt, idx, 20, fix_scale)
    ra = sim3_solver.refine_sim3_iterative(cam, cam, *mt, b.R, b.t, b.s, fix_scale)
    rb = sim3_solver.refine_sim3_iterative_plain(cam, cam, *mt, b.R, b.t, b.s, fix_scale)
    attempt = lambda: sim3_solver.solve_and_refine_sim3(  # noqa: E731
        cam, cam, *mt, idx=idx, min_inliers=20, fix_scale=fix_scale)
    require(launches_of(attempt, "sim3") == 1, "sim3: more than one launch an attempt")
    ka, ka2 = attempt(), attempt()
    kb = sim3_solver.solve_and_refine_sim3_plain(cam, cam, *mt, idx, 20, fix_scale)
    torch.cuda.synchronize()
    flat = lambda x: [*x.ransac, *x.refined, x.R, x.t, x.s, x.n_inliers]  # noqa: E731
    require(all(torch.equal(u, v) for u, v in zip(flat(ka), flat(ka2))),
            "sim3: two attempts on one input differ")
    p1, p2, _, s2_1, s2_2 = mt

    def flips(inl_k, inl_p, R, t, s):
        e1, e2, _ = sim3_solver._sim3_chi2(cam, cam, p1, p2, R, t, s)
        return gate_flips(inl_k, inl_p, ((e1, sim3_solver.CHI2_SIM3 * s2_1),
                                         (e2, sim3_solver.CHI2_SIM3 * s2_2)))

    diff = lambda u, v: float((u - v).abs().max())  # noqa: E731
    f, f_off = flips(a.inliers, b.inliers, b.R, b.t, b.s)
    rf, rf_off = flips(ra[3], rb[3], *rb[:3])
    af, af_off = flips(ka.ransac.inliers, kb.ransac.inliers, *kb.ransac[:3])
    arf, arf_off = flips(ka.refined[3], kb.refined[3], *kb.refined[:3])
    out = dict(n_inliers=(int(a.n_inliers), int(b.n_inliers)), flips=f, flips_off_gate=f_off,
               R=diff(a.R, b.R), t=diff(a.t, b.t),
               refine_n=(int(ra[4]), int(rb[4])), refine_flips=rf, refine_flips_off_gate=rf_off,
               refine_R=diff(ra[0], rb[0]), refine_t=diff(ra[1], rb[1]),
               attempt_n=[(int(x), int(y)) for x, y in ((ka.ransac.n_inliers, kb.ransac.n_inliers),
                                                        (ka.refined[4], kb.refined[4]),
                                                        (ka.n_inliers, kb.n_inliers))],
               attempt_flips_off_gate=(af_off, arf_off), attempt_flips=(af, arf),
               attempt_ransac_R=diff(ka.ransac.R, kb.ransac.R),
               attempt_ransac_t=diff(ka.ransac.t, kb.ransac.t),
               attempt_refine_R=diff(ka.refined[0], kb.refined[0]),
               attempt_refine_t=diff(ka.refined[1], kb.refined[1]),
               combined_R=diff(ka.R, kb.R), combined_t=diff(ka.t, kb.t),
               combined_s=diff(ka.s, kb.s))
    require(out["n_inliers"][0] == out["n_inliers"][1] and f_off == 0 and out["R"] <= 1e-5
            and out["t"] <= 1e-4 and out["refine_n"][0] == out["refine_n"][1] and rf_off == 0
            and out["refine_R"] <= 1e-4 and out["refine_t"] <= 1e-4,
            f"sim3: kernel and plain differ {out}")
    require(all(x == y for x, y in out["attempt_n"]) and af_off == 0 and arf_off == 0
            and out["attempt_ransac_R"] <= 1e-5 and out["attempt_ransac_t"] <= 1e-4
            and max(out["attempt_refine_R"], out["combined_R"], out["combined_s"]) <= 1e-4
            and max(out["attempt_refine_t"], out["combined_t"]) <= 1e-4,
            f"sim3: the attempt and the plain sequence differ {out}")
    return out


def nan_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|, NaN where only one of them is NaN, 0 where both are."""
    both = torch.isnan(a) & torch.isnan(b)
    return float(torch.where(both, torch.zeros_like(a), (a - b).abs()).max())


def same_pnp(cam, X, uv, valid, sigma2, idx, name: str) -> dict:
    """K10's PnP RANSAC against the plain version on one match set and draw:
    one launch, two runs bit-equal, the chosen inlier counts and ok equal,
    inlier flips only within 1e-3 of the gate, R within 1e-4 and t within
    1e-4 of its norm; the outputs' hash (to compare trees). A six-point DLT
    is ill-conditioned: at the flagship's 19 m translation a float64 DLT of
    the chosen sample lies 2.2e-3 / 3.4e-3 m from the plain / kernel f32
    poses (PERF.md). Where the winner has fewer than 6 inliers (the edges'
    degenerate draws: no match supports it) its pose is the null vector of
    a rank-deficient system, set by rounding alone, and is not compared."""
    call = lambda: pnp.solve_pnp_ransac(cam, X, uv, valid, sigma2, idx=idx)  # noqa: E731
    require(launches_of(call, "pnp") == 1, f"pnp ({name}): more than one launch a RANSAC")
    a, a2 = call(), call()
    b = pnp.solve_pnp_ransac_plain(cam, X, uv, valid, sigma2, idx)
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(a, a2)), f"pnp ({name}): two runs differ")
    e = ((camera.project(cam, se3.transform(b.Tcw, X)) - uv) ** 2).sum(-1)
    f, f_off = gate_flips(a.inliers, b.inliers, ((e, 5.991 * sigma2),))
    out = dict(n_inliers=(int(a.n_inliers), int(b.n_inliers)), ok=(bool(a.ok), bool(b.ok)),
               flips=f, flips_off_gate=f_off, R=nan_diff(a.Tcw[:3, :3], b.Tcw[:3, :3]),
               t=nan_diff(a.Tcw[:3, 3], b.Tcw[:3, 3]), t_norm=float(b.Tcw[:3, 3].norm()),
               N=int(X.shape[0]), valid=int(valid.sum()), hash=digest(*a))
    posed = out["n_inliers"][1] >= 6
    require(out["n_inliers"][0] == out["n_inliers"][1] and out["ok"][0] == out["ok"][1]
            and f_off == 0 and (not posed or (out["R"] <= 1e-4
                                              and out["t"] <= 1e-4 * max(1.0, out["t_norm"]))),
            f"pnp ({name}): kernel and plain differ {out}")
    return out


def pnp_edges(dev) -> dict:
    """K10's PnP RANSAC at its edges (`kernel_times.pnp_edge_inputs`: N = 1,
    N at the kernel's capacity, N = 1000, no valid match, two degenerate
    rows, an all-degenerate draw whose counts tie), each by `same_pnp`; one
    match past the capacity is refused."""
    out = {k: same_pnp(CAM, *v, name=k) for k, v in pnp_edge_inputs(CAM, dev).items()}
    X, uv, valid, s2 = pnp_scene(CAM, pnp.PNP_MAX_N + 1, dev=dev)
    try:
        pnp.solve_pnp_ransac(CAM, X, uv, valid, s2)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"pnp: {pnp.PNP_MAX_N + 1} matches were not refused")
    return out


def same_vocab(voc, db, desc, valid) -> dict:
    wk, wp = vocab.assign(voc, desc), vocab.assign_plain(voc, desc)
    hk, hp = vocab.transform(voc, desc, valid), vocab.histogram_plain(voc, wp, valid)
    sk, sp = vocab.l1_scores(hk, db), vocab.l1_scores_plain(hp[None], db)[0]
    ik, vk = vocab.transform_sparse(voc, desc, valid)
    ip, vp = vocab.sparse_plain(voc, wp, valid)
    torch.cuda.synchronize()
    out = dict(word_mismatch=int((wk != wp).sum()), hist=float((hk - hp).abs().max()),
               scores=float((sk - sp).abs().max()), sparse_ids_equal=bool(torch.equal(ik, ip)),
               sparse=float((vk - vp).abs().max()))
    require(out["word_mismatch"] == 0 and out["hist"] <= 1e-6 and out["scores"] <= 1e-6
            and out["sparse_ids_equal"] and out["sparse"] <= 1e-6, f"vocab: kernel and plain "
            f"differ {out}")
    return out


def same_graph(g, n_iters=20, cg_iters=40, t_rel: bool = False) -> dict:
    """K11's linearization (1e-4 relative) and optimize against the plain
    versions (two kernel runs bit-equal, and two plain runs: the reference
    is held to one result): R and s within 1e-4, the cost
    within 1e-3 (relative), t within
    1e-4 m, or with `t_rel` within 1e-4 of the graph's extent (the largest
    |t|). The relative form is for graphs tens of metres across: there
    rounding alone moves the plain result further than 1e-4 m, and the
    report gives that sensitivity (the plain version again on translations
    scaled by 1 + 1.2e-7, about one f32 ulp)."""
    r, Ji, Jj = pose_graph.linearize_edges(g)
    r2, Ji2, Jj2 = pose_graph.linearize_edges_plain(g)
    (R, t, s), c = pose_graph.optimize(g, n_iters, cg_iters)
    (Rb, tb, sb), cb = pose_graph.optimize(g, n_iters, cg_iters)
    (R2, t2, s2), c2 = pose_graph.optimize_plain(g, n_iters, cg_iters)
    (R2b, t2b, s2b), c2b = pose_graph.optimize_plain(g, n_iters, cg_iters)
    torch.cuda.synchronize()
    for name, a, b in (("R", R, Rb), ("t", t, tb), ("s", s, sb), ("costs", c, cb)):
        require(torch.equal(a, b), f"pose_graph: two runs on one input differ in {name}")
    for name, a, b in (("R", R2, R2b), ("t", t2, t2b), ("s", s2, s2b), ("costs", c2, c2b)):
        require(torch.equal(a, b), f"pose_graph: two plain runs on one input differ in {name}")
    rel = lambda a, b: float((a - b).abs().max() / max(float(b.abs().max()), 1.0))  # noqa: E731
    out = dict(lin=[rel(r, r2), rel(Ji, Ji2), rel(Jj, Jj2)], t=float((t - t2).abs().max()),
               R=float((R - R2).abs().max()), s=float((s - s2).abs().max()),
               cost=float(((c - c2).abs() / c2.abs().clamp_min(1e-12)).max()),
               cost_first_last=[float(c[0]), float(c[-1])],
               edges=int(g.e_valid.sum()), vertices=int((~g.fixed).sum()))
    t_tol = 1e-4
    if t_rel:
        out["extent_m"] = float(t2.abs().max())
        t_tol = 1e-4 * out["extent_m"]
        (R3, t3, _), _ = pose_graph.optimize_plain(g._replace(t=g.t * (1 + 1.2e-7)), n_iters,
                                                   cg_iters)
        out["plain_t_ulp_sensitivity"] = float((t3 - t2).abs().max())
        out["plain_R_ulp_sensitivity"] = float((R3 - R2).abs().max())
    out["t_tol"] = t_tol
    require(max(out["lin"]) <= 1e-4 and out["t"] <= t_tol and out["R"] <= 1e-4
            and out["s"] <= 1e-4 and out["cost"] <= 1e-3,
            f"pose graph: kernel and plain differ {out}")
    return out


def check_loop_kernels(lp: dict) -> dict:
    """K9-K11 against their plain versions on the loop phase's own inputs:
    the first closure's query / candidate, their match set, the essential
    graph of the closure, its map for the covisibility count; PnP on the
    match set of a frame marked LOST, and relocalize on it."""
    tracker, kept = lp["tracker"], lp["kept"]
    cam, cfg, lc_ = tracker.cam, tracker.cfg, tracker.loop_closer
    m, kf_q, kf_c = kept["m"], kept["kf_q"], kept["kf_c"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    info = dict(kf_q=kf_q, kf_c=kf_c)
    # K1-K4 at the loop geometry (320x240, 512 features, 4 levels, 12-px cells).
    imgs = orb.as_images(list(lp["imgs"][0]), torch.device("cuda"))
    _, info["front_end"] = check_kernels(imgs, orb.params(cfg.orb, cam.height, cam.width, "cuda"),
                                         timed=False)
    info["vocab"] = same_vocab(lc_.voc, lc_.db.bow, m.kf.desc[kf_q], m.kf.fvalid[kf_q])
    mt = loop_closing.sim3_matches(m, kf_q, kf_c, cfg)
    info["sim3"] = same_sim3(cam, mt, sim3_solver.sample_indices(mt.pair_ok, 256, 3, gen))
    W, Wp = covis.covis_matrix(m), covis.covis_matrix_plain(m)
    require(torch.equal(W, Wp), "covis_matrix: kernel and plain differ on the loop map")
    info["covis_matrix"] = dict(equal=True, max=int(W.max()))
    m2 = ms.clone(m)
    sb = kept["sb"]
    m2, _ = loop_closing.correct_window(m2, kf_q, kf_c, sb.R, sb.t, sb.s, cfg)
    m2 = loop_closing.fuse_loop_points(cam, m2, kf_q, kf_c, cfg)
    loops = loop_closing.LoopEdges.empty(device="cuda").add(0, kf_c, kf_q, sb.R, sb.t, sb.s)
    g = loop_closing.build_essential_graph(m2, loops, kf_c, m.kf.Tcw)
    info["pose_graph"] = same_graph(g)
    # A frame of the orbit marked LOST: its BoW candidates, PnP on the best.
    fr = frame_mod.build_frame_stereo(*lp["imgs"][lp["frames"]], cam, cfg.orb, device="cuda")
    mf = tracker.map
    bow = vocab.transform(lc_.voc, fr.desc, fr.fvalid)
    rows, ok = database.detect_relocalization_candidates(lc_.db, mf, bow, k=5)
    require(bool(ok.any()), "relocalization: no candidate for the LOST frame")
    _, hit, X, sigma2 = reloc.reloc_matches(mf, int(rows[0]), fr, cfg)
    info["pnp"] = same_pnp(cam, X, fr.xy.contiguous(), hit, sigma2,
                           sim3_solver.sample_indices(hit, 256, 6, gen), "LOST frame")
    res = reloc.relocalize(cam, mf, lc_.db, lc_.voc, fr, cfg, generator=gen)
    require(res is not None and bool(res.ok), "relocalize failed on the LOST frame")
    T_gt = orbit_pose(lp["frames"]) @ se3.inverse(orbit_pose(0))  # in the map's frame
    info["relocalize"] = dict(n_inliers=int(res.n_inliers),
                              center_err_m=center_distance(res.Tcw.cpu(), T_gt))
    return info


def check_full_width(fl: dict) -> tuple:
    """K9-K11 at the flagship's sizes on its final map (with the loop closer:
    2048 features, the [2048, 32768] database): rows for the kernels' line
    with each bound from these inputs."""
    tracker = fl["tracker"]
    cam, cfg, lc_ = tracker.cam, tracker.cfg, tracker.loop_closer
    m, voc, db = tracker.map, lc_.voc, lc_.db.bow
    N, F, M = m.kf.capacity, m.kf.n_features, m.mp.capacity
    W, G, C = voc.n_words, voc.groups.shape[0], voc.child_idx.shape[1]
    live = torch.nonzero(m.kf.valid)[:, 0].tolist()
    q = live[-1]
    gen = torch.Generator(device="cuda").manual_seed(11)
    info, rows = {}, []
    # K9: one keyframe's BoW and its scores over the whole database.
    desc, valid = m.kf.desc[q], m.kf.fvalid[q]
    info["vocab"] = same_vocab(voc, db, desc, valid)
    nv = int(valid.sum())
    words = vocab.assign(voc, desc)
    k9_bytes = (F * 33 + G * 32 + F * 2 * C * (4 + 32) + W * 4 + N * W * 4 + W * 4
                + F * 4 + W * 4 + N * 4)
    # Distances as int8 products on the tensor cores, as the batched row
    # counts them; `bound_cuda_cores` with 24 CUDA-core operations each.
    k9_dist = F * (G + 2 * C)
    info["vocab_bound_cuda_cores"] = bound_ms(k9_bytes, k9_dist * 24 + 3 * W + nv + 2 * N * W)
    rows.append(dict(name="vocab", max_abs_err=max(info["vocab"]["hist"], info["vocab"]["scores"]),
                     bound=bound_ms(k9_bytes, 3 * W + nv + 2 * N * W, n_int8_ops=k9_dist * 512),
                     fns=(lambda: vocab.l1_scores(vocab.transform(voc, desc, valid), db),
                          lambda: vocab.l1_scores_plain(
                              vocab.histogram_plain(voc, vocab.assign_plain(voc, desc),
                                                    valid)[None], db), None, 5)))
    # K10 Sim3: keyframe b's points in its camera and under a known Sim3
    # (1 cm noise, a quarter of the rows shuffled as outliers): one attempt.
    mt, sidx = sim3_full_width(m, gen)
    info["sim3"] = same_sim3(cam, mt, sidx)
    nb = int(mt.pair_ok.sum())
    # Bytes: the matches in, the draw, the three models, their counts, the
    # flag and both inlier masks out. Ops, counted from `csrc/ransac.cu` as
    # the kernel runs them (each f32 add, multiply, divide, square root,
    # min / max, abs and comparison one; work that the kernel repeats in
    # several threads counted once): `horn3` 4342 a hypothesis (100 power
    # iterations of 41, 242 around them, fixed scale); `observe` 24 a valid
    # match, once; `sim3_inlier` 74 a valid match and model, for the 256
    # hypotheses, the winner's mask and the refined model's; `add_match` 792
    # a valid match and round, and 35 sums of 1024 columns a round, for 3
    # rounds (the 7x7 solve and the retraction, a few hundred a round, left
    # out).
    sim3_bytes = F * (12 + 12 + 1 + 4 + 4) + 256 * 12 + 3 * 52 + 3 * 4 + 1 + F * 2
    sim3_ops = (256 * 4342 + nb * 24 + (256 + 2) * nb * 74
                + 3 * (nb * 792 + 35 * (1024 - 1)))
    rows.append(dict(name="sim3", max_abs_err=max(info["sim3"]["combined_R"],
                                                  info["sim3"]["combined_t"]),
                     bound=bound_ms(sim3_bytes, sim3_ops),
                     fns=(lambda: sim3_solver.solve_and_refine_sim3(
                         cam, cam, *mt, idx=sidx, fix_scale=True),
                          lambda: sim3_solver.solve_and_refine_sim3_plain(
                              cam, cam, *mt, sidx, 20, True), None, 5),
                     graph=True))  # one attempt, a replayed graph
    # K10 PnP: keyframe q's observations of its points (`pnp_full_width`).
    X, uv, hit, sg2, pidx = pnp_full_width(m, gen)
    info["pnp"] = same_pnp(cam, X, uv, hit, sg2, pidx, "full width")
    nh = int(hit.sum())
    # Bytes: the matches and the draw in, the pose, mask, count and flag
    # out. Ops, counted from `csrc/ransac.cu` as the kernel runs them (each
    # add, multiply, divide, square root, min / max, abs and comparison one,
    # an fma two; work repeated on several lanes counted once): `dlt6_warp`
    # 8427 float64 ops a hypothesis (the normalization 103, the design rows
    # 60, the normal matrix's 144 entries of 12 fmas 3456, the trace and
    # regularization 26, the Cholesky 662, 8 inverse iterations of two
    # triangular solves, a norm and 12 divisions 2608, the denormalization,
    # det and scale ~90, 8 polar steps of three Cramer solves 1416), at the
    # card's float64 rate; in float32 the 6 sample rows' normalized pixels,
    # a valid match's gate once and its inlier test (37) for the 256
    # hypotheses and the winner's mask.
    pnp_bytes = F * (12 + 8 + 1 + 4) + 256 * 6 * 4 + 64 + F + 4 + 1
    pnp_f64 = 256 * 8427
    pnp_f32 = 256 * 24 + nh + (256 + 1) * nh * 37
    rows.append(dict(name="pnp", max_abs_err=max(info["pnp"]["R"], info["pnp"]["t"]),
                     bound=bound_ms(pnp_bytes, pnp_f32, pnp_f64),
                     fns=(lambda: pnp.solve_pnp_ransac(cam, X, uv, hit, sg2, idx=pidx),
                          lambda: pnp.solve_pnp_ransac_plain(cam, X, uv, hit, sg2, pidx), None,
                          5)))
    # K11 B17: the covisibility count of the final map, and the library's
    # bf16 product of the 0/1 incidence (built once, outside the timing).
    Wk, Wp = covis.covis_matrix(m), covis.covis_matrix_plain(m)
    require(torch.equal(Wk, Wp), "covis_matrix: kernel and plain differ at full size")
    B = covis.obs_matrix(m, torch.bfloat16)

    def library_covis():
        try:  # f32 accumulation and output (torch >= 2.8 on CUDA)
            return torch.mm(B, B.T, out_dtype=torch.float32)
        except (TypeError, NotImplementedError, RuntimeError):
            return torch.mm(B, B.T)

    n_obs = int(((m.kf.mp_idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]).sum())
    pairs = int(Wk.sum())
    n_live = int(m.kf.valid.sum())
    # Bytes any count must move: the N validity flags, the live rows'
    # observations (index and flag, 5 bytes each) and W written once; the
    # earlier count read all N rows' observations (N F 5 bytes).
    cm_bytes = N + n_live * F * 5 + N * N * 4
    cm_ops = 2 * n_obs + pairs
    info["covis_matrix"] = dict(equal=True, observations=n_obs, pairs=pairs, live=n_live,
                                bound_all_rows=bound_ms(N * F * 5 + N + N * N * 4, cm_ops),
                                library_equal=bool(torch.equal(library_covis().float().round()
                                                               .to(torch.int32), Wk)))
    rows.append(dict(name="covis_matrix", max_abs_err=0.0, bound=bound_ms(cm_bytes, cm_ops),
                     fns=(lambda: covis.covis_matrix(m), lambda: covis.covis_matrix_plain(m),
                          library_covis, 3)))
    # K11 B14: the essential graph of the final map with one synthetic loop
    # edge (`flagship_graph`); it has few free vertices, so the row is timed
    # on `ring_graph`, a populated graph of the same layout and size.
    g = flagship_graph(m)
    info["pose_graph_flagship_map"] = same_graph(g)
    rg = ring_graph(N, device="cuda")
    require(rg.e_i.shape == g.e_i.shape, f"ring graph: {rg.e_i.shape[0]} edges, the essential "
            f"graph {g.e_i.shape[0]}")
    info["pose_graph"] = same_graph(rg, t_rel=True)
    E = rg.e_i.shape[0]
    ev, nf = info["pose_graph"]["edges"], info["pose_graph"]["vertices"]
    # The work the result needs: every vertex read and written, every edge's
    # flag and weight read, the weighted edges' ends and measurements read;
    # per Gauss-Newton iteration the weighted edges' residual and 14
    # Jacobian columns (~2000 operations each), their 7x7 blocks and
    # gradients, the free vertices' block inverses, and per CG iteration
    # two Jacobian products per weighted edge and side and the free
    # vertices' preconditioner and vector updates.
    pg_bytes = N * (36 + 12 + 4 + 1) + E * (1 + 4) + ev * (4 + 4 + 36 + 12 + 4) + N * 52 + 20 * 4
    pg_ops = 20 * (ev * 14 * 2000 + ev * 2 * (7 * 7 * 7 + 7 * 7) * 2 + nf * 2 * 400
                   + 40 * (ev * 2 * 98 * 2 + nf * 49 * 2 + nf * 40)) + nf * 300
    rows.append(dict(name="pose_graph", max_abs_err=max(info["pose_graph"]["t"],
                                                        info["pose_graph"]["R"]),
                     bound=bound_ms(pg_bytes, pg_ops),
                     fns=(lambda: pose_graph.optimize(rg, 20, 40),
                          lambda: pose_graph.optimize_plain(rg, 20, 40), None, 2),
                     kernel_reps=10, events=True))  # one cooperative launch: CUDA events
    info["sizes"] = dict(N=N, F=F, M=M, W=W, E=E, valid_edges=ev, free_vertices=nf,
                         matches_sim3=nb, matches_pnp=nh, features=nv)
    return rows, info


# ---------------------------------------------------------------------------
# The tracker's other two sensors: mono (K5's area and band modes, K12,
# K13) and RGB-D
# ---------------------------------------------------------------------------

# The JAX yardstick of the two sensors on the flagship's camera, config and
# world (JAX on a CPU; the script is in PERF.md).
JAX_MONO = dict(init_frame=5, keyframes=5, points=1211, ate_m=0.323)
JAX_RGBD = dict(keyframes=2, points=2906, ate_m=0.00426)
MONO_KERNELS = ("match_area", "match_band", "two_view", "triangulate", "ba_dense")


def sensor_ate(traj, states, with_scale: bool) -> float:
    """Aligned ATE of the camera centres over the frames tracked OK."""
    ok = [i for i, s in enumerate(states) if s == "OK"]
    est = np.asarray([np.linalg.inv(np.asarray(traj[i][1], np.float64)) for i in ok])
    gtw = np.asarray([np.linalg.inv(gt_pose(i).numpy().astype(np.float64)) for i in ok])
    return trajectory.ate_rmse(est, gtw, align=True, with_scale=with_scale)


def run_sensor_phase(sensor: str) -> dict:
    """`entry.run_sensor` on a fresh card tracker, all counters reset just
    before; each call's wall time (synchronized). For mono it keeps the
    inputs of every bootstrap search and two-view attempt and a clone of the
    map at the first create_new_points call, and times each
    create_new_points call."""
    tracker, te = sensor_entry("cuda")
    n = MONO_FRAMES if sensor == "mono" else RGBD_FRAMES
    kept = dict(search=[], two_view=[], tri_ms=[])
    search_fn = matcher.search_for_initialization
    two_view_fn, create_fn = initializer.initialize_two_view, triangulation.create_new_points

    def search(*args, **kw):
        kept["search"].append((args, kw))
        return search_fn(*args, **kw)

    def two_view(cam, xy1, xy2, valid, **kw):
        kept["two_view"].append((xy1.clone(), xy2.clone(), valid.clone()))
        return two_view_fn(cam, xy1, xy2, valid, **kw)

    def create(cam, m, kf_row, cfg, *args):
        torch.cuda.synchronize()
        if "tri_map" not in kept:
            kept.update(tri_map=ms.clone(m), tri_kf=int(kf_row), cfg=cfg)
        t0 = time.perf_counter()
        out = create_fn(cam, m, kf_row, cfg, *args)
        torch.cuda.synchronize()
        kept["tri_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    times = {}

    def step(i, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[i] = (time.perf_counter() - t0) * 1e3

    matcher.search_for_initialization = search
    initializer.initialize_two_view, triangulation.create_new_points = two_view, create
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        run_sensor(tracker, te, sensor, n, step)
        launches = dict(kernels.LAUNCHES)
    finally:
        matcher.search_for_initialization = search_fn
        initializer.initialize_two_view, triangulation.create_new_points = two_view_fn, create_fn
    states = [s.name for s in tracker.frame_states]
    frame_ms = [times[i] for i in range(n)]
    out = dict(tracker=tracker, te=te, kept=kept, states=states, launches=launches,
               frame_ms=frame_ms, create_ms=kept["tri_ms"], keyframes=tracker.stats.n_keyframes,
               points=int(tracker.map.mp.valid.sum()), stages=dict(tracker.stats.stages),
               ate_m=sensor_ate(tracker.trajectory, states, sensor == "mono"))
    bad = map_finite(tracker.map)
    require(not bad, f"{sensor}: non-finite map fields {bad}")
    require(launches["finish_keypoints"] == n and "rgbd_stereo" not in launches,
            f"{sensor}: {launches['finish_keypoints']} finish_keypoints launches over {n} frames")
    if sensor == "mono":
        init = states.index("OK") if "OK" in states else -1
        out.update(init_frame=init, init_ms=frame_ms[init] if init >= 0 else None,
                   tracked_ms=frame_ms[init + 1:], attempts=len(kept["two_view"]))
        require(abs(init - JAX_MONO["init_frame"]) <= 1,
                f"mono: initialized at frame {init}, the JAX yardstick at {JAX_MONO['init_frame']}")
        require(all(s == "OK" for s in states[init:]), f"mono: frame states {states}")
        require(abs(out["keyframes"] - JAX_MONO["keyframes"]) <= 1,
                f"mono: {out['keyframes']} keyframes, JAX {JAX_MONO['keyframes']}")
        require(out["ate_m"] <= 2 * JAX_MONO["ate_m"],
                f"mono: similarity ATE {out['ate_m']:.4f} m > 2 x JAX's {JAX_MONO['ate_m']} m")
        require("tri_map" in kept, "mono: create_new_points never ran")
        require(launches["two_view"] == out["attempts"],
                f"mono: {launches['two_view']} K12 launches in {out['attempts']} attempts")
        for name in MONO_KERNELS + ("pyramid", "fast_cells", "orb_describe", "match_masked",
                                    "pose_opt", "local_map", "covisibility"):
            require(launches[name] > 0, f"kernel {name} was not launched by the mono phase")
    else:
        out["tracked_ms"] = frame_ms[1:]
        require(all(s == "OK" for s in states), f"rgbd: frame states {states}")
        require(out["keyframes"] == JAX_RGBD["keyframes"],
                f"rgbd: {out['keyframes']} keyframes, JAX {JAX_RGBD['keyframes']}")
        require(abs(out["points"] - JAX_RGBD["points"]) <= 0.01 * JAX_RGBD["points"],
                f"rgbd: {out['points']} points, JAX {JAX_RGBD['points']}")
        require(out["ate_m"] <= 2 * JAX_RGBD["ate_m"],
                f"rgbd: ATE {out['ate_m']:.5f} m > 2 x JAX's {JAX_RGBD['ate_m']} m")
        for name in ("pyramid", "fast_cells", "orb_describe", "match_masked", "pose_opt",
                     "local_map"):
            require(launches[name] > 0, f"kernel {name} was not launched by the RGB-D phase")
        require(launches["stereo_match"] == 0, "rgbd: the stereo matcher ran")
    tm = out["tracked_ms"]
    out.update(frame_ms_p50=float(np.percentile(tm, 50)), frame_ms_p90=float(np.percentile(tm, 90)))
    return out


def plane_scene(planar: bool, n: int = 2048, seed: int = 5):
    """Matched pixels of two views of a seeded scene at the flagship's camera
    (a plane 12 m away, or points 8-20 m deep), 0.5 px noise."""
    rng = np.random.default_rng(seed)
    depth = np.full(n, 12.0) if planar else rng.uniform(8, 20, n)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), depth], -1).astype(np.float32)
    T21 = se3.exp(torch.tensor([-0.4, 0.02, 0.01, 0.0, 0.05, 0.0])).numpy()

    def proj(T):
        p = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
                         CAM.fy * p[:, 1] / p[:, 2] + CAM.cy], -1).astype(np.float32)

    xy1 = proj(np.eye(4, dtype=np.float32)) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    xy2 = proj(T21) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    ok = ((xy1 > 0).all(-1) & (xy1 < [CAM.width, CAM.height]).all(-1) & (xy2 > 0).all(-1)
          & (xy2 < [CAM.width, CAM.height]).all(-1))
    return [torch.from_numpy(a).cuda() for a in (xy1, xy2, ok)]


def two_view_scratch(xy1, xy2, valid, sample) -> tuple:
    """One K12 attempt's hypothesis models [2, H, 18] and scores [2, H] and
    its out_i (ok, used_H, n_good, best candidate, the chosen model's
    inliers, the best F and H hypotheses), from its recorded buffers."""
    H = sample.shape[0]
    bufs = recorded_buffers(lambda: initializer.initialize_two_view(CAM, xy1, xy2, valid,
                                                                    sample=sample))
    pick = lambda shape: [b for b in bufs if tuple(b.shape) == shape][0]  # noqa: E731
    return pick((2, H, 18)), pick((2, H)), pick((7,))


def same_two_view(xy1, xy2, valid, sample, name: str, hold: str = "all") -> tuple:
    """K12 against its plain version: one launch, two runs bit-equal, each
    model's best hypothesis the first maximum of the kernel's own scores
    (torch.argmax, as the earlier kernel's scan); ok and the model exact;
    the good count and mask within 1 % (points within rounding of a gate),
    R within 1e-4, the unit t within 1e-3 (the refit's f32 null vector),
    good points within 1e-2 relative; the outputs' hash (to compare trees)
    and the plain version's own spread (R, t, points) under one ulp of its
    input (xy1 or xy2 nudged up by one ulp) and on the CPU. Where fewer
    than 8 points triangulate well (no bootstrap), the refit is the null
    vector of a rank-deficient system, set by rounding alone, and its pose
    is not compared. `hold` "edge" (the seeded scenes that test shapes)
    holds the unit t within 3e-3: the F refit's unit t moves by up to
    1.6e-3 in the plain version's own spreads measured (PERF.md), and the
    kernel lies 1.65e-3 from it on the N = 1000 edge. "first" (a draw
    whose every row holds one match: every hypothesis is such a null
    vector, so the scores, the best, the refit and what follows are set by
    rounding) holds the first-maximum rule and ok and the model as the
    plain version's, not the counts or the pose (the earlier kernel's
    outputs on such draws are compared by `kernel_times --parts k10k12`)."""
    call = lambda: initializer.initialize_two_view(CAM, xy1, xy2, valid,  # noqa: E731
                                                     sample=sample)
    require(launches_of(call, "two_view") == 1, f"two_view ({name}): more than one launch")
    _, scores, out_i = two_view_scratch(xy1, xy2, valid, sample)
    first = [int(torch.argmax(scores[m])) for m in range(2)]
    best = [int(out_i[5]), int(out_i[6])]
    require(best == first, f"two_view ({name}): best hypotheses {best}, first maxima {first}")
    tied = [int((scores[m] == scores[m, first[m]]).sum()) for m in range(2)]
    k, k2 = call(), call()
    plain = lambda a, b: initializer.initialize_two_view_plain(CAM, a, b, valid, sample)  # noqa: E731
    p = plain(xy1, xy2)
    up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))  # noqa: E731
    nudged = (plain(up(xy1), xy2), plain(xy1, up(xy2)))
    on_cpu = initializer.initialize_two_view_plain(CAM, xy1.cpu(), xy2.cpu(), valid.cpu(),
                                                   sample.cpu())
    on_cpu = type(p)(*(x.to(xy1.device) for x in on_cpu))
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(k, k2)), f"two_view ({name}): two runs differ")

    def points_rel(a, b):
        both = a.good & b.good
        if not bool(both.any()):
            return 0.0
        d = torch.linalg.norm(a.X - b.X, dim=1)[both] / torch.linalg.norm(b.X, dim=1)[both]
        return float(d.max())

    nb = int(p.n_good)
    e = dict(ok=bool(k.ok), used_H=bool(k.used_H), n_good_kernel=int(k.n_good), n_good_plain=nb,
             good_flips=int((k.good != p.good).sum()), R=nan_diff(k.R, p.R), t=nan_diff(k.t, p.t),
             X_rel=points_rel(k, p),
             plain_ulp=dict(R=max(nan_diff(q.R, p.R) for q in nudged),
                            t=max(nan_diff(q.t, p.t) for q in nudged),
                            X_rel=max(points_rel(q, p) for q in nudged)),
             plain_cpu=dict(R=nan_diff(on_cpu.R, p.R), t=nan_diff(on_cpu.t, p.t),
                            X_rel=points_rel(on_cpu, p)),
             score_h=(float(k.score_h), float(p.score_h)), score_f=(float(k.score_f),
                                                                   float(p.score_f)),
             N=int(xy1.shape[0]), valid=int(valid.sum()), hash=digest(*k), best=best,
             tied_at_best=tied)
    require(bool(k.ok) == bool(p.ok) and bool(k.used_H) == bool(p.used_H),
            f"two_view ({name}): ok / model differ: {e}")
    if hold == "first":
        return k, e
    require(abs(e["n_good_kernel"] - nb) <= nb // 100 and e["good_flips"] <= nb // 100,
            f"two_view ({name}): good counts differ: {e}")
    t_tol = 3e-3 if hold == "edge" else 1e-3
    require(nb < 8 or (e["R"] <= 1e-4 and e["t"] <= t_tol and e["X_rel"] <= 1e-2),
            f"two_view ({name}): pose or points differ: {e}")
    return k, e


def two_view_edges(dev) -> dict:
    """K12 at its edges (`kernel_times.two_view_edge_inputs`: N = 1, N at the
    kernel's capacity, N = 1000, no valid match, two degenerate rows, an
    all-degenerate draw whose scores tie), each by `same_two_view` (holds
    "edge", the all-degenerate draw "first"); one match past the capacity
    is refused."""
    out = {k: same_two_view(*v, name=k, hold="first" if k == "all_degenerate" else "edge")[1]
           for k, v in two_view_edge_inputs(sys.modules[__name__], dev).items()}
    xy1, xy2, valid = plane_scene(True, n=initializer.TV_MAX_N + 1)
    try:
        initializer.initialize_two_view(CAM, xy1, xy2, valid)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"two_view: {initializer.TV_MAX_N + 1} matches were not refused")
    return out


def two_view_cost(xy1, xy2, valid, sample, k) -> tuple:
    """(bytes, f32 ops) of one K12 attempt as the kernel runs it, on the
    data of result k (each add, multiply, divide, square root, min / max,
    abs and comparison one, an fma two; work repeated in several CTAs or
    lanes counted once): the normalization 17 a valid match; a hypothesis's
    solve (design rows, the normal matrix, the LU, 12 solves and the norms,
    F's SVD and both models' denormalization: 4620 F, 5630 H); a score term
    (65) for each valid match and hypothesis of each model; the refit: each
    model's score over the valid matches and the normal-matrix rows of its
    best hypothesis's inliers (103 F, 198 H), the solve again, the rescore;
    CheckRT's triangulation and cheirality (95) for each candidate of the
    chosen model and its inlier, its gates (57) for the best candidate's
    good points (other candidates' passing points left out), and the
    points of every match. Bytes: the matches, flags and draw in; the
    points, flags, pose, counts and scores out. The chosen model's inlier
    count is the kernel's (out_i[4])."""
    N, H, nv = xy1.shape[0], sample.shape[0], int(valid.sum())
    models, _, out_i = two_view_scratch(xy1, xy2, valid, sample)
    bF, bH = int(out_i[5]), int(out_i[6])
    nF = int(initializer._score_F(models[0, bF, :9].view(3, 3), xy1, xy2, valid, 1.0)[1].sum())
    nH = int(initializer._score_H(models[1, bH, :9].view(3, 3), models[1, bH, 9:].view(3, 3),
                                  xy1, xy2, valid, 1.0)[1].sum())
    n_inl = int(out_i[4])
    nc = 8 if bool(k.used_H) else 4
    ops = (nv * 17 + H * (4620 + 5630) + 2 * H * nv * 65
           + 2 * nv * 65 + nF * 103 + nH * 198 + 4620 + 5630 + 2 * nv * 65
           + nc * n_inl * 95 + int(k.n_good) * 57 + N * 95)
    n_bytes = N * (8 + 8 + 1) + H * 8 * 4 + N * (12 + 1) + 36 + 12 + 4 * 4 + 8
    return n_bytes, ops


def check_sensor_kernels(mp_: dict, rg: dict) -> tuple:
    """K12, K5's band mode, K13 (also at its edges, `tri_edges`) and K5's
    area mode against their plain versions on the sensor phases' inputs; rows
    for the kernels' line with each bound from these inputs."""
    info, rows = {}, []
    tracker, te = mp_["tracker"], mp_["te"]
    cfg = tracker.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    # K12, H branch: the mono bootstrap's own matches (its successful attempt).
    xy1, xy2, valid = mp_["kept"]["two_view"][-1]
    sample = initializer.sample_indices(valid, 256, 8, gen)
    k, info["two_view_H"] = same_two_view(xy1, xy2, valid, sample, "mono bootstrap")
    info["two_view_H"]["matches"] = int(valid.sum())
    require(info["two_view_H"]["used_H"] and info["two_view_H"]["ok"],
            f"two_view: the planar bootstrap did not take H: {info['two_view_H']}")
    # K12, F branch: a seeded non-planar scene (svd3x3 of E).
    fx1, fx2, fvalid = plane_scene(False)
    fsample = initializer.sample_indices(fvalid, 256, 8, gen)
    _, info["two_view_F"] = same_two_view(fx1, fx2, fvalid, fsample, "non-planar scene")
    require(not info["two_view_F"]["used_H"] and info["two_view_F"]["ok"],
            f"two_view: the non-planar scene did not take F: {info['two_view_F']}")
    # K12 on the bootstrap's matches with every row of the draw degenerate
    # (one match in all eight slots): scores tie, so the first maximum
    # decides (the kernel's 64-bit key against torch.argmax).
    _, info["two_view_tie"] = same_two_view(xy1, xy2, valid, degenerate_rows(sample, valid),
                                            "all-degenerate draw", hold="first")
    tv_bytes, tv_ops = two_view_cost(xy1, xy2, valid, sample, k)
    rows.append(dict(name="two_view", max_abs_err=max(info["two_view_H"]["R"],
                                                      info["two_view_H"]["t"]),
                     bound=bound_ms(tv_bytes, tv_ops),
                     fns=(lambda: initializer.initialize_two_view(CAM, xy1, xy2, valid,
                                                                  sample=sample),
                          lambda: initializer.initialize_two_view_plain(CAM, xy1, xy2, valid,
                                                                        sample), None, 3)))
    # K5's band mode and K13 on a clone of the map at the first
    # create_new_points call, at the path's shapes ([K, F] against K
    # neighbours of F features).
    m, q = mp_["kept"]["tri_map"], mp_["kept"]["tri_kf"]
    st = triangulation.setup(CAM, m, q, cfg)
    nbf = triangulation.neighbours(m, st)
    sk = triangulation.search(m, st, nbf, cfg)
    sp = triangulation.search(m, st, nbf, cfg, plain=True)
    torch.cuda.synchronize()
    for f in ("idx", "dist", "ok"):
        a, b = getattr(sk, f), getattr(sp, f)
        require(torch.equal(a, b.to(a.dtype)),
                f"match_band: {f} differs in {(a != b.to(a.dtype)).sum().item()} places")
    K, F = st.nb_rows.shape[0], m.kf.n_features
    info["match_band"] = dict(neighbours=K, used=int(st.nb_use.sum()), matches=int(sk.ok.sum()))
    b_bytes, b_ops = band_cost(st, nbf, m.kf.xy[q], tracker.scales)
    rows.append(dict(name="match_band", max_abs_err=0.0, bound=bound_ms(b_bytes, b_ops),
                     fns=(lambda: triangulation.search(m, st, nbf, cfg),
                          lambda: triangulation.search(m, st, nbf, cfg, plain=True), None, 10)))
    match = sp.idx
    ck = triangulation.points(CAM, m, st, nbf, match, cfg)
    cp = triangulation.points_plain(CAM, m, st, nbf, match, cfg)
    torch.cuda.synchronize()
    made = ck.create & cp.create
    info["triangulate"] = dict(
        created_kernel=int(ck.create.sum()), created_plain=int(cp.create.sum()),
        neighbours=int(st.nb_use.sum()),
        X_max_abs=float((ck.X - cp.X)[made].abs().max()) if bool(made.any()) else 0.0)
    require(torch.equal(ck.create, cp.create) and torch.equal(ck.k[made], cp.k[made])
            and torch.equal(ck.f2[made], cp.f2[made]),
            f"triangulate: candidates differ: {info['triangulate']}")
    require(info["triangulate"]["X_max_abs"] <= 1e-5, f"triangulate: {info['triangulate']}")
    mk = triangulation.create_new_points(CAM, ms.clone(m), q, cfg)
    cpl = triangulation.candidates_plain(CAM, m, st, cfg)
    mpl = triangulation.write_points(ms.clone(m), st, cpl, cfg)
    require(int(mk.n_mp) == int(mpl.n_mp) and torch.equal(mk.kf.mp_idx, mpl.kf.mp_idx),
            "triangulate: created rows or bindings differ")
    info["triangulate_edges"] = tri_edges(m, st, nbf, match, cfg)
    # Bound: ~150 flops of rays, midpoint and gates per (neighbour, feature)
    # with a match, one read of each match. Bytes: the keyframe's keypoints
    # and octaves, the matches, the matched neighbour features' keypoints and
    # octaves, the poses, the outputs.
    n_match = int((match >= 0).sum())
    tri_ops = n_match * 150 + K * F
    tri_bytes = F * 12 + K * F * 4 + n_match * 12 + (K + 1) * 15 * 4 + F * (1 + 4 + 4 + 12 + 4)
    rows.append(dict(name="triangulate", max_abs_err=info["triangulate"]["X_max_abs"],
                     bound=bound_ms(tri_bytes, tri_ops),
                     fns=(lambda: triangulation.points(CAM, m, st, nbf, match, cfg),
                          lambda: triangulation.points_plain(CAM, m, st, nbf, match, cfg),
                          None, 10)))
    # K5's area mode at 2048 x 2048: the search of the successful bootstrap
    # (its reference frame's features against the frame it initialized with).
    (xy1_, desc1, ang1, val1, xy2_, desc2, ang2, val2), kw = mp_["kept"]["search"][-1]
    q_area = dict(desc_q=desc1, desc_t=desc2, valid_q=val1, valid_t=val2,
                  max_dist=kw["max_dist"], ratio=kw["ratio"], mutual=True,
                  window=matcher.AreaWindow(xy2_, xy1_, kw["window"]), angle_q=ang1,
                  angle_t=ang2)
    info["match_area_ok"] = int(same_match(q_area, "area").ok.sum())
    a_bytes, a_ops, _ = match_cost(q_area)
    rows.append(dict(name="match_area", max_abs_err=0.0, bound=bound_ms(a_bytes, a_ops),
                     fns=(lambda: matcher.match_select(**q_area),
                          lambda: matcher.match_select_plain(**q_area), None, 10)))
    return rows, info


def same_candidates(m, st, nbf, match, cfg, name: str) -> dict:
    """K13 against its plain version on one input: create, k and f2 exact
    (k and f2 where a point is made), X within 1e-5 m."""
    ck = triangulation.points(CAM, m, st, nbf, match, cfg)
    cp = triangulation.points_plain(CAM, m, st, nbf, match, cfg)
    torch.cuda.synchronize()
    made = ck.create & cp.create
    out = dict(K=int(match.shape[0]), F=int(match.shape[1]), created=int(ck.create.sum()),
               X_max_abs=float((ck.X - cp.X)[made].abs().max()) if bool(made.any()) else 0.0,
               k_hist=torch.bincount(ck.k[ck.create].long(), minlength=match.shape[0]).tolist())
    require(torch.equal(ck.create, cp.create) and torch.equal(ck.k[made], cp.k[made])
            and torch.equal(ck.f2[made], cp.f2[made]) and out["X_max_abs"] <= 1e-5,
            f"triangulate ({name}): candidates differ: {out}")
    return out


def reslot(st, nbf, match, slots, drop=()):
    """The set-up, neighbour features and matches with neighbour slot i
    taken from slot slots[i]; the matches of the new slots in `drop` cleared."""
    i = torch.tensor(slots, device=match.device)
    st2 = st._replace(nb_rows=st.nb_rows[i].contiguous(), nb_use=st.nb_use[i], R2=st.R2[i],
                      t2=st.t2[i], o2=st.o2[i].contiguous(), F12=st.F12[i],
                      epipole=st.epipole[i])
    mt = match[i].clone()
    mt[list(drop)] = -1
    return st2, triangulation.Neighbours(*(t[i].contiguous() for t in nbf)), mt


def tri_edges(m, st, nbf, match, cfg) -> dict:
    """K13 at its edges, on the first create_new_points call's inputs: a tie
    (slot 1 a copy of the slot that the plain version picks most often, s,
    so that the lower slot must win), K = 1 (slot s alone), K = 11 (three
    more slots, copies of s and the two after it, whose own matches are
    cleared, so that lanes take a second slot and win with it) and F = 2047
    (the last feature and every match to it dropped)."""
    K = match.shape[0]
    cp = triangulation.points_plain(CAM, m, st, nbf, match, cfg)
    s = int(torch.bincount(cp.k[cp.create].long(), minlength=K).argmax())
    nxt = [(s + d) % K for d in range(3)]
    out = dict(tie=same_candidates(m, *reslot(st, nbf, match, [s, s] + [k for k in range(K)
                                                                         if k != s][:K - 2]),
                                   cfg, "tie"),
               k1=same_candidates(m, *reslot(st, nbf, match, [s]), cfg, "K = 1"),
               k11=same_candidates(m, *reslot(st, nbf, match, list(range(K)) + nxt, drop=nxt),
                                   cfg, "K = 11"))
    require(out["tie"]["k_hist"][1] == 0 < out["tie"]["k_hist"][0],
            f"triangulate: the tie went to the second slot: {out['tie']}")
    require(sum(out["k11"]["k_hist"][K:]) > 0, f"triangulate: no slot past 8 won: {out['k11']}")
    F1 = m.kf.n_features - 1
    kf = m.kf._replace(**{f: t[:, :F1].contiguous() for f, t in m.kf._asdict().items()
                          if t.dim() >= 2 and t.shape[1] == F1 + 1})
    mt = torch.where(match[:, :F1] < F1, match[:, :F1], torch.full_like(match[:, :F1], -1))
    out["f2047"] = same_candidates(
        m._replace(kf=kf), st._replace(unbound1=st.unbound1[:F1]),
        triangulation.Neighbours(*(t[:, :F1].contiguous() for t in nbf)), mt.contiguous(), cfg,
        "F = 2047")
    return out


# tests/test_torch_frame.py's distortion, and one with all five terms.
DIST_CAM = CAM._replace(dist=(0.01, -0.002, 0.0005, -0.0003, 0.0))
EDGE_CAM = CAM._replace(dist=(0.02, -0.004, 0.0007, -0.0004, 0.0009))


def same_finish(cam, xy, valid=None, dmap=None, mode: str = "stereo", name: str = "") -> dict:
    """K4's finish_keypoints against its plain version on one input, every
    output bit for bit."""
    k = stereo.finish_keypoints(cam, xy, valid, dmap, mode)
    p = stereo.finish_keypoints_plain(cam, xy, valid, dmap, mode)
    torch.cuda.synchronize()
    for field, a, b in zip(k._fields, k, p):
        require((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                f"finish_keypoints ({name}, {mode}): {field} differs from plain"
                + ("" if a is None or b is None or a.shape != b.shape
                   else f" in {int((a != b).sum())} places"))
    return dict(N=int(xy.shape[0]), ok=None if k.ok is None else int(k.ok.sum()),
                max_shift_px=float((k.xy_und - xy).abs().max()) if xy.shape[0] else 0.0)


def finish_edges(dev, dmap) -> dict:
    """finish_keypoints at its edges, with all five distortion terms: N = 1
    in each mode, every feature invalid, every depth at or under min_depth,
    and keypoints at x.5 on and beyond the image border (rounded half to
    even, then clamped)."""
    h, w = dmap.shape
    rng = np.random.default_rng(11)
    one = torch.tensor([[600.3, 200.7]], device=dev)
    t = torch.ones(1, dtype=torch.bool, device=dev)
    out = {f"n1_{mode}": same_finish(EDGE_CAM, one, t, dmap, mode, "N = 1")
           for mode in ("stereo", "mono", "rgbd")}
    xy = torch.from_numpy(rng.uniform(0, [w, h], (2048, 2)).astype(np.float32)).to(dev)
    out["invalid"] = same_finish(EDGE_CAM, xy, torch.zeros(2048, dtype=torch.bool, device=dev),
                                 dmap, "rgbd", "all invalid")
    shallow = torch.where(torch.arange(h * w, device=dev).view(h, w) % 2 == 0,
                          torch.full_like(dmap, 0.05), torch.zeros_like(dmap))
    v = torch.ones(2048, dtype=torch.bool, device=dev)
    out["shallow"] = same_finish(EDGE_CAM, xy, v, shallow, "rgbd", "depth <= min_depth")
    xs = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, w - 2.5, w - 1.5, w - 0.5, w + 0.5], np.float32)
    ys = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, h - 2.5, h - 1.5, h - 0.5, h + 0.5], np.float32)
    border = torch.from_numpy(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)).to(dev)
    out["border_half"] = same_finish(EDGE_CAM, border, torch.ones(border.shape[0], dtype=torch.bool,
                                                                   device=dev),
                                     dmap, "rgbd", "x.5 on the border")
    require(out["invalid"]["ok"] == 0 and out["shallow"]["ok"] == 0,
            f"finish_keypoints: ok where no depth passes: {out}")
    return out


def check_finish_keypoints(te, entry_imgs) -> tuple:
    """K4's finish_keypoints against its plain version, bit for bit, with the
    entry camera and with DIST_CAM: the flagship's stereo frame (the entry
    pair's left features), the last RGB-D frame (its depth map) and a mono
    frame (the first sensor frame), and at its edges (`finish_edges`); the
    row times it on the last RGB-D frame."""
    dev = torch.device("cuda")
    imgs = orb.as_images(list(entry_imgs), dev)
    fl = orb.extract_batch(imgs, orb.params(CFG, imgs.shape[1], imgs.shape[2], "cuda")).select(0)
    T = gt_pose(RGBD_FRAMES - 1)
    dmap = te.world.depth(T).contiguous()
    fr = orb.extract(te.world.render(T), CFG, "cuda")
    fm = orb.extract(te.world.render(gt_pose(0)), CFG, "cuda")
    info = {}
    for cname, cam in (("cam", CAM), ("dist", DIST_CAM)):
        info[f"stereo_{cname}"] = same_finish(cam, fl.xy, fl.valid, None, "stereo", "stereo frame")
        info[f"rgbd_{cname}"] = same_finish(cam, fr.xy, fr.valid, dmap, "rgbd", "RGB-D frame")
        info[f"mono_{cname}"] = same_finish(cam, fm.xy, fm.valid, None, "mono", "mono frame")
    info["edges"] = finish_edges(dev, dmap)
    N = fr.xy.shape[0]
    # Bound: bytes, each keypoint (8), valid flag (1) and depth read (4) in,
    # xy_und (8), u_right, depth (4 each) and ok (1) out; operations, the two
    # reciprocals, 5 iterations of 34 and the prologue, epilogue and depth
    # step: 186 a keypoint.
    args = (CAM, fr.xy, fr.valid, dmap, "rgbd")
    row = dict(name="finish_keypoints", max_abs_err=0.0, bound=bound_ms(N * 30, N * 186),
               fns=(lambda: stereo.finish_keypoints(*args),
                    lambda: stereo.finish_keypoints_plain(*args), None, 20))
    return [row], info


# ---------------------------------------------------------------------------
# The end-to-end loop orbits through CorbslamClient: vocabulary training
# (K14), loop closing and global BA (K8 at C 256 / Fb 512)
# ---------------------------------------------------------------------------

E2E_KERNELS = ("kmajority", "ba_dense_gba", "vocab", "sim3", "pose_graph", "covis_matrix")
# The mono orbit's outcome is a property of the run's random draws and of
# floating-point rounding, in the reference as here (PERF.md §6): the
# reference's own fixture meets its gates with its client seed 1 only, 1 of
# 7 seeds on a CPU, and fails them when its bootstrap points move by one f32
# rounding; the port on a CPU fed the reference's images, vocabulary and
# two-view sample departs from it as that rounding does (the same first
# inlier difference, at frame 14, and the same first keyframe split, at
# frame 27: tests/yardstick_e2e.py mono 1 --port --control). Its run
# enforces these gates and reports the rest of the reference's.
E2E_MONO_ENFORCED = ("free_scale", "bootstrapped", "finite_orthonormal", "launched_kmajority",
                     "launched_vocab")
E2E_GATES = dict(stereo=dict(kf_ate_m=0.12, vs_frames=1.4), laps=dict(kf_ate_m=0.25),
                 mono=dict(kf_ate_m=0.9, s=(0.7, 1.4)))


def orthonormal_error(m) -> float:
    """The largest |R R^T - I| over the live keyframes (inf if any pose is
    not finite)."""
    T = m.kf.Tcw[m.kf.valid]
    if not bool(torch.isfinite(T).all()):
        return float("inf")
    R = T[:, :3, :3].double()
    return float((R @ R.transpose(1, 2) - torch.eye(3, dtype=R.dtype, device=R.device))
                 .abs().max())


def e2e_ates(tr, ee, with_scale: bool) -> tuple:
    """(frame ATE, keyframe ATE): the aligned ATE of every frame's camera
    centre and of the live keyframes' against their frames' truth
    (similarity-aligned for mono)."""
    def gt(i):
        return np.linalg.inv(orbit_pose(int(i), ee.step, E2E_RADIUS).numpy().astype(np.float64))

    est = np.asarray([np.linalg.inv(np.asarray(T, np.float64)) for _, T in tr.trajectory])
    ate_f = trajectory.ate_rmse(est, np.asarray([gt(i) for i in range(len(est))]), align=True,
                                with_scale=with_scale)
    m = tr.map
    rows = torch.nonzero(m.kf.valid)[:, 0]
    fid = m.kf.frame_id[rows].cpu().numpy()
    sel = fid < ee.n_frames
    T = m.kf.Tcw[rows].double().cpu().numpy()[sel]
    ate_k = trajectory.ate_rmse(np.linalg.inv(T), np.asarray([gt(i) for i in fid[sel]]),
                                align=True, with_scale=with_scale)
    return ate_f, ate_k


def run_e2e_phase(sensor: str, laps: bool = False, client_id: int = 1) -> dict:
    """One end-to-end orbit of `entry.e2e_entry` (the vocabulary trained on
    the card, then every frame through CorbslamClient and its shutdown), all
    counters reset just before the training, held to the gates of the
    reference's tests/test_loop_e2e.py. Keeps a copy of the first GBA
    chunk's problem; times each frame (the tracker's stream synchronized,
    not the GBA stream), each closure and GBA launch, each GBA chunk (CUDA
    events on the GBA stream)."""
    name = "laps" if laps else sensor
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    client, ee = e2e_entry(sensor, "cuda", laps=laps, client_id=client_id)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = kernels.LAUNCHES["kmajority"]
    lc_, g = client.loop_closer, client.loop_closer.gba_runner
    kept, chunk_ev, close_ms, launch_ms, loops = {}, [], [], [], []
    close, launch, chunk = lc_.close_loop, g.launch, g._chunk

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_chunk(prob, k):
        if "prob" not in kept:
            kept["prob"] = prob._replace(Tcw=prob.Tcw.clone(), X=prob.X.clone())
        a, b = events()
        a.record()
        res = chunk(prob, k)
        b.record()
        chunk_ev.append((a, b))
        return res

    def timed_launch(m):
        t1 = time.perf_counter()
        launch(m)
        torch.cuda.current_stream().synchronize()
        launch_ms.append((time.perf_counter() - t1) * 1e3)

    def timed_close(m, kf_q, kf_c, sb):
        t1 = time.perf_counter()
        out = close(m, kf_q, kf_c, sb)
        torch.cuda.current_stream().synchronize()
        close_ms.append((time.perf_counter() - t1) * 1e3)
        loops.append((kf_q, kf_c, float(sb.s)))
        return out

    g._chunk, g.launch, lc_.close_loop = timed_chunk, timed_launch, timed_close
    frame_ms = []

    def step(i, fn):
        t1 = time.perf_counter()
        fn()
        torch.cuda.current_stream().synchronize()
        if i is not None:
            frame_ms.append((time.perf_counter() - t1) * 1e3)

    t0 = time.perf_counter()
    run_e2e(client, ee, step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    del g._chunk, g.launch, lc_.close_loop
    tr, st = client.tracker, lc_.stats
    states = [x.name for x in tr.frame_states]
    ate_f, ate_k = e2e_ates(tr, ee, sensor == "mono")
    m = tr.map
    ortho = orthonormal_error(m)
    s_acc = lc_.loops.s[lc_.loops.valid].tolist()
    out = dict(client=client, ee=ee, kept=kept, run=name, frames=ee.n_frames,
               corpus=ee.corpus.shape[0], train_s=train_s, train_launches=train_launches,
               states_ok=states.count("OK"), not_ok=[(i, x) for i, x in enumerate(states)
                                                     if x != "OK"],
               keyframes=tr.stats.n_keyframes, points=int(m.mp.valid.sum()),
               loops=loops, n_loops=st.n_loops_closed, last_loop=st.last_loop,
               detections=st.n_detections, attempts=st.n_sim3_attempts, loop_s=s_acc,
               gba_started=g.runs_started, gba_finished=g.runs_finished,
               gba_aborted=g.runs_aborted, gba_result_left=g._result is not None,
               gba_chunk_ms=[a.elapsed_time(b) for a, b in chunk_ev], gba_launch_ms=launch_ms,
               close_ms=close_ms, frame_ate_m=ate_f, keyframe_ate_m=ate_k, ortho_err=ortho,
               frame_ms_p50=float(np.percentile(frame_ms, 50)),
               frame_ms_p90=float(np.percentile(frame_ms, 90)),
               frame_ms_max=float(max(frame_ms)), wall_s=wall_s,
               stages=dict(tr.stats.stages), launches=launches)
    print(f"e2e {name} (before the checks): "
          + json.dumps({k: v for k, v in out.items() if k not in ('client', 'ee', 'kept')},
                       default=str), flush=True)
    out["gates"] = e2e_gates(out)
    enforced = E2E_MONO_ENFORCED if name == "mono" else tuple(out["gates"])
    if name == "mono":
        print(f"e2e mono: the reference's gates (enforced: {', '.join(enforced)}): "
              f"{json.dumps(out['gates'])}", flush=True)
    for gname in enforced:
        require(out["gates"][gname], f"e2e {name}: gate {gname} failed ({out['gates']})")
    return out


def e2e_gates(ep: dict) -> dict:
    """The gates of the reference's tests/test_loop_e2e.py for one run, by
    name: True where the run meets it."""
    name, lc_ = ep["run"], ep["client"].loop_closer
    gate, last = E2E_GATES[name], ep["last_loop"]
    g = dict(finite_orthonormal=ep["ortho_err"] < 1e-3,
             distant_loop=ep["n_loops"] >= 1 and last is not None and abs(last[0] - last[1]) > 20,
             keyframe_ate=ep["keyframe_ate_m"] < gate["kf_ate_m"])
    if name == "stereo":
        g["frames_ok"] = ep["not_ok"] == [] or all(i < 2 for i, _ in ep["not_ok"])
        g["keyframe_ate_vs_frames"] = ep["keyframe_ate_m"] < gate["vs_frames"] * ep["frame_ate_m"]
    elif name == "laps":
        g["two_loops"] = ep["n_loops"] >= 2
        g["gba_runs"] = (ep["gba_started"] >= 2
                         and ep["gba_finished"] + ep["gba_aborted"] >= 1)
        g["nothing_unmerged"] = not ep["gba_result_left"]
    else:
        lo, hi = gate["s"]
        g["free_scale"] = lc_.fix_scale is False
        g["bootstrapped"] = ep["states_ok"] > 0
        g["scale"] = len(ep["loop_s"]) > 0 and all(np.isfinite(x) and lo < x < hi
                                                   for x in ep["loop_s"])
    for k in E2E_KERNELS:
        g[f"launched_{k}"] = ep["launches"][k] > 0
    return g


def kmajority_library(bits_pm: torch.Tensor, bits01: torch.Tensor, init01: torch.Tensor,
                      n_iters: int) -> torch.Tensor:
    """The library's k-majority (the TPU's own form): the assignment as one
    f16 product of +-1 bit matrices and its argmax (256 - 2 x Hamming; f16
    holds every value exactly), the vote as index_add_, the majority by
    comparison. Timed beside K14, used nowhere in the port."""
    words = init01.clone()
    W = words.shape[0]
    for _ in range(n_iters):
        a = torch.argmax(bits_pm @ (2 * words - 1).T, dim=1)
        ones = torch.zeros(W, 256, dtype=torch.int32, device=words.device).index_add_(
            0, a, bits01)
        counts = torch.zeros(W, dtype=torch.int32, device=words.device).index_add_(
            0, a, torch.ones_like(a, dtype=torch.int32))
        words = torch.where((counts > 0)[:, None], (2 * ones > counts[:, None]).to(words.dtype),
                            words)
    return words


def km_bound(N: int, W: int, cand: int, n_iters: int):
    """K14's bound: the descriptors and initial centres read once, centres,
    counts and idf written once; per iteration each descriptor's inner
    products with `cand` centres as the int8 product (256 multiply-adds,
    512 operations, each) on the tensor cores and, on the CUDA cores, the
    argmin (one comparison a centre), its vote (256) and the majority of
    W x 256 tallies."""
    return bound_ms(N * 32 + W * 32 + W * 32 + W * 4 + W * 4,
                    n_iters * (N * cand + N * 256 + W * 256 * 2),
                    n_int8_ops=n_iters * N * cand * 512)


def km_bound_cuda_cores(N: int, W: int, cand: int, n_iters: int):
    """K14's bound with every distance on the CUDA cores (XOR, popcount and
    sum over 8 words: 24 operations a centre), the count of the kernel
    before its tensor-core product, kept beside `km_bound` to compare with
    the rows measured then."""
    return bound_ms(N * 32 + W * 32 + W * 32 + W * 4 + W * 4,
                    n_iters * (N * cand * 24 + N * 256 + W * 256 * 2))


def launches_of(fn, counter: str = "kmajority") -> int:
    """The launches one call of fn counts under `counter`, every counter
    reset just before it (the phases keep copies of theirs)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    fn()
    torch.cuda.synchronize()
    return kernels.LAUNCHES[counter]


def same_km(desc, init, n_iters, name, group=None, block=0, weight=None) -> dict:
    wk, ck = vocab.kmajority(desc, init, n_iters, weight=weight, group=group, block=block)
    wp, cp = vocab.kmajority_plain(desc, init, n_iters, weight=weight, group=group, block=block)
    ik, ip = vocab.idf_of(ck), vocab.idf_plain(cp)
    torch.cuda.synchronize()
    out = dict(N=desc.shape[0], W=init.shape[0], words_equal=bool(torch.equal(wk, wp)),
               counts_equal=bool(torch.equal(ck, cp)), idf=float((ik - ip).abs().max()),
               idf_exact=bool(torch.equal(ik, ip)), empty=int((ck == 0).sum()),
               max_count=int(ck.max()))
    require(out["words_equal"] and out["counts_equal"] and out["idf"] <= 1e-6,
            f"kmajority ({name}): kernel and plain differ {out}")
    return out


def km_edge_inputs(dev) -> dict:
    """K14 at its edges, {name: (desc, init, n_iters, weight, group, block)},
    made with numpy from seed 13: one row; N and W off every tile width
    (16 rows, 8 centres, 1024 staged centres: two staging passes); a row
    equidistant from two centres in different staging passes and a row
    equidistant from two centres in one tile of 8 (the first must win), a
    centre repeated in the second pass (never chosen); every row identical
    (one centre takes all N, walked in many items); most centres empty;
    row weights 0-2; level 2 with blocks of 4 and a block without members,
    and with row weights 0-2; a corpus with more tiles of 16 rows than the
    grid has warps (a warp a tile) against more centres than one staging
    pass and the one-phase scan take (5003: five passes, the last partial,
    each row's key kept between them; the two-phase scan)."""
    rng = np.random.default_rng(13)

    def rows(n):
        return torch.from_numpy(rng.integers(0, 256, (n, 32), dtype=np.uint8)).to(dev)

    def packed(bits):
        return torch.from_numpy(np.packbits(bits, axis=-1, bitorder="little")).to(dev)

    out = dict(one_row=(rows(1), rows(7), 3, None, None, 0),
               ragged=(rows(1013), rows(77), 4, None, None, 0),
               two_passes=(rows(3001), rows(1100), 3, None, None, 0))
    init = rng.integers(0, 2, (1100, 256), dtype=np.uint8)
    init[1030] = init[5]                     # a repeat in the second pass: 5 wins
    init[1027] = init[3]
    init[1027, :2] = 1 - init[3, :2]         # 3 and 1027 two bits apart
    init[12] = init[9]
    init[12, 100:102] = 1 - init[9, 100:102]  # 9 and 12 two bits apart, one tile of 8
    desc = rng.integers(0, 2, (600, 256), dtype=np.uint8)
    desc[0] = init[3]
    desc[0, 0] = 1 - desc[0, 0]              # one bit from 3, one from 1027
    desc[1] = init[9]
    desc[1, 100] = 1 - desc[1, 100]          # one bit from 9, one from 12
    desc[2] = init[5]
    out["ties"] = (packed(desc), packed(init), 1, None, None, 0)
    out["identical"] = (rows(1).repeat(100000, 1).contiguous(), rows(64), 3, None, None, 0)
    out["mostly_empty"] = (rows(40), rows(1024), 3, None, None, 0)
    w = torch.from_numpy(rng.integers(0, 3, 5000).astype(np.int32)).to(dev)
    out["zero_weights"] = (rows(5000), rows(256), 4, w, None, 0)
    grp = torch.from_numpy(rng.integers(0, 7, 700).astype(np.int32)).to(dev)
    out["level2_empty_block"] = (rows(700), rows(32), 4, None, grp, 4)
    w = torch.from_numpy(rng.integers(0, 3, 700).astype(np.int32)).to(dev)
    out["level2_weights"] = (rows(700), rows(32), 4, w, grp, 4)
    out["wide"] = (rows(40000), rows(5003), 2, None, None, 0)
    return out


def km_edges(dev) -> dict:
    """K14 exact against its plain version at each of `km_edge_inputs`, and
    the flat assignment (`assign_flat`, the final-assignment launch) on the
    flat ones; the tie rows must take the first of their two centres."""
    info = {}
    for name, (desc, init, it, w, grp, B) in km_edge_inputs(dev).items():
        info[name] = same_km(desc, init, it, name, group=grp, block=B, weight=w)
        if grp is None:
            ak, ap = vocab.assign_flat(desc, init), vocab.assign_flat_plain(desc, init)
            require(torch.equal(ak, ap), f"assign_flat ({name}): kernel and plain differ")
            if name == "ties":
                require(ak[:3].tolist() == [3, 9, 5], f"ties: {ak[:3].tolist()}")
    return info


def covis_edge_maps(dev) -> dict:
    """B17 at its edges, maps of 48 keyframe rows x 64 features x 256
    points made with numpy from seed 17: no live keyframe; one; a keyframe
    observing one point twice; a point with 40 observers (beyond the 16
    kept inline); stale point ids on dead rows and invalid features; and 8
    rows of `COVIS_MAX_FEATURES` features over 40 000 points."""
    rng = np.random.default_rng(17)
    N, F, M = 48, 64, 256
    base = ms.empty(CapacityConfig(max_keyframes=N, max_map_points=M, max_features=F,
                                   local_window_kfs=8, local_window_mps=64), dev)

    def make(mp_idx, fvalid, valid):
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
        return base._replace(kf=base.kf._replace(mp_idx=t(mp_idx, np.int32),
                                                 fvalid=t(fvalid, np.bool_),
                                                 valid=t(valid, np.bool_)))

    idx = rng.integers(-1, M, (N, F))
    fv = rng.random((N, F)) < 0.9
    live = rng.random(N) < 0.5
    out = dict(no_live=make(idx, fv, np.zeros(N, bool)),
               one_live=make(idx, fv, np.arange(N) == 7))
    twice = idx.copy()
    twice[3, 10:20] = 42                     # row 3 observes point 42 ten times
    out["observed_twice"] = make(twice, np.ones((N, F), bool), live | (np.arange(N) == 3))
    many = idx.copy()
    many[:40, 5] = 99                        # point 99 in 40 rows
    out["forty_observers"] = make(many, np.ones((N, F), bool), np.arange(N) < 44)
    stale = idx.copy()
    stale[~live] = 7                         # dead rows all point at 7
    stale[:, 0] = np.where(fv[:, 0], stale[:, 0], 200)
    out["stale_rows"] = make(stale, fv, live)
    # Rows of the most features the count takes (its largest hash set).
    Fw, Mw = covis.COVIS_MAX_FEATURES, 40000
    wide = ms.empty(CapacityConfig(max_keyframes=8, max_map_points=Mw, max_features=Fw,
                                   local_window_kfs=8, local_window_mps=64), dev)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
    out["widest_rows"] = wide._replace(kf=wide.kf._replace(
        mp_idx=t(rng.integers(-1, Mw, (8, Fw)), np.int32),
        fvalid=t(rng.random((8, Fw)) < 0.9, np.bool_), valid=t(np.arange(8) != 2, np.bool_)))
    return out


def same_covis(m, name: str) -> dict:
    """B17 exact against its plain version on map m."""
    Wk, Wp = covis.covis_matrix(m), covis.covis_matrix_plain(m)
    require(torch.equal(Wk, Wp), f"covis_matrix ({name}): kernel and plain differ")
    return dict(live=int(m.kf.valid.sum()), pairs=int(Wk.sum()), max=int(Wk.max()))


def check_e2e_kernels(ep: dict) -> tuple:
    """K14 on the stereo run's training corpus with the run's own initial
    rows (its centres must be the run's vocabulary), and K8 on the run's
    first GBA chunk's problem (C 256, Fb 512): one LM iteration and the
    2-iteration chunk against optimize_plain, its point-major table."""
    client, ee, kept = ep["client"], ep["ee"], ep["kept"]
    corpus, cam, cfg = ee.corpus, ee.cam, ee.cfg
    N, W, it = corpus.shape[0], E2E_WORDS, E2E_TRAIN_ITERS
    init = corpus[vocab._draw(N, W, 0, corpus.device, None)].contiguous()
    info = dict(train=same_km(corpus, init, it, "e2e training"))
    w = torch.randint(0, 3, (N,), generator=torch.Generator(device=corpus.device).manual_seed(5),
                      device=corpus.device, dtype=torch.int32)
    info["weighted"] = same_km(corpus, init, it, "row weights 0-2", weight=w)
    require(torch.equal(vocab.kmajority(corpus, init, it)[0], client.voc.words),
            "kmajority: the e2e vocabulary is not this training")
    bits01 = descriptors.unpack_bits(corpus).to(torch.int32)
    bits_pm = (2 * bits01 - 1).to(torch.float16)
    init01 = descriptors.unpack_bits(init).to(torch.float16)
    lib = kmajority_library(bits_pm, bits01, init01, it)
    info["train"]["library_equal"] = bool(torch.equal(
        descriptors.pack_bits(lib.to(torch.uint8)), vocab.kmajority(corpus, init, it)[0]))
    info["train"]["bound_cuda_cores"] = km_bound_cuda_cores(N, W, W, it)
    rows = [dict(name="kmajority", max_abs_err=info["train"]["idf"], bound=km_bound(N, W, W, it),
                 fns=(lambda: vocab.idf_of(vocab.kmajority(corpus, init, it)[1]),
                      lambda: vocab.idf_plain(vocab.kmajority_plain(corpus, init, it)[1]),
                      lambda: kmajority_library(bits_pm, bits01, init01, it), 5))]
    pb = kept["prob"]
    C, Fb = pb.obs_mp.shape
    P, K = pb.pm_src.shape
    info["gba_problem"] = dict(C=C, Fb=Fb, P=P, K=K, active=int(pb.obs_active.sum()),
                               free_cameras=int((~pb.pose_fixed).sum()),
                               free_points=int((~pb.point_fixed).sum()))
    info["gba_table"] = same_point_major(pb.obs_mp, pb.obs_active, P, K, "GBA")
    cg = cfg.loop.gba_cg_iters
    _, info["gba_one_iteration"] = same_ba(cam, pb, 1, 1, "GBA one LM iteration", one_step=True,
                                           cg_iters=cg)
    _, info["gba_chunk"] = same_ba(cam, pb, 2, 2, "GBA chunk", cg_iters=cg)
    rows.append(dict(name="ba_dense_gba", max_abs_err=info["gba_chunk"]["t_max_abs"],
                     bound=k8_bound(pb, info["gba_chunk"]["trace_kernel"]),
                     fns=(lambda: ba_dense.optimize(cam, pb, 2, cg, 2, counter="ba_dense_gba"),
                          lambda: ba_dense.optimize_plain(cam, pb, 2, cg, 2), None, 1),
                     kernel_reps=5, events=True))
    return rows, info


# bench.py's bench_gba map (bench.py:32-94): 1536 keyframes along a 60 m arc,
# 196608 points, 512 observations a keyframe, capacities 2048 / 262144.
BENCH_GBA_KF, BENCH_GBA_MP, BENCH_GBA_OBS = 1536, 196608, 512


def bench_gba_map(cam, cfg, dev) -> ms.MapState:
    """bench_gba's synthetic map, made from seed 0 with numpy in its order
    (poses advancing along z, a band of points, each keyframe observing a
    sliding window of 512 of them with 0.5 px noise), in the port's MapState
    on `dev`."""
    cap = CapacityConfig(max_keyframes=2048, max_map_points=262144,
                         max_features=cfg.capacity.max_features,
                         local_window_kfs=cfg.capacity.local_window_kfs,
                         local_window_mps=cfg.capacity.local_window_mps)
    rng = np.random.default_rng(0)
    N_used, P_used, obs_per_kf = BENCH_GBA_KF, BENCH_GBA_MP, BENCH_GBA_OBS
    t = np.linspace(0, 60.0, N_used)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (cap.max_keyframes, 1, 1))
    Tcw[:N_used, 2, 3] = -t
    X = np.zeros((cap.max_map_points, 3), np.float32)
    X[:P_used, 0] = rng.uniform(-8, 8, P_used)
    X[:P_used, 1] = rng.uniform(-2, 2, P_used)
    X[:P_used, 2] = rng.uniform(2, 80, P_used) + np.repeat(
        np.linspace(0, 60.0, P_used // 64 + 1), 64)[:P_used]
    F = cap.max_features
    mp_idx = np.full((cap.max_keyframes, F), -1, np.int32)
    fv = np.zeros((cap.max_keyframes, F), bool)
    xy = np.zeros((cap.max_keyframes, F, 2), np.float32)
    ur = np.full((cap.max_keyframes, F), -1.0, np.float32)
    stride = max(1, (P_used - obs_per_kf) // max(N_used - 1, 1))
    for k in range(N_used):
        pts = (k * stride + np.arange(obs_per_kf)) % P_used
        Xc = X[pts] - np.array([0, 0, -t[k]], np.float32)
        z = np.maximum(Xc[:, 2], 0.5)
        u = cam.fx * Xc[:, 0] / z + cam.cx + rng.normal(0, 0.5, obs_per_kf)
        v = cam.fy * Xc[:, 1] / z + cam.cy + rng.normal(0, 0.5, obs_per_kf)
        mp_idx[k, :obs_per_kf] = pts
        fv[k, :obs_per_kf] = True
        xy[k, :obs_per_kf, 0] = u
        xy[k, :obs_per_kf, 1] = v
        ur[k, :obs_per_kf] = u - cam.bf / z
    m = ms.empty(cap, dev)
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    kf = m.kf._replace(Tcw=on(Tcw), valid=on(np.arange(cap.max_keyframes) < N_used), xy=on(xy),
                       uright=on(ur), fvalid=on(fv), mp_idx=on(mp_idx))
    mp = m.mp._replace(pos=on(X), valid=on(np.arange(cap.max_map_points) < P_used))
    return m._replace(kf=kf, mp=mp, n_kf=torch.tensor(N_used, dtype=torch.int32, device=dev),
                      n_mp=torch.tensor(P_used, dtype=torch.int32, device=dev))


def same_step_as_rounding(cam, pb, cg_iters: int) -> dict:
    """One LM iteration of K8 against the plain version where the step is
    metres long: the one-step pose tolerances (1e-4 m / rad), the cost
    (1e-3 relative), no inlier flip off the gate; the points are held to the
    plain version's own spread under one f32 rounding of its input (the
    plain version again on X moved one ulp up): at the 50th / 90th / 99th
    percentile the kernel's point differences at most twice that spread."""
    name = "bench_gba one LM iteration"
    k = ba_dense.optimize(cam, pb, 1, cg_iters, 1)
    p = ba_dense.optimize_plain(cam, pb, 1, cg_iters, 1)
    nudged = pb._replace(X=torch.nextafter(pb.X, torch.full_like(pb.X, float("inf"))))
    p_ulp = ba_dense.optimize_plain(cam, nudged, 1, cg_iters, 1)
    torch.cuda.synchronize()
    e = ba_errors(k, p, cam, pb)
    c = ba_errors(p_ulp, p, cam, pb)
    pct = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=pb.X.device)

    def spread(a):
        return torch.quantile((a.X - p.X).abs().max(dim=1).values.double(), pct).tolist()

    e.update(points_q=spread(k), plain_ulp_points_q=spread(p_ulp),
             plain_ulp=dict(t_max_abs=c["t_max_abs"], rot=c["rot"], x_frac_1mm=c["x_frac_1mm"],
                            cost_rel=c["cost_rel"]),
             step_q=torch.quantile((p.X - pb.X).abs().max(dim=1).values.double(), pct).tolist())
    require(e["cost_rel"] <= 1e-3 and e["flips_off_gate"] == 0 and e["t_max_abs"] <= 1e-4
            and e["rot"] <= 1e-4, f"ba_dense ({name}): {e}")
    require(all(a <= 2 * b for a, b in zip(e["points_q"], e["plain_ulp_points_q"])),
            f"ba_dense ({name}): point differences {e['points_q']} m (50/90/99 %) beyond twice "
            f"the plain version's own one-ulp spread {e['plain_ulp_points_q']} m")
    return e


def check_bench_gba() -> tuple:
    """K8 at bench_gba's shape, past the 256 cameras the one-CTA kernel held:
    its map through the port's `build_global_problem_dense(n_kf_hint=1536,
    n_mp_hint=196608)` (C 1536, Fb 512, P 196608), one LM iteration
    (`same_step_as_rounding`: the map's observations were made at depths
    that disagree with its poses, so the first step moves points 18-43 m)
    and a 2-iteration chunk (GlobalBARunner's: Huber on, gba_cg_iters)
    against optimize_plain, the chunk twice bit for bit. Its row's launches
    are one chunk's (no path runs this size)."""
    cam, cfg = CAM, bench_config()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    m = bench_gba_map(cam, cfg, dev)
    pb = gba.build_global_problem_dense(m, cfg, n_kf_hint=BENCH_GBA_KF, n_mp_hint=BENCH_GBA_MP)
    torch.cuda.synchronize()
    C, Fb = pb.obs_mp.shape
    P, K = pb.pm_src.shape
    info = dict(C=C, Fb=Fb, P=P, K=K, active=int(pb.obs_active.sum()),
                build_s=time.perf_counter() - t0)
    require((C, Fb, P) == (BENCH_GBA_KF, BENCH_GBA_OBS, BENCH_GBA_MP),
            f"bench_gba problem: C {C}, Fb {Fb}, P {P}")
    cg = cfg.loop.gba_cg_iters
    info["one_iteration"] = same_step_as_rounding(cam, pb, cg)
    k, info["chunk"] = same_ba(cam, pb, 2, 2, "bench_gba chunk", cg_iters=cg)
    same_twice(k, ba_dense.optimize(cam, pb, 2, cg, 2), "bench_gba chunk")
    chunk = lambda: ba_dense.optimize(cam, pb, 2, cg, 2, counter="ba_dense_gba")  # noqa: E731
    rows = [dict(name="ba_dense_bench_gba", max_abs_err=info["chunk"]["t_max_abs"],
                 bound=k8_bound(pb, info["chunk"]["trace_kernel"]),
                 launches=launches_of(chunk, "ba_dense_gba"),
                 fns=(chunk, lambda: ba_dense.optimize_plain(cam, pb, 2, cg, 2), None, 1),
                 kernel_reps=5, events=True)]
    return rows, info


FULL_CORPUS_FRAMES = 120  # the bench trajectory leaves the plane's texture near frame 110
CHUNKED_WORDS = 32768  # train_chunked's default vocabulary width


def check_full_width_training(te) -> tuple:
    """B16 at the reference's artifact size: a corpus of the port's front end
    (`build_frame_mono`, 2048 features) over both images of bench frames
    0..119 of the flagship world, trained 2-level at G 1024 x B 32, 8
    iterations a level, with K14 and with the plain version on the card from
    the same level-1 rows (the plain hierarchy composed from the plain
    pieces): level-1 centres, the grouping, words, child table and idf
    exact; `train_chunked` at 32768 words over the corpus (2 iterations):
    words and idf exact; `build_tree` over the shipped vocab32k's 32768
    words (G 1024, 8 iterations): its groups exact. Rows for level 1, level
    2 and the tree's k-majority."""
    dev = te.world.device
    t0 = time.perf_counter()
    descs = []
    for i in range(FULL_CORPUS_FRAMES):
        for img in te.world.render_stereo(gt_pose(i)):
            f = frame_mod.build_frame_mono(img, te.cam, te.cfg.orb, device=dev)
            descs.append(f.desc[f.fvalid])
    corpus = torch.cat(descs).contiguous()
    torch.cuda.synchronize()
    info = dict(corpus=corpus.shape[0], corpus_s=time.perf_counter() - t0)
    G, B, it = 1024, 32, 8
    N = corpus.shape[0]
    idx = vocab._draw(N, G, 0, dev, None)
    init1 = corpus[idx].contiguous()
    t0 = time.perf_counter()
    vk = vocab.train_hierarchical(corpus, G, B, it, init_idx=idx)
    torch.cuda.synchronize()
    info["kernel_s"] = time.perf_counter() - t0
    # The plain hierarchy, composed as train_hierarchical composes it.
    t0 = time.perf_counter()
    gb_p, _ = vocab.kmajority_plain(corpus, init1, it)
    grp_p = vocab.assign_flat_plain(corpus, gb_p)
    init2 = vocab.level2_init(corpus, gb_p, grp_p.cpu().numpy(), B, 0)
    words_p, counts_p = vocab.kmajority_plain(corpus, init2, it, group=grp_p, block=B)
    idf_p = vocab.idf_plain(counts_p)
    torch.cuda.synchronize()
    info["plain_s"] = time.perf_counter() - t0
    grp_k = vocab.assign_flat(corpus, vk.groups)
    child = torch.arange(G * B, dtype=torch.int32, device=dev).reshape(G, B)
    eq = dict(groups=torch.equal(vk.groups, gb_p), grp=torch.equal(grp_k, grp_p),
              words=torch.equal(vk.words, words_p), child=torch.equal(vk.child_idx, child),
              idf=torch.equal(vk.idf, idf_p))
    info["hierarchical"] = dict(equal=eq, idf=float((vk.idf - idf_p).abs().max()))
    require(all(eq.values()), f"train_hierarchical: kernel and plain differ {eq}")
    info["hierarchical_launches"] = launches_of(
        lambda: vocab.train_hierarchical(corpus, G, B, it, init_idx=idx))
    # train_chunked at its default width over the same corpus, 2 iterations:
    # a warp a tile of 16 rows and 32 staging passes of the centres.
    cidx = vocab._draw(N, CHUNKED_WORDS, 3, dev, None)
    ck = vocab.train_chunked(corpus, CHUNKED_WORDS, 2, init_idx=cidx)
    cw_p, cc_p = vocab.kmajority_plain(corpus, corpus[cidx].contiguous(), 2, chunk=8192)
    eq = dict(words=torch.equal(ck.words, cw_p), idf=torch.equal(ck.idf, vocab.idf_plain(cc_p)))
    info["train_chunked"] = dict(equal=eq, words=CHUNKED_WORDS, empty=int((cc_p == 0).sum()))
    require(all(eq.values()), f"train_chunked: kernel and plain differ {eq}")
    base = vocab.load_default(dev)
    flat = vocab.Vocabulary(base.words, base.idf)
    words = flat.words
    tidx = vocab._draw(flat.n_words, G, 101, dev, None)
    tinit = words[tidx].contiguous()
    tk = vocab.build_tree(flat, G, it, init_idx=tidx)
    # The child table is build_tree's host placement of the words by their
    # distance to these groups: equal groups give an equal table.
    info["tree"] = dict(groups=bool(torch.equal(tk.groups, vocab.kmajority_plain(words, tinit,
                                                                                   it)[0])),
                        cmax=tk.child_idx.shape[1])
    require(info["tree"]["groups"], f"build_tree: kernel and plain differ {info['tree']}")
    info["tree_launches"] = launches_of(lambda: vocab.build_tree(flat, G, it, init_idx=tidx))
    # The timed rows: level 1 (flat, N x G), level 2 (N x B in G blocks, from
    # the initial words both hierarchies drew), the tree (W x G).
    info["level1"] = same_km(corpus, init1, it, "level 1")
    info["level2"] = same_km(corpus, init2, it, "level 2", group=grp_k, block=B)
    info["tree_km"] = same_km(words, tinit, it, "build_tree")
    for k, (n, w, cand) in (("level1", (N, G, G)), ("level2", (N, G * B, B)),
                            ("tree_km", (words.shape[0], G, G))):
        info[k]["bound_cuda_cores"] = km_bound_cuda_cores(n, w, cand, it)
    bits01 = descriptors.unpack_bits(corpus).to(torch.int32)
    bits_pm = (2 * bits01 - 1).to(torch.float16)
    g01 = descriptors.unpack_bits(init1).to(torch.float16)
    wb01 = descriptors.unpack_bits(words).to(torch.int32)
    wb_pm = (2 * wb01 - 1).to(torch.float16)
    t01 = descriptors.unpack_bits(tinit).to(torch.float16)
    l1 = lambda: vocab.kmajority(corpus, init1, it)  # noqa: E731
    l2 = lambda: vocab.kmajority(corpus, init2, it, group=grp_k, block=B)  # noqa: E731
    tr = lambda: vocab.kmajority(words, tinit, it)  # noqa: E731
    # These rows run on no path: their launches are one call's, counted alone.
    rows = [
        dict(name="kmajority_l1", max_abs_err=info["level1"]["idf"], bound=km_bound(N, G, G, it),
             launches=launches_of(l1),
             fns=(l1, lambda: vocab.kmajority_plain(corpus, init1, it),
                  lambda: kmajority_library(bits_pm, bits01, g01, it), 1), kernel_reps=3,
             events=True),
        dict(name="kmajority_l2", max_abs_err=info["level2"]["idf"],
             bound=km_bound(N, G * B, B, it), launches=launches_of(l2),
             fns=(l2, lambda: vocab.kmajority_plain(corpus, init2, it, group=grp_k, block=B), None,
                  1), kernel_reps=3, events=True),
        dict(name="kmajority_tree", max_abs_err=info["tree_km"]["idf"],
             bound=km_bound(words.shape[0], G, G, it), launches=launches_of(tr),
             fns=(tr, lambda: vocab.kmajority_plain(words, tinit, it),
                  lambda: kmajority_library(wb_pm, wb01, t01, it), 1), kernel_reps=3,
             events=True),
    ]
    return rows, info


# ---------------------------------------------------------------------------
# The collaboration layer: run_collab's clients and server, and one fusion at
# the flagship's width
# ---------------------------------------------------------------------------

# The JAX yardstick: the JAX package's `apps/run_collab.py --clients 2
# --frames 30` on an Intel Xeon CPU (`tests/yardstick_collab.py 2 0`), with
# each client's recovered alignment held against the known offset of its
# first camera (`run_collab.gt_pose`; PERF.md §6, PR 15): the rotation and
# translation differences, and the median distance of the client's own map
# points from where the known alignment puts them (no alignment: 0.4 m).
# Every frame of both clients was OK and each client made one keyframe.
JAX_COLLAB = dict(fusions=2, kfs_received=2, global_keyframes=2, global_points=628,
                  foreign_kfs=(1, 1), transm=(True, True), rot_err_rad=(0.0, 0.03173585680266522),
                  t_err_m=(0.0, 0.4438140563530611), point_err_m=(0.0, 0.2610693965929993))
COLLAB_FRAMES = 30
# Kernels that only the server launches in the collaboration runs (the
# clients run no loop closer): their counts are the server path's.
SERVER_KERNELS = ("vocab_batch", "vocab", "horn", "pnp", "covis_matrix", "pose_graph")
# Plain versions of the kernels on the server path: none may run on the card.
PLAIN_FUNCTIONS = (
    (vocab, "assign_plain"), (vocab, "histogram_plain"), (vocab, "transform_batch_plain"),
    (vocab, "l1_scores_plain"), (sim3_solver, "horn_weighted_plain"),
    (sim3_solver, "horn_sim3_batched"), (pnp, "solve_pnp_ransac_plain"),
    (matcher, "match_select_plain"), (covis, "top_covisible_plain"),
    (covis, "local_map_mask_plain"), (covis, "compact_indices_plain"),
    (covis, "covis_matrix_plain"), (pose_graph, "optimize_plain"), (ba_dense, "optimize_plain"))


class Calls:
    """Counts the calls of module functions while installed and keeps each
    one's last arguments (for `vocab.transform_batch`, those of the call
    with the most rows); `undo` puts the functions back."""

    def __init__(self, targets):
        self.n, self.last, self._saved = {}, {}, []
        for mod, name in targets:
            real = getattr(mod, name)
            key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
            self.n[key] = 0

            def wrap(*a, _real=real, _key=key, **k):
                self.n[_key] += 1
                if _key != "vocab.transform_batch" or a[1].shape[0] >= (
                        self.last[_key][0][1].shape[0] if _key in self.last else 0):
                    self.last[_key] = (a, k)
                return _real(*a, **k)

            setattr(mod, name, wrap)
            self._saved.append((mod, name, real))

    def undo(self):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def timed_method(obj, name: str, out: list, events: bool = True) -> None:
    """Replace obj.name by a wrapper appending (host ms, CUDA-event ms or
    None) of each call to `out`."""
    real = getattr(obj, name)

    def run(*a, **k):
        t0 = time.perf_counter()
        if events:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        r = real(*a, **k)
        ev = None
        if events:
            end.record()
            end.synchronize()
            ev = start.elapsed_time(end)
        out.append(((time.perf_counter() - t0) * 1e3, ev))
        return r

    setattr(obj, name, run)


def alignment_errors(server, clients) -> list:
    """Each fused client's alignment against the known one (None where the
    client was never fused): the clients' worlds are their first cameras,
    so client k's world maps into client 1's by S = gt_pose(0, 0)
    gt_pose(0, k)^-1. `rot` (rad) and `t` (m) are the differences of the
    rotations and translations; `points` (m) is the median distance between
    where the recovered alignment and S put the client's own map points,
    and `identity` (m) that distance had the server returned no alignment
    (|t of S|: S is a pure translation)."""
    T0 = run_collab.gt_pose(0, 0).double()
    out = []
    for k, c in enumerate(clients):
        if k + 1 not in server.transMs:
            out.append(None)
            continue
        R, t, _ = server.transMs[k + 1]
        R = torch.from_numpy(np.asarray(R, np.float64))
        t = torch.from_numpy(np.asarray(t, np.float64))
        S = T0 @ torch.linalg.inv(run_collab.gt_pose(0, k).double())
        ang = float(torch.arccos(((torch.trace(R @ S[:3, :3].T) - 1) / 2).clamp(-1, 1)))
        mp = c.tracker.map.mp
        p = mp.pos[mp.valid & (mp.client == k + 1)].cpu().double()
        moved = (p @ R.T + t) - (p @ S[:3, :3].T + S[:3, 3])
        out.append(dict(rot=ang, t=float(torch.linalg.norm(t - S[:3, 3])),
                        points=float(moved.norm(dim=1).median()) if len(p) else float("nan"),
                        identity=float(torch.linalg.norm(S[:3, 3]))))
    return out


def unique_gids(*idmaps) -> bool:
    for ids in idmaps:
        g = ids.gid_of_row[ids.gid_of_row >= 0]
        if len(np.unique(g)) != len(g):
            return False
    return True


def finite_map(m) -> bool:
    return bool(torch.isfinite(m.kf.Tcw[m.kf.valid]).all()) and bool(
        torch.isfinite(m.mp.pos[m.mp.valid]).all())


def stats_ms(v: list) -> dict:
    host = [h for h, _ in v]
    ev = [e for _, e in v if e is not None]
    out = dict(n=len(v), host_ms=[round(x, 3) for x in host])
    if ev:
        out["event_ms"] = [round(x, 3) for x in ev]
    return out


def run_collab_clients(n: int) -> dict:
    """`apps.run_collab` with n clients over COLLAB_FRAMES frames on the card
    (the JAX package's collaboration config: 320x240, 512 features, 4
    levels, 256 keyframes, 32768 points, the shipped vocab32k), every
    counter reset just before; each client frame, server step, uplink and
    downlink timed. Checks: every client's keyframes reach the server, gids
    unique on every map, poses and points finite, one K9 assignment and one
    histogram launch a `transform_batch` (a query block of up to 256
    keyframes or an inserted chunk), one weighted-Horn launch a `detect_overlap`, and no
    plain version of a kernel on the server path."""
    t_setup = time.perf_counter()
    cr = run_collab.setup(n, "cuda")
    setup_s = time.perf_counter() - t_setup
    server = cr.server
    steps = {k: [] for k in ("fuse_step", "broadcast_step", "_try_align", "_merge_submap",
                             "_post_fusion_optimize")}
    for name in ("_try_align", "_merge_submap", "_post_fusion_optimize"):
        timed_method(server, name, steps[name])
    uplink, downlink = [], []
    for c in cr.clients:
        timed_method(c.cache, "uplink_step", uplink, events=False)
        timed_method(c.cache, "downlink_step", downlink, events=False)
    frame_ms = [[] for _ in range(n)]
    step_launches: dict = {}

    def frame(i, k, fn):
        t0 = time.perf_counter()
        fn()
        frame_ms[k].append((time.perf_counter() - t0) * 1e3)

    def step(name, fn):
        before = dict(kernels.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        steps[name].append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end)))
        for key, v in kernels.LAUNCHES.items():
            if v - before[key]:
                step_launches[key] = step_launches.get(key, 0) + v - before[key]

    calls = Calls(PLAIN_FUNCTIONS + ((vocab, "transform_batch"), (fusion_ops, "detect_overlap"),
                                     (sim3_solver, "horn_sim3")))
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        run_collab.run(cr, COLLAB_FRAMES, frame=frame, step=step)
    finally:
        calls.undo()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    plain = {k: v for k, v in calls.n.items() if k.endswith(("_plain", "_batched")) and v}
    require(not plain, f"collab {n} clients: plain versions ran on the card: {plain}")
    n_tb, n_do = calls.n["vocab.transform_batch"], calls.n["fusion_ops.detect_overlap"]
    require(launches["vocab_batch"] == 2 * n_tb > 0,
            f"collab {n}: {launches['vocab_batch']} batched K9 launches for {n_tb} transform_batch")
    require(launches["horn"] == n_do == calls.n["sim3_solver.horn_sim3"],
            f"collab {n}: {launches['horn']} weighted-Horn launches for {n_do} detect_overlap")
    cl = []
    for k, c in enumerate(cr.clients):
        st = c.cache.stats
        states = "".join(x.name[0] for x in c.tracker.frame_states)
        cl.append(dict(cid=k + 1, states=states, kfs_pushed=st["kfs_pushed"],
                       mps_pushed=st["mps_pushed"], foreign_kfs=st["foreign_kfs"],
                       foreign_mps=st["foreign_mps"], failed_calls=st["failed_calls"],
                       transm=c.cache.Ttrans is not None, keyframes=int(c.tracker.map.n_kf),
                       frame_ms_p50=float(np.percentile(frame_ms[k], 50)),
                       frame_ms_p90=float(np.percentile(frame_ms[k], 90))))
        require(finite_map(c.tracker.map), f"collab {n}: client {k + 1} has a non-finite map")
        require(unique_gids(c.cache.kf_ids, c.cache.mp_ids),
                f"collab {n}: client {k + 1} has duplicate gids")
    g = server.gmap
    require(finite_map(g), f"collab {n}: the global map is not finite")
    require(unique_gids(server.g_kf_ids, server.g_mp_ids), f"collab {n}: duplicate global gids")
    pushed = sum(c["kfs_pushed"] for c in cl)
    require(server.stats["kfs_received"] == pushed,
            f"collab {n}: the server received {server.stats['kfs_received']} keyframes of the "
            f"{pushed} pushed")
    errs = alignment_errors(server, cr.clients)
    out = dict(clients=n, frames=COLLAB_FRAMES, setup_s=setup_s, wall_s=wall_s,
               stats=dict(server.stats), global_keyframes=int(g.kf.valid.sum()),
               global_points=int(g.mp.valid.sum()), alignment_errors=errs, client_rows=cl,
               steps={k: stats_ms(v) for k, v in steps.items()},
               uplink=stats_ms(uplink), downlink=stats_ms(downlink),
               launches=launches, server_step_launches=step_launches,
               server_launches={k: launches[k] for k in SERVER_KERNELS},
               transform_batch_calls=n_tb, detect_overlap_calls=n_do,
               frame_ms=[[round(x, 3) for x in f] for f in frame_ms])
    out["horn_inputs"] = calls.last.get("sim3_solver.horn_sim3")
    out["k9_inputs"] = calls.last.get("vocab.transform_batch")
    return out


def collab_gates(cp: dict, jax: bool) -> None:
    """The collaboration run's gates: every client fused and aligned, and
    each alignment putting the client's map points less than half as far
    from their true place as no alignment would (the median point error
    under half the identity's);
    against the JAX yardstick also the fusions, each alignment within 2x
    JAX's error or 0.05 m / 5e-3 rad, the global keyframes within 1."""
    n = cp["clients"]
    require(all(c["transm"] for c in cp["client_rows"]),
            f"collab {n}: a client's alignment is unknown: {cp['client_rows']}")
    require(all(e is not None for e in cp["alignment_errors"]),
            f"collab {n}: a client was never fused: {cp['alignment_errors']}")
    for k, e in enumerate(cp["alignment_errors"][1:], start=2):
        require(e["points"] < 0.5 * e["identity"], f"collab {n}: client {k}'s alignment puts "
                f"its points {e['points']:.4g} m off, no alignment {e['identity']:.4g} m")
    if not jax:
        require(cp["stats"]["fusions"] == n, f"collab {n}: {cp['stats']['fusions']} fusions")
        return
    require(cp["stats"]["fusions"] == JAX_COLLAB["fusions"],
            f"collab: {cp['stats']['fusions']} fusions, JAX {JAX_COLLAB['fusions']}")
    for k, e in enumerate(cp["alignment_errors"]):
        ang, t = e["rot"], e["t"]
        lim_r = max(2 * JAX_COLLAB["rot_err_rad"][k], 5e-3)
        lim_t = max(2 * JAX_COLLAB["t_err_m"][k], 0.05)
        require(ang <= lim_r and t <= lim_t, f"collab: client {k + 1}'s alignment off by "
                f"{ang:.4g} rad / {t:.4g} m (limits {lim_r:.4g} / {lim_t:.4g})")
    require(abs(cp["global_keyframes"] - JAX_COLLAB["global_keyframes"]) <= 1,
            f"collab: {cp['global_keyframes']} global keyframes, JAX "
            f"{JAX_COLLAB['global_keyframes']}")


class MapHolder:
    """A client map standing in for a tracker (the cache needs `.map`)."""

    def __init__(self, m):
        self.map = m


# Client 2's world: the scene moved by this SE3 (tests/test_collab.py's
# T2_world), so the server must recover its inverse.
T2_XI = (1.5, -0.4, 0.3, 0.0, 0.25, 0.0)


def flagship_fusion(m_flag, cam, cfg) -> dict:
    """One fusion at the flagship's width: client 1 is the tracker phase's
    final map (KITTI_STEREO, 2048 features, 2048 keyframe rows), client 2
    the same map moved by the known SE3 of T2_XI; both pushed through a
    serializing in-process transport into a server with synchronous global
    BA, then two fuse steps and a broadcast. Checks the recovered Sim3
    (5e-3 in R and scale, 5e-2 m in t), fewer valid points than the union,
    one seam fuse and one essential graph, the global BA run, and client 1
    receiving client 2's keyframes, fixed."""
    dev = m_flag.kf.Tcw.device
    voc = vocab.load_default(dev)
    m1 = ms.clone(m_flag)
    m1.kf.client.fill_(1)
    m1.mp.client.fill_(1)
    T2 = se3.exp(torch.tensor(T2_XI, dtype=torch.float32, device=dev))
    m2 = fusion_ops.transform_map(m1, T2[:3, :3].contiguous(), T2[:3, 3].contiguous(),
                                  torch.ones((), device=dev))
    m2.kf.client.fill_(2)
    m2.mp.client.fill_(2)
    transport = InProcTransport(serialize=True)
    server = MapFusionServer(cam, cfg, voc, transport, run_gba=True, synchronous_gba=True,
                             device=dev)
    c1 = ClientCache(MapHolder(m1), transport, 1, cfg)
    c2 = ClientCache(MapHolder(m2), transport, 2, cfg)
    times = {}
    calls = Calls(PLAIN_FUNCTIONS + ((vocab, "transform_batch"), (fusion_ops, "detect_overlap"),
                                     (sim3_solver, "horn_sim3")))
    kernels.reset_launches()

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        r = fn()
        end.record()
        end.synchronize()
        times.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3,
                                           start.elapsed_time(end)))
        return r

    try:
        require(timed("uplink_1", c1.uplink_step) and timed("uplink_2", c2.uplink_step),
                "flagship fusion: an uplink failed")
        require(timed("fuse_step", server.fuse_step), "flagship fusion: the seed did not merge")
        n_before = int(server.gmap.mp.valid.sum())
        n_sub2 = int(server.sub[2].map.mp.valid.sum())
        n_kf2 = int(server.sub[2].map.kf.valid.sum())
        require(timed("fuse_step", server.fuse_step), "flagship fusion: client 2 did not merge")
        n_kf_1 = int(c1.tracker.map.n_kf)
        timed("broadcast_step", server.broadcast_step)
        timed("downlink_1", c1.downlink_step)
    finally:
        calls.undo()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    plain = {k: v for k, v in calls.n.items() if k.endswith(("_plain", "_batched")) and v}
    require(not plain, f"flagship fusion: plain versions ran on the card: {plain}")
    R, t, s = server.transMs[2]
    Te = torch.linalg.inv(T2.double()).cpu().numpy()
    err_R = float(np.abs(R - Te[:3, :3]).max())
    err_t = float(np.abs(t - Te[:3, 3]).max())
    err_s = abs(s - 1.0)
    require(err_R <= 5e-3 and err_s <= 5e-3 and err_t <= 5e-2,
            f"flagship fusion: alignment off by R {err_R:.3g}, t {err_t:.3g} m, s {err_s:.3g}")
    g = server.gmap
    n_after = int(g.mp.valid.sum())
    require(n_after < n_before + n_sub2,
            f"flagship fusion: {n_after} valid points, not fewer than {n_before} + {n_sub2}")
    st = server.stats
    require(st["seam_fuses"] == st["essential_graph_runs"] == 1,
            f"flagship fusion: seam fuses {st['seam_fuses']}, essential graphs "
            f"{st['essential_graph_runs']}")
    require(server.gba.runs_finished == 1 and launches["ba_dense_gba"] > 0,
            "flagship fusion: the global BA did not run")
    m = c1.tracker.map
    rows = torch.arange(n_kf_1, int(m.n_kf), device=dev)
    require(len(rows) == n_kf2 and bool(m.kf.fixed[rows].all())
            and bool((m.kf.client[rows] == 2).all()),
            f"flagship fusion: client 1 received {len(rows)} keyframes of client 2's {n_kf2}")
    require(finite_map(g) and finite_map(m), "flagship fusion: a map is not finite")
    require(launches["horn"] == calls.n["fusion_ops.detect_overlap"]
            and launches["vocab_batch"] == 2 * calls.n["vocab.transform_batch"],
            f"flagship fusion: launches {launches} for {calls.n}")
    return dict(err_R=err_R, err_t_m=err_t, err_s=err_s, points_before=n_before,
                points_sub2=n_sub2, points_after=n_after, keyframes_sub2=n_kf2,
                received_keyframes=len(rows), stats=dict(st),
                gba_runs=server.gba.runs_finished,
                times={k: [(round(h, 3), round(e, 3)) for h, e in v] for k, v in times.items()},
                launches=launches, k9_inputs=calls.last.get("vocab.transform_batch"),
                horn_inputs=calls.last.get("sim3_solver.horn_sim3"),
                transform_batch_calls=calls.n["vocab.transform_batch"],
                detect_overlap_calls=calls.n["fusion_ops.detect_overlap"])


def run_collab_phase(kp: dict) -> dict:
    """The collaboration phase: run_collab with 2 clients (gated on the JAX
    yardstick) and 4 clients, then one fusion at the flagship's width."""
    two = run_collab_clients(2)
    collab_gates(two, jax=True)
    four = run_collab_clients(4)
    collab_gates(four, jax=False)
    tr = kp["tracker"]
    flag = flagship_fusion(tr.map, tr.cam, tr.cfg)
    return dict(two=two, four=four, flagship=flag)


def same_horn(p1, p2, fix_scale, w, name: str) -> dict:
    """The weighted-Horn kernel against its plain version on one input."""
    Rk, tk, sk = sim3_solver.horn_sim3(p1, p2, fix_scale, w=w)
    Rp, tp_, sp = sim3_solver.horn_weighted_plain(p1, p2, w, fix_scale)
    d = dict(R=float((Rk - Rp).abs().max()), t=float((tk - tp_).abs().max()),
             s=float((sk - sp).abs()), K=int(p1.shape[0]), fix_scale=bool(fix_scale),
             weighted=int((w > 0).sum()))
    require(d["R"] <= 1e-5 and d["t"] <= 1e-4 and d["s"] <= 1e-5,
            f"weighted Horn ({name}): kernel and plain differ: {d}")
    return d


def horn_edges(dev) -> dict:
    """The weighted Horn at its edges: K 1, every weight 0, fix_scale both
    ways on a noisy Sim3 with 30 % of the pairs weighted out, K past the
    CTA's 256 threads many times."""
    g = torch.Generator(device="cpu").manual_seed(3)
    out = {}
    for name, K, fix, wmode in (("k1", 1, False, "ones"), ("zero_weights", 64, False, "zero"),
                                ("fixed_scale", 2048, True, "mask"),
                                ("free_scale", 2048, False, "mask"), ("k5000", 5000, False, "ones")):
        p2 = torch.randn(K, 3, generator=g) * 4
        S = sim3.exp(torch.randn(7, generator=g) * 0.3)
        p1 = sim3.transform(S, p2) + torch.randn(K, 3, generator=g) * 0.01
        w = {"ones": torch.ones(K), "zero": torch.zeros(K),
             "mask": (torch.rand(K, generator=g) > 0.3).float()}[wmode]
        out[name] = same_horn(p1.to(dev), p2.to(dev), fix, w.to(dev), name)
    return out


def same_vocab_batch(voc, desc, valid, name: str) -> dict:
    """Batched K9 against its plain version: word ids exact, BoW 1e-6."""
    B, F = desc.shape[:2]
    wk = vocab.assign(voc, desc.reshape(B * F, 32).contiguous())
    wp = vocab.assign_plain(voc, desc.reshape(B * F, 32))
    bk = vocab.transform_batch(voc, desc, valid)
    bp = vocab.transform_batch_plain(voc, desc, valid)
    d = dict(words_equal=bool(torch.equal(wk, wp)), bow=float((bk - bp).abs().max()) if B else 0.0,
             B=B, F=F, valid=int(valid.sum()))
    require(d["words_equal"] and d["bow"] <= 1e-6, f"batched K9 ({name}): {d}")
    return d


def vocab_batch_edges(voc, dev) -> dict:
    """Batched K9 at its edges: one row, a row with no valid feature, F off
    every tile width, and no row at all."""
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for name, B, F in (("one_row", 1, 512), ("no_valid_row", 3, 512), ("f37", 4, 37),
                       ("empty", 0, 64)):
        desc = torch.randint(0, 256, (B, F, 32), generator=g, dtype=torch.uint8)
        valid = torch.rand(B, F, generator=g) < 0.8
        if name == "no_valid_row":
            valid[1] = False
        out[name] = same_vocab_batch(voc, desc.to(dev), valid.to(dev), name)
    return out


def check_collab_kernels(cp: dict) -> tuple:
    """Batched K9 and the weighted Horn against their plain versions on the
    collaboration runs' own inputs (the widest `transform_batch` and the
    last `horn_sim3` of the 2-client run and of the flagship fusion: there
    the query block of its alignment, every keyframe of client 2's sub-map) and at their edges; rows
    for the kernels' line with their bounds, timed on the flagship fusion's
    inputs."""
    info, rows = {}, []
    two, flag = cp["two"], cp["flagship"]
    for run, d in (("run_collab", two), ("flagship", flag)):
        (voc, desc, valid), _ = d["k9_inputs"]
        info[f"vocab_batch_{run}"] = same_vocab_batch(voc, desc, valid, run)
        (p1, p2, fix), kw = d["horn_inputs"]
        info[f"horn_{run}"] = same_horn(p1, p2, fix, kw["w"], run)
    (voc, desc, valid), _ = flag["k9_inputs"]
    info["vocab_batch_edges"] = vocab_batch_edges(voc, desc.device)
    info["horn_edges"] = horn_edges(desc.device)
    B, F = desc.shape[:2]
    W, G, C = voc.n_words, voc.groups.shape[0], voc.child_idx.shape[1]
    nv = int(valid.sum())
    # Bound: the assignment's operations and the histogram's bytes
    # (descriptors and flags read, the centres, child table and idf read
    # once, the [B, W] BoW written). Each descriptor-centre distance (the G
    # group centres and the two chosen child blocks) counts as the int8
    # product the reference computes it by (256 multiply-adds, 512
    # operations) on the tensor cores, as K14's bound does; the histogram's
    # adds on the CUDA cores. `bound_cuda_cores` keeps the count with every
    # distance on the CUDA cores (24 operations), the kernel's own way.
    vb_bytes = B * F * 33 + (G + W) * 32 + G * C * 4 + W * 4 + B * W * 4
    vb_dist = B * F * (G + 2 * C)
    info["vocab_batch_bound_cuda_cores"] = bound_ms(vb_bytes, vb_dist * 24 + B * 3 * W + nv)
    rows.append(dict(name="vocab_batch", max_abs_err=info["vocab_batch_flagship"]["bow"],
                     bound=bound_ms(vb_bytes, B * 3 * W + nv, n_int8_ops=vb_dist * 512),
                     fns=(lambda: vocab.transform_batch(voc, desc, valid),
                          lambda: vocab.transform_batch_plain(voc, desc, valid), None, 2)))
    (p1, p2, fix), kw = flag["horn_inputs"]
    w = kw["w"]
    K = p1.shape[0]
    # Bound: its reads (the pairs and weights once, the model written); ops
    # per pair ~46 (the weight sum, centroids and M) plus ~50 for the free
    # scale, and ~4200 serial ones on one thread (100 power iterations):
    # in practice the chain's latency, not either rate.
    h_bytes = K * (12 + 12 + 4) + 13 * 4
    h_ops = K * (46 + (0 if fix else 50)) + 4200
    rows.append(dict(name="horn", max_abs_err=max(info["horn_flagship"]["R"],
                                                  info["horn_flagship"]["t"]),
                     bound=bound_ms(h_bytes, h_ops),
                     fns=(lambda: sim3_solver.horn_sim3(p1, p2, fix, w=w),
                          lambda: sim3_solver.horn_weighted_plain(p1, p2, w, fix), None, 3)))
    info["sizes"] = dict(B=B, F=F, W=W, G=G, C=C, valid=nv, horn_pairs=K,
                         horn_weighted=int((w > 0).sum()), horn_fix_scale=bool(fix))
    return rows, info


SMALL_MS = 0.05  # below this, torch.profiler's device sums disagree between runs


def graph_ms(fn, reps: int = 100) -> float:
    """Mean time of one fn() call replayed from a CUDA graph of `reps`
    calls, CUDA events around one replay: no host launch gaps, so calls of
    a few microseconds are resolved; each kernel node of the graph adds its
    launch latency on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def launch_times(call) -> dict:
    """Each kernel launch of one `call()` on its own (`recorded_launches`),
    `graph_ms` of up to 100 repeats: {C entry: ms}."""
    return {name: graph_ms(fn) for name, fn in recorded_launches(call).items()}


def timed_ms(fn, reps: int, call_ms: float) -> tuple:
    """(ms, how): the profiler's device time of one call, or, where that
    reads under SMALL_MS or two sessions record nothing, the CUDA-graph
    replay time (`graph_ms` of up to 100 calls, about 10 ms of work at the
    host-inclusive `call_ms`; a call that syncs with the host cannot be
    captured and fails the run)."""
    ms = device_ms(fn, reps=reps, warmup=min(3, reps))
    if ms is not None and ms >= SMALL_MS:
        return ms, "profiler"
    g = graph_ms(fn, reps=max(1, min(100, int(10.0 / max(call_ms, 1e-3)))))
    return g, "graph (" + ("no profiler events" if ms is None else f"profiler {ms:.5f}") + ")"


def time_rows(rows: list) -> None:
    """Host-inclusive times first (a profiler session may slow later host
    work), then device times (`timed_ms`), for rows of (kernel, plain,
    library, plain reps); a row's "kernel_reps" (default 20) sets the
    kernel's, and a row with "events" takes the host-inclusive CUDA-event
    time as its "ms" (calls of milliseconds, where launch gaps are
    negligible; torch.profiler read one 10.7 ms K8 call as 2.15 ms), and a
    row with "graph" the replayed CUDA graph (`graph_ms`: K6's cluster
    launch), each with the profiler's reading beside it."""
    for r in rows:
        kernel_fn, plain_fn, _, reps = r["fns"]
        kreps = r.get("kernel_reps", 20)
        r["host_ms"] = host_ms(kernel_fn, reps=kreps, warmup=min(3, kreps))
        r["plain_host_ms"] = host_ms(plain_fn, reps=reps, warmup=min(3, reps))
    for r in rows:
        kernel_fn, plain_fn, library_fn, reps = r.pop("fns")
        kreps = r.pop("kernel_reps", 20)
        if r.pop("events", False):  # milliseconds a call: CUDA events suffice
            r["ms"], r["ms_by"] = r["host_ms"], "events"
            r["profiler_ms"] = device_ms(kernel_fn, reps=kreps, warmup=min(3, kreps))
        elif r.pop("graph", False):  # a cluster launch: the replayed graph
            r["ms"], r["ms_by"] = graph_ms(kernel_fn), "graph"
            r["profiler_ms"] = device_ms(kernel_fn, reps=kreps, warmup=min(3, kreps))
        else:
            r["ms"], r["ms_by"] = timed_ms(kernel_fn, kreps, r["host_ms"])
        r["plain_ms"], r["plain_ms_by"] = timed_ms(plain_fn, reps, r["plain_host_ms"])
        r["library_ms"], r["library_ms_by"] = (timed_ms(library_fn, 20, host_ms(library_fn))
                                               if library_fn else (None, None))


# The JAX package's endurance run on a CPU (tests/yardstick_endurance.py,
# JAX 0.9.0 on an "Intel(R) Xeon(R) Processor"), each on the words the
# port's run uses, which `words` (kernel_times.digest of the words and
# their idf as the port loads them) ties to it: the bench's own run
# (bench.py:118-206: its words trained with seed 0, shipped as
# assets/endurance_bench_words.npz) and the run on the words the entry
# trains on the card (--load-vocab of the chiprun_out/endurance_vocab.npz
# this phase writes). A change to K14, the corpus or the training seed
# changes the entry's hash; the yardstick is then run again on the new words.
JAX_ENDURANCE_BENCH = dict(loops=9, ate_kf_m=0.045, words="e4cb202555628e20")
JAX_ENDURANCE_ENTRY_WORDS = dict(loops=7, ate_kf_m=0.0582, words="4ff61c0a41042b56")
BENCH_WORDS = os.path.join(ROOT, "assets", "endurance_bench_words.npz")
# The TPU record of older code (VERDICT.md:20): an outcome, quoted beside the
# run, never a gate.
TPU_ENDURANCE_RECORD = dict(loops=8, gba_runs=8, compactions=1, keyframes_created=339,
                            keyframes_live=89, ate_kf_m=0.063)
ENDURANCE_KERNELS = TRACKING_KERNELS + ("covisibility", "ba_dense", "vocab", "sim3", "pose_graph",
                                        "covis_matrix", "kmajority", "ba_dense_gba")
CHECKPOINT_FRAMES, PROFILE_FRAMES = 10, 20


def force_compaction_during_gba(client) -> dict:
    """A compaction that meets a running global BA, on the client's final
    map: the GBA is launched with its first chunk held until the abort flag
    is raised, then the tracker compacts while `busy()`. Under half a full
    keyframe table `_compact_map` would only resync its cursor, so for this
    one call the tracker's table is taken as full at its cursor."""
    tr, lc = client.tracker, client.loop_closer
    g = lc.gba_runner
    started, chunk, cfg = threading.Event(), g._chunk, tr.cfg

    def held_chunk(prob, k):
        started.set()
        g._abort.wait(60)
        return chunk(prob, k)

    g._chunk = held_chunk
    try:
        g.launch(tr.map)
        require(started.wait(60) and g.busy(), "forced compaction: the GBA is not running")
        n_kf = int(tr.map.n_kf)
        if n_kf < int(0.5 * cfg.capacity.max_keyframes):
            tr.cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity, max_keyframes=n_kf))
        aborted, n0 = g.runs_aborted, tr.stats.n_compactions
        tr._compact_map()
        out = dict(frame=tr.frame_id, n_kf_before=n_kf, n_kf_after=int(tr.map.n_kf),
                   gba_busy=True, gba_unmerged=False, aborts_added=g.runs_aborted - aborted,
                   result_left=g._result is not None, rows_live=live_rows_ok(client),
                   compacted=tr.stats.n_compactions - n0)
    finally:
        tr.cfg = cfg
        del g._chunk
    m = tr.map
    out["merged_nothing"] = lc.try_merge_gba(m) is m
    return out


def frames_ok(states: list, relocalizations: int) -> bool:
    """Frames 1.. OK or LOST, at most 1 % LOST, the last OK, and a LOST frame
    only where the run relocalized."""
    n = len(states)
    lost = [i for i in range(1, n) if states[i] != "OK"]
    return (all(states[i] in ("OK", "LOST") for i in range(1, n)) and len(lost) <= 0.01 * (n - 1)
            and states[-1] == "OK" and (not lost or relocalizations >= 1))


def loops_near(out: dict, yardstick: dict) -> bool:
    """At least 4 loops, and no more than 3 away from the yardstick's count."""
    n = out["endurance_loops_closed"]
    return n >= 4 and abs(n - yardstick["loops"]) <= 3


def run_on_bench_words(ee) -> dict:
    """The endurance run again, the same frames and client, on the bench's
    own words (the vocabulary bench.py trains with seed 0, in the artifact
    format): `run_endurance`'s outcome with `words` (their hash) and
    `gba_alive` (a GBA thread alive after the shutdown)."""
    voc = vocab.load(BENCH_WORDS, "cuda")
    words = digest(voc.words, voc.idf)
    require(words == JAX_ENDURANCE_BENCH["words"],
            f"endurance: {BENCH_WORDS} holds other words (hash {words}) than the bench's run")
    client = CorbslamClient(ee.cam, ee.cfg, sensor="stereo", client_id=1, voc=voc,
                            enable_loop_closing=True, run_gba=True, device="cuda")
    t0 = time.perf_counter()
    out = run_endurance(client, ee)
    g = client.loop_closer.gba_runner
    out.update(words=words, wall_s=time.perf_counter() - t0,
               gba_alive=g._thread is not None and g._thread.is_alive())
    return out


def run_endurance_phase() -> dict:
    """The endurance run (`entry.endurance_entry` / `run_endurance`: 1050
    frames, ~8.3 laps of the occluded, shaded room, a 256-row keyframe table
    that the run overflows, loop closing and asynchronous global BA), all
    counters reset just before the vocabulary's training, held to the JAX
    CPU yardstick's outcome. The frames are fed as the bench feeds them (no
    sync a frame); a frame's time is the host's time in `track_stereo`."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    client, ee = endurance_entry("cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    # The vocabulary it trained, for the reference's run on the same words
    # (tests/yardstick_endurance.py --load-vocab), and its hash.
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    vocab.save(client.voc, os.path.join(os.path.dirname(REPORT), "endurance_vocab.npz"))
    voc_hash = digest(client.voc.words, client.voc.idf)
    require(voc_hash == JAX_ENDURANCE_ENTRY_WORDS["words"],
            f"endurance: the entry's words changed (hash {voc_hash}, the yardstick's "
            f"{JAX_ENDURANCE_ENTRY_WORDS['words']}): run tests/yardstick_endurance.py "
            "--load-vocab chiprun_out/endurance_vocab.npz for a new yardstick")
    tr, lc_ = client.tracker, client.loop_closer
    g = lc_.gba_runner
    log = []
    compact = tr._compact_map

    def logged_compact():  # each compaction: cursors, the GBA it met, the rows after it
        before, mp_before, n0 = int(tr.map.n_kf), int(tr.map.n_mp), tr.stats.n_compactions
        busy, unmerged, aborted = g.busy(), g._result is not None, g.runs_aborted
        compact()
        if tr.stats.n_compactions > n0:
            log.append(dict(frame=tr.frame_id, n_kf_before=before, n_kf_after=int(tr.map.n_kf),
                            n_mp_before=mp_before, n_mp_after=int(tr.map.n_mp),
                            gba_busy=busy, gba_unmerged=unmerged and not busy,
                            aborts_added=g.runs_aborted - aborted,
                            result_left=g._result is not None, rows_live=live_rows_ok(client)))

    tr._compact_map = logged_compact
    t0 = time.perf_counter()
    try:
        out = run_endurance(client, ee)
    finally:
        del tr._compact_map
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    gba_alive = g._thread is not None and g._thread.is_alive()
    natural = [c for c in log if c["gba_busy"]]
    forced = None if natural else force_compaction_during_gba(client)
    met = natural + ([forced] if forced else [])
    states = out["states"]
    lost = [i for i, x in enumerate(states) if x != "OK"]
    fs = np.asarray(out["frame_s"]) * 1e3
    ep = dict(client=client, ee=ee, train_s=train_s, wall_s=wall_s, launches=launches,
              vocab_hash=voc_hash, corpus=ee.corpus.shape[0],
              frame_ms_p50=float(np.percentile(fs, 50)), frame_ms_p90=float(np.percentile(fs, 90)),
              frame_ms_max=float(fs.max()), not_ok=[(i, states[i]) for i in lost],
              forced=forced, ortho_err=orthonormal_error(tr.map), gba_alive=gba_alive,
              compaction_log=log,
              **{k: v for k, v in out.items() if k not in ("frame_s", "states")})
    n = out["endurance_frames"]
    gates = dict(
        frames_ok=frames_ok(states, out["relocalizations"]),
        no_reset=out["endurance_resets"] == 0,
        compacted=out["endurance_compactions"] >= 1,
        compactions_counted=out["endurance_compactions"] == len(log),
        compaction_met_gba=bool(met) and all(c["aborts_added"] >= 1 and not c["result_left"]
                                              for c in met)
        and (forced is None or (forced["compacted"] == 1 and forced["merged_nothing"])),
        rows_live=all(c["rows_live"] for c in log + ([forced] if forced else [])),
        loops=loops_near(out, JAX_ENDURANCE_ENTRY_WORDS),
        gba_finished=out["gba_finished"] >= 1,
        finite_orthonormal=ep["ortho_err"] < 1e-3,
        no_gba_thread=not gba_alive,
        keyframe_ate=out["endurance_ate_kf"] <= 2 * JAX_ENDURANCE_ENTRY_WORDS["ate_kf_m"],
        **{f"launched_{k}": launches[k] > 0 for k in ENDURANCE_KERNELS})
    ep["bench_words"] = bw = run_on_bench_words(ee)
    gates.update(bench_words_frames_ok=frames_ok(bw["states"], bw["relocalizations"]),
                 bench_words_no_reset=bw["endurance_resets"] == 0,
                 bench_words_loops=loops_near(bw, JAX_ENDURANCE_BENCH),
                 bench_words_keyframe_ate=(bw["endurance_ate_kf"]
                                           <= 2 * JAX_ENDURANCE_BENCH["ate_kf_m"]),
                 bench_words_no_gba_thread=not bw["gba_alive"])
    ep["gates"] = gates
    shown = {k: v for k, v in ep.items() if k not in ("client", "ee")}
    shown["bench_words"] = {k: v for k, v in bw.items() if k not in ("frame_s", "states")}
    print("endurance (before the checks): " + json.dumps(shown, default=str), flush=True)
    for name, ok in gates.items():
        require(ok, f"endurance: gate {name} failed ({json.dumps(gates)})")
    return ep


def same_tables(path: str, m, db) -> dict:
    """Every table of the saved npz bit-equal to the map / database given."""
    data = np.load(path)
    tables = {f"kf_{k}": v for k, v in m.kf._asdict().items()}
    tables.update({f"mp_{k}": v for k, v in m.mp._asdict().items()},
                  n_kf=m.n_kf, n_mp=m.n_mp, db_bow=db.bow, db_valid=db.valid)
    for k, v in tables.items():
        a = v.cpu().numpy()
        require(a.dtype == data[k].dtype and a.shape == data[k].shape
                and a.tobytes() == data[k].tobytes(), f"checkpoint: table {k} differs")
    return dict(tables=len(tables), keys=len(data.files))


def pose_gap(Ta, Tb) -> tuple:
    """(camera-centre distance m, rotation angle rad) between two Tcw (numpy)."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    c = np.clip((np.trace(Ta[:3, :3] @ Tb[:3, :3].T) - 1.0) / 2.0, -1.0, 1.0)
    return center_distance(torch.from_numpy(Ta), torch.from_numpy(Tb)), float(np.arccos(c))


def device_time(events) -> tuple:
    """(the profiler's CUDA events' device time summed, the union of their
    intervals, their count); times in ms. The union counts once what kernels
    on two streams (the tracker's and the global BA's) run at the same time."""
    dev_ms, spans = 0.0, []
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms += ev.device_time_total / 1e3
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return dev_ms, busy_us / 1e3, len(spans)


def run_checkpoint_phase(ep: dict) -> dict:
    """Save the endurance client's final map; 20 further frames of the
    original client under torch.profiler (the endurance frame's device time,
    idle share and launches); load the map into a fresh client (the same
    vocabulary, loop closing on), which must relocalize within 3 frames
    (K9, K10's PnP, K6) and track frames 1050..1059 within 0.05 m / 0.01 rad
    of the original client's poses."""
    from torch.profiler import ProfilerActivity, profile

    client, ee = ep["client"], ep["ee"]
    n0 = ee.n_frames
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "endurance_map.npz")
        t0 = time.perf_counter()
        client.save_map(path)
        out["save_s"] = time.perf_counter() - t0
        out["saved"] = same_tables(path, client.tracker.map, client.loop_closer.db)
        out["npz_mb"] = os.path.getsize(path) / 2 ** 20
        frames = [endurance_frame(ee, i) for i in range(n0, n0 + PROFILE_FRAMES)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k, (left, right) in enumerate(frames):
                client.track_stereo(left, right, (n0 + k) * 0.1)
            client.tracker.flush()
            torch.cuda.current_stream().synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_FRAMES
        client.shutdown()
        dev_ms, busy_ms, n_dev = device_time(prof.events())
        idle = 1.0 - busy_ms / PROFILE_FRAMES / wall_ms
        require(0.0 <= idle <= 1.0, f"profile: idle share {idle} from {busy_ms} ms busy")
        out["profile"] = dict(frames=PROFILE_FRAMES, wall_ms_per_frame=wall_ms,
                              device_ms_per_frame=dev_ms / PROFILE_FRAMES,
                              device_busy_ms_per_frame=busy_ms / PROFILE_FRAMES,
                              device_idle_share=idle,
                              device_launches_per_frame=n_dev / PROFILE_FRAMES,
                              port_launches=dict(kernels.LAUNCHES))
        ref_states = [x.name for x in client.tracker.frame_states][n0:n0 + CHECKPOINT_FRAMES]
        ref = [T for _, T in client.tracker.trajectory[n0:n0 + CHECKPOINT_FRAMES]]
        fresh = CorbslamClient(ee.cam, ee.cfg, sensor="stereo", client_id=1, voc=client.voc,
                               enable_loop_closing=True, run_gba=True, device="cuda")
        t0 = time.perf_counter()
        fresh.load_map(path)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["loaded"] = same_tables(path, fresh.tracker.map, fresh.loop_closer.db)
    tr = fresh.tracker
    out["after_load"] = dict(state=tr._state.name, ref_kf=tr.ref_kf,
                             ref_kf_dev=int(tr._ref_kf_dev), cursor=tr._kf_cursor_est)
    kernels.reset_launches()
    frame_ms = []
    for k in range(CHECKPOINT_FRAMES):
        left, right = frames[k]
        t1 = time.perf_counter()
        fresh.track_stereo(left, right, (n0 + k) * 0.1)
        torch.cuda.current_stream().synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    fresh.shutdown()
    out["launches"] = dict(kernels.LAUNCHES)
    states = [x.name for x in tr.frame_states]
    gaps = [pose_gap(T, ref[k]) if states[k] == "OK" else None
            for k, (_, T) in enumerate(tr.trajectory)]
    first_ok = states.index("OK") if "OK" in states else None
    out.update(states=states, ref_states=ref_states, first_ok=first_ok, frame_ms=frame_ms,
               relocalizations=tr.stats.n_relocalizations, gaps=gaps)
    print("checkpoint (before the checks): " + json.dumps(out, default=str), flush=True)
    require(first_ok is not None and first_ok <= 2 and all(x == "OK" for x in states[first_ok:]),
            f"checkpoint: no relocalization within 3 frames, or lost again ({states})")
    require(all(x == "OK" for x in ref_states), f"checkpoint: the original client lost "
            f"frames {ref_states}")
    require(all(g_ is None or (g_[0] <= 0.05 and g_[1] <= 0.01) for g_ in gaps),
            f"checkpoint: poses differ from the original client's ({gaps})")
    for k in ("vocab", "pnp", "pose_opt"):
        require(out["launches"][k] > 0, f"checkpoint: {k} was not launched")
    require(out["profile"]["device_ms_per_frame"] > 0, "endurance profile: no device time")
    return out


def run_apps_phase() -> dict:
    """The client apps on the card: run_client over 30 synthetic flagship
    frames with loop closing (the shipped vocabulary), train_vocab on three
    small synthetic worlds (SceneWorld among them) through K14's
    hierarchical path, and run_stream's publisher (a thread) and node on
    loopback for 10 frames, every wait with a deadline."""
    from corbslam_tpu_torch.apps import run_client, run_stream, train_vocab

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        traj, metrics = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "metrics.jsonl")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        c = run_client.main(["--dataset", "synthetic", "--n-frames", "30", "--device", "cuda",
                             "--out", traj, "--metrics", metrics])
        torch.cuda.synchronize()
        states = [x.name for x in c.tracker.frame_states]
        with open(metrics) as fh:
            lines = [json.loads(x) for x in fh]
        out["run_client"] = dict(s=time.perf_counter() - t0, rows=list(np.loadtxt(traj).shape),
                                 metrics_lines=len(lines), states_ok=states.count("OK"),
                                 loop_closer=c.loop_closer is not None,
                                 keyframes=c.tracker.stats.n_keyframes,
                                 launches={k: v for k, v in kernels.LAUNCHES.items() if v})
        voc_path = os.path.join(tmp, "voc.npz")
        kernels.reset_launches()
        t0 = time.perf_counter()
        voc = train_vocab.main(["--out", voc_path, "--n-words", "1024", "--n-iters", "4",
                                "--n-worlds", "3", "--frames-per-world", "2", "--device", "cuda"])
        back = vocab.load(voc_path, "cuda")
        out["train_vocab"] = dict(
            s=time.perf_counter() - t0, words=voc.n_words,
            equal=all(torch.equal(getattr(back, f), getattr(voc, f)) for f in
                      ("words", "idf", "groups", "child_idx")),
            launches={k: v for k, v in kernels.LAUNCHES.items() if v})
        sargs = argparse.Namespace(portfile=os.path.join(tmp, "port"), fps=10.0, frames=10,
                                   out="", device="cuda", idle_timeout=20.0)
        kernels.reset_launches()
        t0 = time.perf_counter()
        pub = threading.Thread(target=run_stream.run_publisher, args=(sargs,), daemon=True)
        pub.start()
        node = run_stream.run_node(sargs)
        pub.join(60)
        out["run_stream"] = dict(node, s=time.perf_counter() - t0, publisher_alive=pub.is_alive(),
                                 launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    print("apps (before the checks): " + json.dumps(out), flush=True)
    rc, tv, st = out["run_client"], out["train_vocab"], out["run_stream"]
    require(rc["rows"] == [30, 12] and rc["metrics_lines"] == 30 and rc["states_ok"] == 30
            and rc["loop_closer"], f"apps: run_client {rc}")
    require(tv["equal"] and tv["launches"].get("kmajority", 0) > 0, f"apps: train_vocab {tv}")
    require(st["frames_streamed"] == 10 and st["frames_tracked"] >= 1 and not st["publisher_alive"]
            and st["states"] == {"OK": st["frames_tracked"]}, f"apps: run_stream {st}")
    return out


def main() -> int:
    if len(sys.argv) > 1:
        raise SystemExit(f"usage: python3 chip_smoke.py (no arguments), got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(kernels.BUILD_INFO.get("log", ""))
    print(f"build: {build_s:.1f} s ({kernels.BUILD_INFO.get('path')})", flush=True)
    print("ptxas (registers, spill bytes, stack frame bytes): " + json.dumps(ptxas), flush=True)
    check_ptxas(ptxas)

    # The main paths first, so that their frame times precede every
    # profiler session of the kernel checks: the front end, tracking, then
    # the tracker with local mapping.
    phase_s = {"build": build_s}
    clock = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    dev = torch.device("cuda")
    fwd, entry_imgs = entry("cuda")
    mp = run_main_path(fwd, entry_imgs)
    print(f"front end: {mp['frames']} stereo frames p50 {mp['frame_ms_p50']:.3f} ms "
          f"p90 {mp['frame_ms_p90']:.3f} ms; valid min {min(mp['valid'])} "
          f"stereo-ok min {min(mp['stereo_ok'])}; entry valid {mp['entry_valid']} "
          f"stereo-ok {mp['entry_stereo_ok']}; launches {mp['launches']}", flush=True)
    phase("front_end")
    t0 = time.perf_counter()
    te = track_entry("cuda")
    texture_s = time.perf_counter() - t0
    tp = run_tracking_path(te, dev)
    for r in tp["rows"]:
        print(f"track frame {r['frame']:2d}: n_track {r['n_track']} used_ref {r['used_ref']} "
              f"n_local {r['n_local']} ok {r['ok']} err {r['err_m']:.4f} m "
              f"(translation {r['t_err_m']:.4f} m) "
              f"({tp['frame_ms'][r['frame'] - 1]:.2f} ms)")
    print(f"tracking: {tp['frames']} frames (texture {texture_s:.1f} s, seed "
          f"{tp['seed_points']} points, final {tp['final_keyframes']} KF / "
          f"{tp['final_points']} points); tracked frame (build + track) p50 "
          f"{tp['frame_ms_p50']:.3f} ms p90 {tp['frame_ms_p90']:.3f} ms over frames 4..20; "
          f"track-only p50 {tp['track_only_ms_p50']:.3f} ms p90 {tp['track_only_ms_p90']:.3f} ms; "
          f"max err {tp['max_err_m']:.4f} m (translation "
          f"{max(r['t_err_m'] for r in tp['rows']):.4f} m); launches {tp['launches']}", flush=True)
    phase("tracking")
    kp = run_tracker_phase()
    print(f"tracker: {BENCH_FRAMES} frames of the flagship schedule in {kp['wall_s']:.1f} s; "
          f"measured frames {BENCH_WARM}..{BENCH_FRAMES - 1} (pair-amortized, mapping stages "
          f"included) p50 {kp['frame_ms_p50']:.3f} ms p90 {kp['frame_ms_p90']:.3f} ms max "
          f"{kp['frame_ms_max']:.3f} ms (largest call {kp['call_ms_max']:.3f} ms); fps "
          f"{kp['fps']:.2f} (windows {[round(f, 2) for f in kp['fps_windows']]}, closing flushes "
          f"{[round(f, 2) for f in kp['flush_ms']]} ms); keyframes {kp['keyframes']} "
          f"({kp['valid_keyframes']} valid of {kp['keyframe_rows']} rows); points "
          f"{kp['valid_points']} valid of {kp['allocated_points']}; stages {kp['stages']}; "
          f"ATE {kp['ate_m']:.4f} m (JAX reference {JAX_SCHEDULE_ATE_M} m); "
          f"launches {kp['launches']}", flush=True)
    print("tracker frame ms: " + json.dumps([round(v, 3) for v in kp["frame_ms"]]), flush=True)
    phase("tracker")
    lp = run_loop_phase()
    print(f"loop: {lp['states_ok']} of {lp['frames']} orbit frames OK; keyframes "
          f"{lp['keyframes']}, detections {lp['detections']}, Sim3 attempts {lp['attempts']} (JAX "
          f"{JAX_LOOP['attempts']}; one K10 launch each), "
          f"loops closed {lp['loops']} (first {lp['first_loop'][0]} <-> {lp['first_loop'][1]}, "
          f"JAX yardstick {JAX_LOOP['kf_q']} <-> {JAX_LOOP['kf_c']}); relocalizations "
          f"{lp['relocalizations']} (frames after the hand-LOST one {lp['after_lost']}); aligned "
          f"frame ATE {lp['ate_m']:.4f} m (JAX {JAX_LOOP['ate_m']} m), keyframe ATE after the "
          f"orbit {lp['keyframe_ate_m']:.4f} m (just before / after the closure "
          f"{lp['keyframe_ate_around_closure_m']}, after the LOST frames "
          f"{lp['keyframe_ate_final_m']:.4f} m); frame p50 {lp['frame_ms_p50']:.3f} ms p90 "
          f"{lp['frame_ms_p90']:.3f} ms; loop stage ms p50 "
          f"{float(np.percentile(lp['loop_stage_ms'], 50)):.3f} max "
          f"{max(lp['loop_stage_ms']):.3f} over {len(lp['loop_stage_ms'])} keyframes; closure "
          f"ms {[round(v, 3) for v in lp['close_ms']]}; stages {lp['stages']}; "
          f"launches {lp['launches']}", flush=True)
    print("loop sim3_log (kf_q, kf_c, n_bow, n_inliers, n_total, ok): "
          + json.dumps(lp["sim3_log"]), flush=True)
    print("loop stage ms: " + json.dumps([round(v, 3) for v in lp["loop_stage_ms"]]), flush=True)
    phase("loop")
    fl = run_flagship_with_loop_closer(kp)
    print(f"flagship with the loop closer: ATE {fl['ate_m']:.6f} m (with an idle stage in its "
          f"place {fl['idle_stage_ate_m']:.6f}, without either {kp['ate_m']:.6f}), "
          f"keyframes {fl['keyframes']}, points {fl['valid_points']}, database rows "
          f"{fl['db_rows']} of a {fl['db_mb']:.0f} MB [2048, 32768] matrix; frame p50 "
          f"{fl['frame_ms_p50']:.3f} ms p90 {fl['frame_ms_p90']:.3f} ms (without: "
          f"{kp['frame_ms_p50']:.3f} / {kp['frame_ms_p90']:.3f}); launches {fl['launches']}",
          flush=True)
    phase("flagship_loop_closer")
    mono = run_sensor_phase("mono")
    print(f"mono: {MONO_FRAMES} frames, states {''.join(x[0] for x in mono['states'])}; "
          f"initialized at frame {mono['init_frame']} (JAX {JAX_MONO['init_frame']}) after "
          f"{mono['attempts']} two-view attempts, that frame {mono['init_ms']:.3f} ms; keyframes "
          f"{mono['keyframes']} (JAX {JAX_MONO['keyframes']}), points {mono['points']} (JAX "
          f"{JAX_MONO['points']}); similarity ATE {mono['ate_m']:.4f} m (JAX {JAX_MONO['ate_m']} "
          f"m); create_new_points ms {[round(v, 3) for v in mono['create_ms']]}; tracked "
          f"frame p50 {mono['frame_ms_p50']:.3f} ms p90 {mono['frame_ms_p90']:.3f} ms; stages "
          f"{mono['stages']}; launches {mono['launches']}", flush=True)
    print("mono frame ms: " + json.dumps([round(v, 3) for v in mono["frame_ms"]]), flush=True)
    phase("mono")
    rgbd = run_sensor_phase("rgbd")
    print(f"rgbd: {sum(x == 'OK' for x in rgbd['states'])} of {RGBD_FRAMES} frames OK; keyframes "
          f"{rgbd['keyframes']} (JAX {JAX_RGBD['keyframes']}), points {rgbd['points']} (JAX "
          f"{JAX_RGBD['points']}); ATE {rgbd['ate_m']:.5f} m (JAX {JAX_RGBD['ate_m']} m); frame "
          f"p50 {rgbd['frame_ms_p50']:.3f} ms p90 {rgbd['frame_ms_p90']:.3f} ms; stages "
          f"{rgbd['stages']}; launches {rgbd['launches']}", flush=True)
    print("rgbd frame ms: " + json.dumps([round(v, 3) for v in rgbd["frame_ms"]]), flush=True)
    phase("rgbd")
    e2e = {}
    for sensor, laps in (("stereo", False), ("stereo", True), ("mono", False)):
        ep = run_e2e_phase(sensor, laps)
        e2e[ep["run"]] = ep
        la = ep["launches"]
        print(f"e2e {ep['run']}: {ep['frames']} frames ({ep['states_ok']} OK), vocabulary of "
              f"{E2E_WORDS} words from {ep['corpus']} descriptors in {ep['train_s']:.2f} s "
              f"({ep['train_launches']} K14 launches); keyframes {ep['keyframes']}, points "
              f"{ep['points']}; loops {ep['n_loops']} (kf_q, kf_c, s) {ep['loops']}; GBA runs "
              f"started / finished / aborted {ep['gba_started']} / {ep['gba_finished']} / "
              f"{ep['gba_aborted']}; GBA chunk ms {[round(v, 3) for v in ep['gba_chunk_ms']]}; "
              f"GBA launch ms {[round(v, 3) for v in ep['gba_launch_ms']]}; closure ms "
              f"{[round(v, 3) for v in ep['close_ms']]}; frame ATE {ep['frame_ate_m']:.4f} m, "
              f"keyframe ATE {ep['keyframe_ate_m']:.4f} m (gate "
              f"{E2E_GATES[ep['run']]['kf_ate_m']} m); frame p50 {ep['frame_ms_p50']:.3f} ms "
              f"p90 {ep['frame_ms_p90']:.3f} ms max {ep['frame_ms_max']:.3f} ms; launches K14 "
              f"{la['kmajority']}, K8 local {la['ba_dense']} GBA {la['ba_dense_gba']}, K9 "
              f"{la['vocab']}, K10 {la['sim3']} / {la['pnp']}, K11 {la['pose_graph']} / "
              f"{la['covis_matrix']}; wall {ep['wall_s']:.1f} s", flush=True)
        phase(f"e2e_{ep['run']}")
    cp = run_collab_phase(kp)
    for key in ("two", "four"):
        c = cp[key]
        st = c["steps"]
        print(f"collab {c['clients']} clients x {c['frames']} frames: fusions "
              f"{c['stats']['fusions']} (JAX with 2: {JAX_COLLAB['fusions']}), attempts "
              f"{c['stats']['fusion_attempts']}, keyframes received {c['stats']['kfs_received']}; "
              f"global map {c['global_keyframes']} keyframes / {c['global_points']} points (JAX "
              f"with 2: {JAX_COLLAB['global_keyframes']} / {JAX_COLLAB['global_points']}); "
              f"alignment errors {json.dumps(c['alignment_errors'])} (JAX with 2: rot "
              f"{JAX_COLLAB['rot_err_rad']} rad, t {JAX_COLLAB['t_err_m']} m, points "
              f"{JAX_COLLAB['point_err_m']} m); setup "
              f"{c['setup_s']:.1f} s, run {c['wall_s']:.1f} s", flush=True)
        for r in c["client_rows"]:
            print(f"collab {c['clients']} client {r['cid']}: states {r['states']}, keyframes "
                  f"{r['keyframes']}, pushed {r['kfs_pushed']} KFs / {r['mps_pushed']} MPs, "
                  f"foreign {r['foreign_kfs']} KFs / {r['foreign_mps']} MPs, transM "
                  f"{r['transm']}; frame p50 {r['frame_ms_p50']:.3f} ms p90 "
                  f"{r['frame_ms_p90']:.3f} ms", flush=True)
        print(f"collab {c['clients']} server steps (host ms, event ms): {json.dumps(st)}; uplink "
              f"host ms {json.dumps(c['uplink'])}; downlink host ms {json.dumps(c['downlink'])}",
              flush=True)
        print(f"collab {c['clients']} server-path launches {json.dumps(c['server_launches'])} "
              f"(in fuse / broadcast steps {json.dumps(c['server_step_launches'])}); "
              f"transform_batch calls {c['transform_batch_calls']}, detect_overlap calls "
              f"{c['detect_overlap_calls']}", flush=True)
    fz = cp["flagship"]
    print(f"collab flagship fusion: alignment error R {fz['err_R']:.3g} t {fz['err_t_m']:.3g} m "
          f"s {fz['err_s']:.3g}; points {fz['points_before']} + {fz['points_sub2']} -> "
          f"{fz['points_after']}; client 1 received {fz['received_keyframes']} of "
          f"{fz['keyframes_sub2']} keyframes; stats {json.dumps(fz['stats'])}; GBA runs "
          f"{fz['gba_runs']}; times (host ms, event ms) {json.dumps(fz['times'])}; launches "
          f"{json.dumps({k: v for k, v in fz['launches'].items() if v})}", flush=True)
    phase("collab")
    en = run_endurance_phase()
    la = en["launches"]
    case = ("natural: " + json.dumps([c for c in en["compaction_log"] if c["gba_busy"]])
            if en["forced"] is None else "forced on the final map: " + json.dumps(en["forced"]))
    print(f"endurance: {en['endurance_frames']} frames, fps {en['endurance_fps']:.2f} over frames "
          f"100..{en['endurance_frames'] - 1} (rendering included, as the bench); frame (host "
          f"time in track_stereo) p50 {en['frame_ms_p50']:.3f} ms p90 {en['frame_ms_p90']:.3f} ms "
          f"max {en['frame_ms_max']:.3f} ms; vocabulary in {en['train_s']:.2f} s; keyframes "
          f"created {en['endurance_keyframes_created']}, live {en['endurance_keyframes_live']}; "
          f"words {en['vocab_hash']}; loops {en['endurance_loops_closed']} (JAX on the same "
          f"words {JAX_ENDURANCE_ENTRY_WORDS['loops']}) rows "
          f"{json.dumps(en['loops'])}; GBA runs started / finished / aborted "
          f"{en['gba_started']} / {en['gba_finished']} / {en['gba_aborted']}; compactions "
          f"{en['endurance_compactions']}, with a busy GBA {en['compactions_gba_busy']} "
          f"({case}); resets {en['endurance_resets']}; not OK {en['not_ok']}; relocalizations "
          f"{en['relocalizations']}; keyframe ATE {en['endurance_ate_kf']:.4f} m (JAX "
          f"{JAX_ENDURANCE_ENTRY_WORDS['ate_kf_m']} m on the same words; "
          f"the TPU record of older code, an outcome only: "
          f"{json.dumps(TPU_ENDURANCE_RECORD)}); wall {en['wall_s']:.1f} s", flush=True)
    print("endurance compactions: " + json.dumps(en["compaction_log"]), flush=True)
    bw = en["bench_words"]
    print(f"endurance on the bench's words {bw['words']}: loops {bw['endurance_loops_closed']} "
          f"(the bench's run on them {JAX_ENDURANCE_BENCH['loops']}) rows {json.dumps(bw['loops'])}; "
          f"keyframe ATE {bw['endurance_ate_kf']:.4f} m (the bench's "
          f"{JAX_ENDURANCE_BENCH['ate_kf_m']} m); keyframes created "
          f"{bw['endurance_keyframes_created']}, live {bw['endurance_keyframes_live']}; GBA runs "
          f"started / finished / aborted {bw['gba_started']} / {bw['gba_finished']} / "
          f"{bw['gba_aborted']}; compactions {bw['endurance_compactions']}; resets "
          f"{bw['endurance_resets']}; not OK "
          f"{[i for i, x in enumerate(bw['states']) if x != 'OK']}; fps "
          f"{bw['endurance_fps']:.2f}; wall {bw['wall_s']:.1f} s", flush=True)
    print("endurance launches over the run: " + json.dumps({k: v for k, v in la.items() if v})
          + f" ({sum(la.values()) / en['endurance_frames']:.2f} port launches a frame)",
          flush=True)
    phase("endurance")
    ck = run_checkpoint_phase(en)
    pf = ck["profile"]
    print(f"endurance profile, {pf['frames']} further frames: wall {pf['wall_ms_per_frame']:.3f} "
          f"ms a frame, device {pf['device_ms_per_frame']:.3f} ms a frame summed over kernels, "
          f"{pf['device_busy_ms_per_frame']:.3f} ms busy (their union), idle share "
          f"{pf['device_idle_share']:.3f}, {pf['device_launches_per_frame']:.1f} device "
          f"launches a frame; port launches {json.dumps(pf['port_launches'])}", flush=True)
    print(f"checkpoint: {ck['saved']['tables']} tables bit-equal after save and load "
          f"({ck['npz_mb']:.1f} MB npz, save {ck['save_s']:.2f} s, load {ck['load_s']:.2f} s); "
          f"after load {json.dumps(ck['after_load'])}; frames {en['endurance_frames']}.."
          f"{en['endurance_frames'] + CHECKPOINT_FRAMES - 1}: states "
          f"{ck['states']} (first OK {ck['first_ok']}, relocalizations {ck['relocalizations']}); "
          f"pose gaps to the original client (m, rad) {json.dumps(ck['gaps'])}; frame ms "
          f"{[round(v, 3) for v in ck['frame_ms']]}; launches "
          f"{json.dumps({k: v for k, v in ck['launches'].items() if v})}", flush=True)
    phase("checkpoint")
    apps = run_apps_phase()
    print(f"apps: run_client {json.dumps(apps['run_client'])}; train_vocab "
          f"{json.dumps(apps['train_vocab'])}; run_stream {json.dumps(apps['run_stream'])}",
          flush=True)
    phase("apps")

    cmp = compare_frames(mp.pop("entry_frame"),
                         frame_mod.build_frame_stereo(*entry_imgs, CAM, CFG, device="cpu"))
    print(f"front end vs CPU plain path on the entry input: {cmp}", flush=True)
    track_cmp = compare_tracking_with_cpu(te, tp)
    print(f"tracking vs CPU plain path, frames 1..{CPU_FRAMES}: {track_cmp}", flush=True)
    phase("tracking_vs_cpu")
    tracker_cmp = compare_tracker_with_cpu(kp["imgs"])
    print(f"tracker vs CPU plain path, frames 1..{CPU_PREFIX - 1} of the schedule: ok",
          flush=True)
    phase("tracker_vs_cpu")

    imgs = orb.as_images(list(entry_imgs), dev)
    prm = orb.params(CFG, imgs.shape[1], imgs.shape[2], str(dev))
    rows, kinfo = check_kernels(imgs, prm)
    print(f"K3 on the entry pair: hashes {json.dumps(kinfo['k3_hashes'])}", flush=True)
    kinfo["stereo_median"] = check_stereo_median(prm)
    kinfo["stereo_edges"] = stereo_edges(dev)
    print(f"K4 edge cases: {json.dumps(kinfo['stereo_edges'])}", flush=True)
    kinfo["small_geometry"] = check_small_geometry(dev)
    kinfo["edges"] = pose_fast_edges(dev)
    print(f"K6 / K2 edge cases: {json.dumps(kinfo['edges'])}", flush=True)
    trows, tinfo = check_tracking_kernels(te, tp.pop("check_state"), *tp["imgs"][CHECK_FRAME])
    time_rows(trows)
    kinfo["tracking"] = tinfo
    kinfo["match_edges"] = match_edges(dev)
    print(f"K5 edge cases (accepted matches): {json.dumps(kinfo['match_edges'])}", flush=True)
    phase("kernels_k1_k7")
    mrows, minfo = check_mapping_kernels(kp)
    time_rows(mrows)
    kinfo["mapping"] = minfo
    stage_times = time_stages(kp)
    phase("kernels_k7_mapping_k8")
    linfo = check_loop_kernels(lp)
    print(f"loop kernel checks (first closure {linfo['kf_q']} <-> {linfo['kf_c']}): "
          f"{json.dumps(linfo)}", flush=True)
    frows, finfo = check_full_width(fl)
    time_rows(frows)
    print(f"full-width kernel checks: {json.dumps(finfo)}", flush=True)
    finfo["pnp_edges"] = pnp_edges(dev)
    print(f"K10 PnP edge cases: {json.dumps(finfo['pnp_edges'])}", flush=True)
    finfo["pose_graph_edges"] = pose_graph_edges(dev)
    print(f"K11 edge cases: {json.dumps(finfo['pose_graph_edges'])}", flush=True)
    phase("kernels_k9_k11")
    srows, sinfo = check_sensor_kernels(mono, rgbd)
    krows, sinfo["finish_keypoints"] = check_finish_keypoints(rgbd["te"], entry_imgs)
    srows += krows
    time_rows(srows)
    print(f"sensor kernel checks: {json.dumps(sinfo)}", flush=True)
    sinfo["two_view_edges"] = two_view_edges(dev)
    print(f"K12 edge cases: {json.dumps(sinfo['two_view_edges'])}", flush=True)
    phase("kernels_k12_k13")
    erows, einfo = check_e2e_kernels(e2e["stereo"])
    for run in ("stereo", "laps"):
        einfo[f"covis_{run}"] = same_covis(e2e[run]["client"].tracker.map, f"e2e {run} map")
    einfo["km_edges"] = km_edges(dev)
    print(f"K14 edge cases: {json.dumps(einfo['km_edges'])}", flush=True)
    einfo["covis_edges"] = {k: same_covis(m, k) for k, m in covis_edge_maps(dev).items()}
    print(f"B17 edge cases: {json.dumps(einfo['covis_edges'])}", flush=True)
    print(f"e2e kernel checks (K14 training, K8 at the first GBA chunk): {json.dumps(einfo)}",
          flush=True)
    brows, binfo = check_full_width_training(te)
    print(f"full-width training checks: {json.dumps(binfo)}", flush=True)
    grows, ginfo = check_bench_gba()
    print(f"K8 at bench_gba's shape: {json.dumps(ginfo)}", flush=True)
    brows += grows
    time_rows(erows + brows)
    phase("kernels_k14_gba")
    crows, cinfo = check_collab_kernels(cp)
    time_rows(crows)
    print(f"collaboration kernel checks: {json.dumps(cinfo)}", flush=True)
    phase("kernels_collab")
    # Launches: each row's count from the main path that runs it (the front
    # end, the tracking step, the tracker's mapping stages, the e2e stereo
    # lap); K14's full-width rows and K8 at bench_gba's shape, on no path,
    # one call's count.
    launches = dict(mp["launches"], **{k: tp["launches"][k] for k in
                                       ("match_masked", "pose_opt", "local_map")},
                    **{k: kp["launches"][k] for k in ("covisibility", "ba_dense")},
                    **{k: lp["launches"][k] for k in LOOP_KERNELS},
                    **{k: mono["launches"][k] for k in MONO_KERNELS[:-1]},
                    ba_dense_gba=e2e["stereo"]["launches"]["ba_dense_gba"],
                    kmajority=e2e["stereo"]["launches"]["kmajority"],
                    **{r["name"]: r["launches"] for r in brows},
                    **{k: cp["two"]["launches"][k] for k in ("vocab_batch", "horn")})
    rows += trows + mrows + frows + srows + erows + brows + crows
    for r in rows:
        print(f"kernel {r['name']}: device ms {r['ms']:.5f} by {r['ms_by']} (host-inclusive "
              f"{r['host_ms']:.4f}) plain device ms {r['plain_ms']:.4f} by {r['plain_ms_by']} "
              f"(host-inclusive {r['plain_host_ms']:.3f}) library ms {r['library_ms']} by "
              f"{r['library_ms_by']} bound ms {r['bound'][0]:.5f} ({r['bound'][1]}) "
              f"max_abs_err {r['max_abs_err']:.3g} launches {launches[r['name']]}", flush=True)
    for name in ("covisibility", "ba_dense"):
        n = kp["launches"][name]
        print(f"tracker launches of {name}: {n} ({n / BENCH_FRAMES:.2f} per frame, "
              f"{n / kp['keyframes']:.2f} per keyframe)", flush=True)
    for name in MONO_KERNELS:
        n = mono["launches"][name]
        print(f"mono launches of {name}: {n} ({n / mono['keyframes']:.2f} per keyframe)",
              flush=True)
    for name in LOOP_KERNELS:
        n = lp["launches"][name]
        print(f"loop launches of {name}: {n} ({n / lp['keyframes']:.2f} per keyframe, "
              f"{n / max(lp['loops'], 1):.1f} per closure)", flush=True)
    print(f"stereo median case: {kinfo['stereo_median']}", flush=True)
    print(f"tracking kernel checks (frame {CHECK_FRAME}): {tinfo}", flush=True)
    print(f"mapping kernel checks: {minfo}", flush=True)
    for name, k7 in (("local_map (tracked frame)", tinfo), ("covisibility (mapping)", minfo)):
        print(f"K7 {name} launch by launch, graph ms: {json.dumps(k7['launch_ms'])} (sum "
              f"{sum(k7['launch_ms'].values()):.5f})", flush=True)
    print(f"mapping stage times (ms, final map): {json.dumps(stage_times)}", flush=True)
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}",
          flush=True)

    kernels_line = {"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
         "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for r in rows
    ]}
    tp.pop("imgs")
    tp.pop("cpu_start")
    for k in ("tracker", "imgs", "kept"):
        kp.pop(k)
        lp.pop(k)
    fl.pop("tracker")
    for d in (mono, rgbd):
        for k in ("tracker", "te", "kept"):
            d.pop(k, None)
    for d in e2e.values():
        for k in ("client", "ee", "kept"):
            d.pop(k)
    for d in cp.values():
        for k in ("k9_inputs", "horn_inputs"):
            d.pop(k)
    for k in ("client", "ee"):
        en.pop(k)
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as fh:
        json.dump(dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       build_s=build_s, ptxas=ptxas, build_log=kernels.BUILD_INFO.get("log", ""),
                       kernels=rows, kernel_check_counts=kinfo, main_path=mp,
                       vs_cpu=cmp, tracking=tp, tracking_vs_cpu=track_cmp, tracker=kp,
                       tracker_vs_cpu=tracker_cmp, stage_times=stage_times, phase_s=phase_s,
                       loop=lp, flagship_loop_closer=fl, loop_checks=linfo, full_width=finfo,
                       mono=mono, rgbd=rgbd, sensor_checks=sinfo, e2e=e2e, e2e_checks=einfo,
                       full_width_training=binfo, bench_gba=ginfo, collab=cp,
                       collab_checks=cinfo, endurance=en, checkpoint=ck, apps=apps,
                       texture_s=texture_s), fh, indent=1)
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
