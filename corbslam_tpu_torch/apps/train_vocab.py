"""Offline vocabulary training: the ORBvoc.txt-equivalent artifact (port of
`corbslam_tpu/apps/train_vocab.py`).

The reference ships a pretrained DBoW2 vocabulary loaded at startup
(Examples pass Vocabulary/ORBvoc.txt as argv[1]). This tool produces the
reusable equivalent: a k-majority vocabulary (place/vocab.py) trained from
many rendered views of varied synthetic worlds (`PlanarWorld`,
`MultiPlaneWorld.room`, `SceneWorld.room_with_boxes`), or from an image
directory, saved in the reference's artifact format (`vocab.save`) and
loaded by run_client / run_collab `--vocab`. The worlds render, the ORB
front end extracts and the trainer runs (`train_hierarchical`, or with
`--flat` `train_chunked` and `build_tree`, all on kernel K14) on `--device`
(default cuda).

Usage:
  python -m corbslam_tpu_torch.apps.train_vocab --out voc32k.npz --n-words 32768
  python -m corbslam_tpu_torch.apps.train_vocab --images /data/seq/image_0 --out voc.npz
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def collect_synthetic_descriptors(n_worlds: int, frames_per_world: int, seed: int = 0,
                                  device="cuda", verbose: bool = True) -> torch.Tensor:
    """Render varied worlds (planar + structured) from many viewpoints and
    pool the valid ORB descriptors ([N, 32] u8 on `device`). The worlds,
    cameras and views are the reference's, drawn from the same
    `np.random.default_rng(seed)` sequence."""
    from .. import kernels
    from ..config import KITTI_STEREO, OrbConfig
    from ..frontend import frame as frame_mod
    from ..geometry import camera as cam_mod
    from ..geometry import se3
    from ..io import synthetic

    dev = kernels.resolve_device(device)
    # Three camera classes: BRIEF statistics depend on pixels per scene
    # texel, so the corpus covers the QVGA consumers as well as KITTI / VGA.
    cameras = [
        (cam_mod.Intrinsics.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                                   bf=386.1448, width=1241, height=376), KITTI_STEREO.orb),
        (cam_mod.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
                                   width=320, height=240),
         OrbConfig(n_features=512, n_levels=4, cell_size=12)),
        (cam_mod.Intrinsics.create(fx=480.0, fy=480.0, cx=320.0, cy=240.0, bf=240.0,
                                   width=640, height=480),
         OrbConfig(n_features=1024, n_levels=6, cell_size=16)),
    ]
    rng = np.random.default_rng(seed)
    descs = []
    for w in range(n_worlds):
        # QVGA on every odd world, KITTI / VGA rotating on the evens.
        cam, orb = cameras[1] if w % 2 else cameras[(w // 2) % len(cameras)]
        if w % 3 == 0:
            world = synthetic.PlanarWorld(cam, texture_size=4096,
                                          plane_dist=float(rng.uniform(6.0, 20.0)),
                                          texture_scale=float(rng.uniform(30.0, 90.0)),
                                          seed=seed * 101 + w, device=dev)
            render = lambda T, i, world=world: world.render(T)  # noqa: E731
        elif w % 3 == 1:
            room = synthetic.MultiPlaneWorld.room(
                cam, half=float(rng.uniform(8.0, 18.0)), height=float(rng.uniform(2.0, 4.0)),
                noise_std=float(rng.uniform(1.0, 4.0)), seed=seed * 77 + w, device=dev)
            render = lambda T, i, room=room: room.render(T, frame=i)  # noqa: E731
        else:
            # Occluded, shaded scene: box silhouettes, shading and exposure
            # drift give corner and edge statistics the other worlds lack.
            scene = synthetic.SceneWorld.room_with_boxes(
                cam, half=float(rng.uniform(8.0, 18.0)), height=float(rng.uniform(2.0, 4.0)),
                n_boxes=int(rng.integers(3, 8)), box_ring=float(rng.uniform(5.0, 10.0)),
                texture_scale=float(rng.uniform(40.0, 80.0)), seed=seed * 53 + w, device=dev)
            render = lambda T, i, scene=scene: scene.render(T, frame=i)  # noqa: E731
        for i in range(frames_per_world):
            if w % 3 == 0:  # planar world: jittered fronto-ish views
                xi = np.zeros(6, np.float32)
                xi[:3] = rng.uniform(-1.5, 1.5, 3)
                xi[3:] = rng.uniform(-0.15, 0.15, 3)
                T = se3.exp(torch.from_numpy(xi))
            else:  # rooms: outward orbit views at varied radius and height
                th = rng.uniform(0, 2 * np.pi)
                r = rng.uniform(2.0, 8.5)
                Twc = se3.compose(
                    se3.exp(torch.tensor([0, 0, 0, rng.uniform(-0.1, 0.1), th,
                                          rng.uniform(-0.1, 0.1)], dtype=torch.float32)),
                    se3.from_Rt(torch.eye(3), torch.tensor(
                        [rng.uniform(-1, 1), rng.uniform(-0.5, 0.5), -r], dtype=torch.float32)))
                T = se3.inverse(Twc)
            f = frame_mod.build_frame_mono(render(T, i), cam, orb, device=dev)
            d = f.desc[f.fvalid]
            descs.append(d)
            if verbose:
                print(f"  world {w} frame {i}: {d.shape[0]} descriptors", flush=True)
    return torch.cat(descs).contiguous()


def collect_image_dir_descriptors(path: str, limit: int = 0, device="cuda") -> torch.Tensor:
    """The valid ORB descriptors of every image of a directory (on disk
    already; nothing is downloaded), [N, 32] u8 on `device`."""
    from .. import kernels
    from ..config import KITTI_STEREO
    from ..frontend import frame as frame_mod
    from ..geometry import camera as cam_mod
    from ..io import datasets

    dev = kernels.resolve_device(device)
    names = sorted(os.listdir(path))
    if limit:
        names = names[:limit]
    descs, cam = [], None
    for n in names:
        img = datasets._imread_gray(os.path.join(path, n))
        if cam is None:
            h, w = img.shape
            cam = cam_mod.Intrinsics.create(fx=0.9 * w, fy=0.9 * w, cx=w / 2, cy=h / 2,
                                            width=w, height=h)
        f = frame_mod.build_frame_mono(torch.from_numpy(img), cam, KITTI_STEREO.orb, device=dev)
        descs.append(f.desc[f.fvalid])
    return torch.cat(descs).contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--n-words", type=int, default=32768)
    ap.add_argument("--n-iters", type=int, default=8)
    ap.add_argument("--images", default=None, help="directory of images (else synthetic worlds)")
    ap.add_argument("--n-worlds", type=int, default=6)
    ap.add_argument("--frames-per-world", type=int, default=24)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flat", action="store_true", help="flat k-majority + post-hoc tree")
    ap.add_argument("--save-corpus", default=None,
                    help="dump the rendered descriptor corpus to this npz")
    ap.add_argument("--corpus", default=None, help="train from a previously saved corpus npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import kernels
    from ..place import vocab as vocab_mod

    dev = kernels.resolve_device(args.device)
    t0 = time.time()
    if args.corpus:
        desc = torch.from_numpy(np.load(args.corpus)["desc"]).to(dev)
    elif args.images:
        desc = collect_image_dir_descriptors(args.images, args.limit, dev)
    else:
        desc = collect_synthetic_descriptors(args.n_worlds, args.frames_per_world, args.seed, dev)
    print(f"corpus: {desc.shape[0]} descriptors ({time.time() - t0:.1f}s)", flush=True)
    if args.save_corpus:
        np.savez_compressed(args.save_corpus, desc=desc.cpu().numpy())
        print(f"corpus saved -> {args.save_corpus}", flush=True)

    t0 = time.time()
    if args.flat:
        voc = vocab_mod.train_chunked(desc, n_words=args.n_words, n_iters=args.n_iters,
                                      seed=args.seed)
        print(f"trained {voc.n_words}-word flat vocabulary ({time.time() - t0:.1f}s)", flush=True)
        t0 = time.time()
        voc = vocab_mod.build_tree(voc, n_groups=max(64, args.n_words // 32))
        print(f"built post-hoc descent tree ({time.time() - t0:.1f}s)", flush=True)
    else:
        # DBoW2's construction (TemplatedVocabulary::create): words trained
        # inside their group's corpus partition, so the tree's greedy
        # descent is self-consistent.
        B = 32
        G = max(1, args.n_words // B)
        voc = vocab_mod.train_hierarchical(desc, n_groups=G, words_per_group=B,
                                           n_iters=args.n_iters, seed=args.seed)
        print(f"trained hierarchical {G}x{B}={voc.n_words}-word vocabulary "
              f"({time.time() - t0:.1f}s)", flush=True)
    vocab_mod.save(voc, args.out)
    print(f"saved -> {args.out}")
    return voc


if __name__ == "__main__":
    main()
