"""The port's endurance run (`entry.endurance_entry` / `run_endurance`, the
bench's 1050 frames) on a CUDA card once per vocabulary and draw: the
vocabulary the entry trains (seed 0, K14), the same corpus trained with
seeds 1..N, and each vocabulary artifact given with --vocab (for example
the reference's, from `tests/yardstick_endurance.py --save-vocab PATH`).
Draw k = 0 is the entry's own (sensor noise and RANSAC draws as in
`chip_smoke.py`); with `--draws D`, draws k = 1..D-1 move the sensor noise's
seed by 1000 k and seed the loop closer's RANSAC generator with 1 + 1000 k,
as `tests/yardstick_endurance.py --draw-seed k` does in the reference, so
that runs on the same room and words differ only by those draws.

    python3 tests/endurance_vocab_seeds.py [N] [--vocab PATH ...] [--draws D] [--sync-gba]
        (N defaults to 3, D to 1)

`--sync-gba` runs each global BA to its end where the loop closure launches
it, as `tests/yardstick_endurance.py --sync-gba` does; each run lists its
GBAs' launch and merge frames either way.

Run from the root of the checkout. One JSON object a run: the vocabulary,
the hash of its words and idf (`kernel_times.digest`), the draw, the loops
(query row, candidate row, frame), detections, Sim3 attempts, keyframe ATE,
keyframes created and live, LOST frames, compactions (and those that met a
running global BA), GBA runs started / finished / aborted, fps and the
frame p50 (ms); and a last line with each vocabulary's loop counts and ATEs
over its draws.
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from corbslam_tpu_torch import entry, kernels  # noqa: E402
from corbslam_tpu_torch.kernel_times import digest  # noqa: E402
from corbslam_tpu_torch.place import vocab  # noqa: E402
from corbslam_tpu_torch.system import CorbslamClient  # noqa: E402


def log_gba_frames(client) -> list:
    """[frame launched, frame merged] of each of the client's global BA runs,
    filled in as the run goes."""
    tr, g = client.tracker, client.loop_closer.gba_runner
    frames, launch, merge = [], g.launch, g.try_merge

    def logged_launch(m):
        frames.append([tr.frame_id, None])
        return launch(m)

    def logged_merge(m):
        out = merge(m)
        if out is not m and frames:
            frames[-1][1] = tr.frame_id
        return out

    g.launch, g.try_merge = logged_launch, logged_merge
    return frames


def main() -> int:
    args = sys.argv[1:]
    opts = {"--vocab": [], "--draws": []}
    sync_gba = "--sync-gba" in args
    args = [a for a in args if a != "--sync-gba"]
    rest, i = [], 0
    while i < len(args):
        if args[i] in opts:
            opts[args[i]].append(args[i + 1])
            i += 2
        else:
            rest.append(args[i])
            i += 1
    n = int(rest[0]) if rest else 3
    draws = int(opts["--draws"][-1]) if opts["--draws"] else 1
    if not torch.cuda.is_available():
        raise SystemExit("endurance_vocab_seeds: torch.cuda.is_available() is False")
    kernels.lib()
    client, ee = entry.endurance_entry("cuda")
    words = [("seed 0 (the entry's)", client.voc)]
    words += [(f"seed {s}", vocab.train(ee.corpus, n_words=entry.E2E_WORDS,
                                        n_iters=entry.E2E_TRAIN_ITERS, seed=s))
              for s in range(1, n + 1)]
    words += [(p, vocab.load(p, "cuda")) for p in opts["--vocab"]]
    noise_seed, summary = ee.world._noise_seed, {}
    for name, voc in words:
        for k in range(draws):
            c = client if (k == 0 and voc is client.voc) else CorbslamClient(
                ee.cam, ee.cfg, sensor="stereo", client_id=1, voc=voc,
                enable_loop_closing=True, run_gba=True, device="cuda")
            ee.world._noise_seed = noise_seed + 1000 * k
            if k:
                c.loop_closer.generator.manual_seed(1 + 1000 * k)
            gba_frames = log_gba_frames(c)
            c.loop_closer.gba_runner.synchronous = sync_gba
            t0 = time.perf_counter()
            out = entry.run_endurance(c, ee)
            st = c.loop_closer.stats
            summary.setdefault(name, []).append((out["endurance_loops_closed"],
                                                 round(out["endurance_ate_kf"], 4)))
            print(json.dumps(dict(
                vocabulary=name, words=digest(voc.words, voc.idf), draw=k,
                seconds=round(time.perf_counter() - t0, 1),
                loops=[lp["rows"] + [lp["frame"]] for lp in out["loops"]],
                n_loops=out["endurance_loops_closed"], detections=st.n_detections,
                attempts=st.n_sim3_attempts, ate_kf_m=out["endurance_ate_kf"],
                created=out["endurance_keyframes_created"], live=out["endurance_keyframes_live"],
                lost=[i for i, x in enumerate(out["states"]) if x != "OK"],
                compactions=[out["endurance_compactions"], out["compactions_gba_busy"]],
                gba=[out["gba_started"], out["gba_finished"], out["gba_aborted"]],
                gba_frames=gba_frames, sync_gba=sync_gba,
                fps=out["endurance_fps"], frame_ms_p50=float(np.median(out["frame_s"])) * 1e3)),
                flush=True)
    ee.world._noise_seed = noise_seed
    print(json.dumps(dict(loops_and_ate_by_draw=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
