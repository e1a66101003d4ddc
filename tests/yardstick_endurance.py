"""The reference's endurance run (bench.py:118-206) on a CPU, with its numbers:
the bench's endurance_* fields, plus the frame states (LOST frames and where
they were), each loop's rows as it closed, the GBA runs started / finished /
aborted, and each compaction with its frame, the keyframe cursor before and
after, and whether a global BA was running when it came.

    JAX_PLATFORMS=cpu python tests/yardstick_endurance.py [N_FRAMES] [--vocab-seed S]
        [--save-vocab PATH] [--load-vocab PATH] [--draw-seed K] [--sync-gba] [--compare N]
        [--lockstep PATH]

Run from the root of the checkout; not collected by pytest. The run repeats
bench.py's setup line for line (bench.py itself is not imported: it points
the JAX compilation cache at a directory outside the checkout). N_FRAMES
defaults to the bench's 1050; the timed region starts at frame 100, as in
the bench. `--vocab-seed` trains the vocabulary with another seed (the
bench's is 0), to see how far the outcome moves with the vocabulary's draw;
`--draw-seed K` (K > 0) moves the sensor noise's seed by 1000 K and seeds
the loop closer's RANSAC key with 1 + 1000 K (the bench's run is K = 0), so
that runs on the same room and words differ only by those draws;
`--sync-gba` runs each global BA to its end where the loop closure launches
it (the merge comes at the next frame), so that the packages' runs do not
differ by how many frames a GBA takes on their hardware; the last line
lists each GBA's launch and merge frames either way;
`--save-vocab` writes the trained vocabulary in the artifact format
(`vocab.save`) for the port to load; `--load-vocab` runs with a vocabulary
artifact in place of the trained one (chip_smoke.py writes the port's
endurance vocabulary to chiprun_out/endurance_vocab.npz), so that the two
packages' runs differ only by the noise and the RANSAC draws. The last line
is one JSON object.

With `--compare N`, frames 0..N-1 rendered by the reference go to both the
reference's client and the port's (on the CPU, the same vocabulary), and
each frame's keyframes made, loop detections, Sim3 attempts, loops closed
and last loop are printed for both, then the first frame where they part
and each side's first loop: how far the two loop closers agree when only
their RANSAC draws differ.

With `--lockstep PATH`, every keyframe the reference's loop closer takes is
replayed in the port's loop closer on the CPU from the reference's own state
(map, database, consistency groups, loop edges, the RANSAC draw of each Sim3
attempt): one JSON line a keyframe goes to PATH, and the last line gains a
`lockstep` summary of where the two parted (candidates, the candidates that
fire, each attempt's counts and verdict, the corrected poses of each closure
both make). The two loop closers then see one map, so a difference is the
loop closer's own and not the map's.
"""
import json, sys, time
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
sys.path[:0] = ["."]
from corbslam_tpu import system as system_mod
from corbslam_tpu.config import CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig
from corbslam_tpu.frontend import frame as frame_mod
from corbslam_tpu.geometry import camera, se3
from corbslam_tpu.io import synthetic
from corbslam_tpu.io import trajectory as traj_mod
from corbslam_tpu.place import vocab as vocab_mod

args = sys.argv[1:]
opt = {k: args[args.index(k) + 1] for k in ("--vocab-seed", "--save-vocab", "--load-vocab",
                                            "--compare", "--lockstep", "--draw-seed") if k in args}
pos = [a for a in args if a not in opt and a not in opt.values() and a != "--sync-gba"]
n_frames = int(pos[0]) if pos else 1050
vocab_seed = int(opt.get("--vocab-seed", 0))
cam = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
cfg = SlamConfig(
    orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
    tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
    mapping=MappingConfig(local_ba_window=8, local_ba_iters=6),
    capacity=CapacityConfig(max_keyframes=256, max_map_points=32768, max_features=512,
                            local_window_kfs=8, local_window_mps=2048),
)
world = synthetic.SceneWorld.room_with_boxes(cam, half=14.0, height=3.0, n_boxes=5, box_ring=8.0, seed=3)
step, radius = 0.05, 6.0


def gt_pose(i):
    th = step * i
    Twc = se3.compose(se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
                      se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])))
    return se3.inverse(Twc)


def cpu_model():
    with open("/proc/cpuinfo") as fh:
        return next((l.split(":", 1)[1].strip() for l in fh if l.startswith("model name")), "unknown")


t_start = time.time()
render = jax.jit(lambda T, i: world.render_stereo(T, i))
gt = [gt_pose(i) for i in range(n_frames)]
descs = []
for i in (0, 1050 // 7, 2 * 1050 // 7):
    l, _ = world.render_stereo(gt_pose(i), frame=i)
    f = frame_mod.build_frame_mono(l, cam, cfg.orb)
    descs.append(np.asarray(f.desc)[np.asarray(f.fvalid)])
voc = vocab_mod.train(jnp.asarray(np.concatenate(descs)), n_words=1024, n_iters=6, seed=vocab_seed)
if "--save-vocab" in opt:
    vocab_mod.save(voc, opt["--save-vocab"])
if "--load-vocab" in opt:
    voc = vocab_mod.load(opt["--load-vocab"])


def lockstep_hook(lc, voc, out):
    """Replays every keyframe the reference's loop closer takes in the port's
    loop closer (on the CPU) from the same state: the same map, database,
    consistency groups, loop edges and last loop, and for every Sim3 attempt
    the same RANSAC draw (the reference's key, drawn over the port's matches).
    Appends one record a keyframe to `out`: the BoW's largest difference,
    whether the candidates, the candidates that fire and each attempt's
    (n_bow, n_inliers, n_total, ok) agree, and, where both close the loop,
    how far the corrected keyframe poses and points lie apart."""
    import torch

    from corbslam_tpu.loop import loop_closing as jlc
    from corbslam_tpu.place import database as jdb
    from corbslam_tpu_torch import entry, interop
    from corbslam_tpu_torch.loop import loop_closing as plc

    torch.set_num_threads(4)
    pcam, pcfg = entry.LOOP_CAM, entry.loop_config()
    P = plc.LoopCloser(pcam, pcfg, interop.vocab_from_numpy(voc), run_gba=False)
    seen = dict(cand=None, attempts=[])
    detect, sim3 = jdb.detect_loop_candidates, jlc.compute_sim3

    def spy_detect(*a, **k):
        rows, ok = detect(*a, **k)
        seen["cand"] = [int(r) for r, o in zip(np.asarray(rows), np.asarray(ok)) if o]
        return rows, ok

    def spy_sim3(cam_, m, kf_q, kf_c, key, cfg_, fix_scale=True):
        sb = sim3(cam_, m, kf_q, kf_c, key, cfg_, fix_scale=fix_scale)
        seen["attempts"].append((int(kf_c), key, [int(sb.n_bow), int(sb.n_inliers),
                                                  int(sb.n_total), bool(sb.ok)]))
        return sb

    jdb.detect_loop_candidates, jlc.compute_sim3 = spy_detect, spy_sim3
    process = lc.process_keyframe

    def spy_process(m, kf_row):
        kf_row = int(kf_row)
        m_np = jax.tree.map(np.asarray, m)
        pre = dict(db=jax.tree.map(np.asarray, lc.db), loops=jax.tree.map(np.asarray, lc.loops),
                   groups=[(set(g.rows), g.count) for g in lc.consistent_groups],
                   last=lc.last_loop_kf, n_loops=lc.n_loops, closed=lc.stats.n_loops_closed)
        seen["cand"], seen["attempts"] = None, []
        m_out = process(m, kf_row)
        closed = lc.stats.n_loops_closed > pre["closed"]
        m_out_np = jax.tree.map(np.asarray, m_out) if closed else None
        rec = dict(frame=tr.frame_id, kf=kf_row, cand=seen["cand"],
                   attempts=[a[2] for a in seen["attempts"]], closed=closed)
        pm = interop.map_from_numpy(m_np)
        P.db = interop.db_from_numpy(pre["db"])
        P.loops = interop.loop_edges_from_numpy(pre["loops"])
        P.consistent_groups = [plc._ConsistentGroup(set(r), n) for r, n in pre["groups"]]
        P.last_loop_kf, P.n_loops = pre["last"], pre["n_loops"]
        bow = P.compute_bow(pm, kf_row, out=P.db.bow[kf_row])
        P.db.add(kf_row)
        rec["bow_err"] = float(np.abs(bow.numpy() - np.asarray(lc.db.bow[kf_row])).max())
        if seen["cand"] is not None:
            rows, ok = plc.db_mod.detect_loop_candidates(P.db, pm, kf_row, bow, k=8)
            rec["port_cand"] = [r for r, o in zip(rows.tolist(), ok.tolist()) if o]
        if seen["cand"]:
            enough = P._update_consistency(pm, seen["cand"])
            rec["fire"] = [a[0] for a in seen["attempts"]]
            rec["port_fire"] = enough
            rec["port_attempts"] = []
            for kf_c, key, _ in seen["attempts"]:
                pair_ok = plc.sim3_matches(pm, kf_row, kf_c, pcfg).pair_ok.numpy()
                probs = pair_ok.astype(np.float32)
                probs = probs / max(probs.sum(), 1.0)
                idx = jax.random.choice(key, pair_ok.shape[0], shape=(256, 3), p=jnp.asarray(probs))
                sb = plc.compute_sim3(pcam, pm, kf_row, kf_c, pcfg,
                                      sample=torch.from_numpy(np.asarray(idx, np.int32)))
                rec["port_attempts"].append([int(sb.n_bow), int(sb.n_inliers), int(sb.n_total),
                                             bool(sb.ok)])
                if closed and bool(sb.ok) and kf_c == seen["attempts"][-1][0]:
                    pm = P.close_loop(pm, kf_row, kf_c, sb)
                    v = m_out_np.kf.valid
                    dt = np.linalg.norm(pm.kf.Tcw.numpy()[v][:, :3, 3] - m_out_np.kf.Tcw[v][:, :3, 3], axis=1)
                    w = m_out_np.mp.valid
                    dp = np.linalg.norm(pm.mp.pos.numpy()[w] - m_out_np.mp.pos[w], axis=1)
                    rec["corrected_pose_dt_max_m"] = float(dt.max())
                    rec["corrected_point_dp_p50_m"] = float(np.median(dp))
                    break
        out.append(rec)
        return m_out

    lc.process_keyframe = spy_process


def lockstep_summary(recs):
    """Writes the records to the --lockstep path and returns the counts of
    keyframes where the port's loop closer parted from the reference's."""
    with open(opt["--lockstep"], "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
    det = [r for r in recs if r["cand"] is not None]
    fired = [r for r in recs if r.get("fire") is not None]
    att = [(r["kf"], a, b) for r in fired for a, b in zip(r["attempts"], r["port_attempts"])]
    closes = [r for r in recs if "corrected_pose_dt_max_m" in r]
    return dict(
        keyframes=len(recs), bow_err_max=max((r["bow_err"] for r in recs), default=0.0),
        detections=len(det), candidates_differ=[r["kf"] for r in det if r["cand"] != r["port_cand"]],
        fire_differ=[r["kf"] for r in fired if r["port_fire"][:len(r["fire"])] != r["fire"]],
        attempts=len(att), attempts_differ=[x for x in att if x[1] != x[2]],
        ok_differ=[x for x in att if x[1][3] != x[2][3]],
        closes_compared=len(closes), loops_reference=sum(r["closed"] for r in recs),
        corrected_pose_dt_max_m=max((r["corrected_pose_dt_max_m"] for r in closes), default=None))


if "--compare" in opt:
    import torch
    from corbslam_tpu_torch import entry, interop
    from corbslam_tpu_torch import system as psystem

    torch.set_num_threads(4)
    n_cmp = int(opt["--compare"])
    sides = dict(reference=(system_mod.CorbslamClient(cam, cfg, sensor="stereo", client_id=1,
                                                      voc=voc, enable_loop_closing=True,
                                                      run_gba=True), lambda a: a),
                 port=(psystem.CorbslamClient(entry.LOOP_CAM, entry.loop_config(),
                                              sensor="stereo", client_id=1,
                                              voc=interop.vocab_from_numpy(voc), device="cpu"),
                       lambda a: torch.from_numpy(np.array(a))))
    rec = {k: [] for k in sides}
    for i in range(n_cmp):
        l, r = render(gt_pose(i), i)
        for k, (c, conv) in sides.items():
            c.track_stereo(conv(l), conv(r), i * 0.1)
            st = c.loop_closer.stats
            rec[k].append((c.tracker.stats.n_keyframes, st.n_detections, st.n_sim3_attempts,
                           st.n_loops_closed, list(st.last_loop) if st.last_loop else None))
        if i % 10 == 0 or i == n_cmp - 1:
            print(f"frame {i} (keyframes, detections, attempts, loops, last loop): reference "
                  f"{rec['reference'][-1]} port {rec['port'][-1]}", flush=True)
    for c, _ in sides.values():
        c.shutdown()
    part = {name: next((i for i, (a, b) in enumerate(zip(rec["reference"], rec["port"]))
                        if a[j] != b[j]), None) for j, name in enumerate(
        ("keyframes", "detections", "attempts", "loops"))}
    first = {k: next(((i, v[4]) for i, v in enumerate(rec[k]) if v[3] > 0), None) for k in rec}
    print(json.dumps(dict(frames=n_cmp, first_frame_where_they_part=part, first_loop=first,
                          vocab_seed=vocab_seed, vocab_file=opt.get("--load-vocab"))))
    sys.exit(0)
c = system_mod.CorbslamClient(cam, cfg, sensor="stereo", client_id=1, voc=voc,
                              enable_loop_closing=True, run_gba=True)
tr, lc = c.tracker, c.loop_closer
draw_seed = int(opt.get("--draw-seed", 0))
if draw_seed:  # other sensor noise and RANSAC draws; the room and the words stay
    world._noise_seed += 1000 * draw_seed
    lc._key = jax.random.PRNGKey(1 + 1000 * draw_seed)
gba_frames = []  # [frame launched, frame merged] of each global BA run
launch_gba, merge_gba = lc.gba_runner.launch, lc.gba_runner.try_merge
lc.gba_runner.synchronous = "--sync-gba" in args


def spy_launch(m):
    gba_frames.append([tr.frame_id, None])
    return launch_gba(m)


def spy_merge(m):
    out = merge_gba(m)
    if out is not m and gba_frames:
        gba_frames[-1][1] = tr.frame_id
    return out


lc.gba_runner.launch, lc.gba_runner.try_merge = spy_launch, spy_merge
lockstep = []
if "--lockstep" in opt:
    lockstep_hook(lc, voc, lockstep)
compactions, loops = [], []
compact = tr._compact_map


def spy_compact():  # record each compaction: frame, cursor before / after, GBA busy
    before, n0 = int(tr.map.n_kf), tr.stats.n_compactions
    busy = lc.gba_runner.busy()
    compact()
    if tr.stats.n_compactions > n0:
        compactions.append(dict(frame=tr.frame_id, n_kf_before=before, n_kf_after=int(tr.map.n_kf),
                                gba_busy=busy, gba_aborted=lc.gba_runner.runs_aborted))


tr._compact_map = spy_compact
t_mark, times = None, []
for i in range(n_frames):
    if i == 100:
        tr.flush()
        t_mark = time.time()
    t0 = time.time()
    l, r = render(gt[i], i)
    n_loops = lc.stats.n_loops_closed
    c.track_stereo(l, r, timestamp=i * 0.1)
    times.append(time.time() - t0)
    if lc.stats.n_loops_closed > n_loops:
        loops.append(dict(frame=i, rows=list(lc.stats.last_loop)))
    if i % 50 == 0:
        print(f"frame {i} keyframes {tr.stats.n_keyframes} n_kf {int(tr.map.n_kf)} loops "
              f"{lc.stats.n_loops_closed} compactions {tr.stats.n_compactions} "
              f"{time.time() - t_start:.0f} s", flush=True)
c.shutdown()
dt = time.time() - (t_mark or t_start)
gtw = np.asarray([np.asarray(se3.inverse(T)) for T in gt])
m = tr.map
valid = np.asarray(m.kf.valid)
fid = np.asarray(m.kf.frame_id)[valid]
sel = fid < len(gtw)
est_kf = np.linalg.inv(np.asarray(m.kf.Tcw, np.float64)[valid][sel])
ate_kf = traj_mod.ate_rmse(est_kf, gtw[fid[sel]], align=True)
states = "".join(s.name[0] for s in tr.frame_states)
st, g = tr.stats, lc.gba_runner
print(json.dumps(dict(
    endurance_frames=n_frames, endurance_fps=round((n_frames - 100) / dt, 2) if t_mark else None,
    endurance_keyframes_live=int(valid.sum()), endurance_keyframes_created=st.n_keyframes,
    endurance_loops_closed=lc.stats.n_loops_closed, endurance_gba_runs=g.runs_finished,
    endurance_gba_aborts=g.runs_aborted, endurance_compactions=st.n_compactions,
    endurance_resets=st.n_resets, endurance_ate_kf=round(float(ate_kf), 4),
    gba_started=g.runs_started, gba_frames=gba_frames, sync_gba=g.synchronous, loops=loops,
    loop_edges=np.stack([np.asarray(lc.loops.i), np.asarray(lc.loops.j)], 1)[np.asarray(lc.loops.valid)].tolist(),
    compactions=compactions, n_lost=states.count("L"), lost_frames=[i for i, s in enumerate(states) if s == "L"],
    not_ok_after_0=sum(s != "O" for s in states[1:]), frame_p50_s=float(np.median(times[100:])),
    vocab_seed=vocab_seed, vocab_file=opt.get("--load-vocab"), draw_seed=draw_seed, cpu=cpu_model(), seconds=round(time.time() - t_start, 1),
    lockstep=lockstep_summary(lockstep) if "--lockstep" in opt else None)), flush=True)
