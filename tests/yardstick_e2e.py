"""The reference's e2e loop fixtures (tests/test_loop_e2e.py) on a CPU, with
their numbers: frame states, keyframes, loops (rows and Sim3 scale), GBA
runs started / finished / aborted, frame and keyframe ATE (similarity-aligned
for mono). With --port the port's CorbslamClient then runs on the CPU on the
same JAX-rendered frames and vocabulary, with the reference's own two-view
samples replayed, so that the two runs differ only by floating-point order.
With --trace PATH each run's per-frame record (state, Tcw, the tracked and
local-map inlier counts of a pipelined frame, keyframes made so far) goes to
PATH as JSON, and with --port the port's per-frame difference from the
reference is printed: camera centre (m), rotation (rad), inlier counts.
With --control the reference runs a second time with every bootstrap point
of the two-view result moved by one f32 rounding (a relative 2**-23 up or
down, drawn from a fixed seed), and its per-frame difference from the first
run is printed the same way: how far rounding alone carries the run apart.

    JAX_PLATFORMS=cpu python tests/yardstick_e2e.py stereo|laps|mono CLIENT [--port] [--control] [--trace PATH]

Run from the root of the checkout. CLIENT seeds the client's draws (the
fixtures use 1).
"""
import json, sys, jax, jax.numpy as jnp, numpy as np, torch
jax.config.update("jax_platforms", "cpu")
sys.path[:0] = [".", "tests"]
import test_loop_e2e as T
from corbslam_tpu import system
from corbslam_tpu.frontend import frame
from corbslam_tpu.geometry import se3
from corbslam_tpu.io import trajectory
from corbslam_tpu.place import vocab
from corbslam_tpu.solvers import initializer as jinit
run, client, port, control = sys.argv[1], int(sys.argv[2]), "--port" in sys.argv, "--control" in sys.argv
trace = sys.argv[sys.argv.index("--trace") + 1] if "--trace" in sys.argv else None
step, n = (0.1, 158) if run == "laps" else (T.STEP, T.N_FRAMES)
def pose(i):
    return se3.inverse(se3.compose(se3.exp(jnp.asarray([0, 0, 0, 0, step * i, 0], jnp.float32)),
                                   se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -T.RADIUS]))))
world = T.synthetic.MultiPlaneWorld.room(T.CAM, half=14.0, height=3.0, noise_std=3.0, seed=2)
frames = [tuple(np.asarray(x) for x in world.render_stereo(pose(i), frame=i)) for i in range(n)]
descs = [np.asarray(f.desc)[np.asarray(f.fvalid)] for f in
         (frame.build_frame_mono(jnp.asarray(frames[i][0]), T.CAM, T.CFG.orb) for i in (0, n // 3, 2 * n // 3))]
voc = vocab.train(jnp.asarray(np.concatenate(descs)), n_words=1024, n_iters=6)
samples, draw, ulp = [], jinit.initialize_two_view, [None]
def spy(cam, x1, x2, valid, key, **kw):  # record the two-view sample the reference draws
    p = valid.astype(jnp.float32)
    samples.append(np.asarray(jax.random.choice(key, x1.shape[0], (256, 8), p=p / jnp.maximum(p.sum(), 1.0)), np.int32))
    out = draw(cam, x1, x2, valid, key, **kw)
    if ulp[0] is not None:  # the control run: one rounding on every bootstrap point
        out = out._replace(X=out.X * (1.0 + 2.0 ** -23 * ulp[0].choice([-1.0, 1.0], out.X.shape)).astype(np.float32))
    return out
jinit.initialize_two_view = spy
mono = run == "mono"
def drive(c, conv):
    c.loop_closer.gba_runner.synchronous = run != "laps"
    tr, inl = c.tracker, {}
    retire = tr._retire
    def spy_retire(out, ts, fid, *handle):  # the pipelined frame's summary: n_track, n_local
        retire(out, ts, fid, *handle)
        s = np.asarray(out.summary)
        inl[fid] = (int(s[0]), int(s[2]))
    tr._retire = spy_retire
    kfs = []
    for i, (l, r) in enumerate(frames):
        c.track_monocular(conv(l), i * 0.1) if mono else c.track_stereo(conv(l), conv(r), i * 0.1)
        kfs.append(tr.stats.n_keyframes)
    c.shutdown()
    m, st = tr.map, c.loop_closer.stats
    v = np.asarray(m.kf.valid)
    fid = np.asarray(m.kf.frame_id)[v]
    gt = np.asarray([np.linalg.inv(np.asarray(pose(i), np.float64)) for i in range(n)])
    est = np.asarray([np.linalg.inv(np.asarray(T_, np.float64)) for _, T_ in tr.trajectory])
    kf = np.linalg.inv(np.asarray(m.kf.Tcw, np.float64)[v][fid < n])
    states = "".join(s.name[0] for s in tr.frame_states)
    print(dict(states=states, first_lost=states.find("L"), keyframes=tr.stats.n_keyframes,
               loops=st.n_loops_closed, last_loop=st.last_loop,
               s=np.asarray(c.loop_closer.loops.s)[np.asarray(c.loop_closer.loops.valid)].tolist(),
               gba=(c.loop_closer.gba_runner.runs_started, c.loop_closer.gba_runner.runs_finished,
                    c.loop_closer.gba_runner.runs_aborted),
               frame_ate=trajectory.ate_rmse(est, gt, align=True, with_scale=mono),
               kf_ate=trajectory.ate_rmse(kf, gt[fid[fid < n]], align=True, with_scale=mono)), flush=True)
    return [dict(state=states[i], Tcw=np.asarray(T_, np.float64).tolist(), inliers=inl.get(i),
                 keyframes=kfs[i]) for i, (_, T_) in enumerate(tr.trajectory)]
def jax_client():
    return system.CorbslamClient(T.CAM, T.CFG, sensor="mono" if mono else "stereo", client_id=client, voc=voc)
def differences(name):
    print(f"{name} against the reference: frame state keyframes centre_m rot_rad n_track n_local (ref/{name})")
    for i, (a, b) in enumerate(zip(runs["reference"], runs[name])):
        Ta, Tb = np.asarray(a["Tcw"]), np.asarray(b["Tcw"])
        ca, cb = -Ta[:3, :3].T @ Ta[:3, 3], -Tb[:3, :3].T @ Tb[:3, 3]
        M = Ta[:3, :3] @ Tb[:3, :3].T  # its antisymmetric part: rounding off orthonormality cancels
        w = 0.5 * np.asarray([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
        ia, ib = a["inliers"] or (None, None), b["inliers"] or (None, None)
        print(f"{i:3d} {a['state']}/{b['state']} {a['keyframes']:3d}/{b['keyframes']:3d} "
              f"{np.linalg.norm(ca - cb):.3e} {np.arctan2(np.linalg.norm(w), (np.trace(M) - 1) / 2):.3e} "
              f"{ia[0]}/{ib[0]} {ia[1]}/{ib[1]}")
runs = dict(reference=drive(jax_client(), jnp.asarray))
ref_samples = list(samples)  # the reference's draws, for the port
if control:
    ulp[0] = np.random.default_rng(0)
    runs["control"] = drive(jax_client(), jnp.asarray)
    ulp[0] = None
    differences("control")
if port:  # the port on the CPU: the same frames, vocabulary and two-view samples
    from corbslam_tpu_torch import entry, interop, system as psystem
    from corbslam_tpu_torch.frontend import tracking as ptracking
    pdraw, queue = ptracking.initializer.initialize_two_view, list(ref_samples)
    ptracking.initializer.initialize_two_view = lambda cam, x1, x2, valid, generator=None, **kw: pdraw(
        cam, x1, x2, valid, sample=torch.from_numpy(queue.pop(0)), **kw)
    runs["port"] = drive(psystem.CorbslamClient(entry.LOOP_CAM, entry.loop_config(), sensor="mono" if mono else "stereo",
                                                client_id=client, voc=interop.vocab_from_numpy(voc), device="cpu"),
                         lambda a: torch.from_numpy(a.copy()))
    differences("port")
if trace:
    with open(trace, "w") as fh:
        json.dump(runs, fh)
