"""Offline map renderer — the Viewer/MapDrawer/ServerMapView capability (port
of `corbslam_tpu/apps/render_map.py`; matplotlib is imported only when a
map is drawn, and a live map's tensors are read with `.cpu()`).

The reference draws the live map with Pangolin (client
corbslam_client/src/MapDrawer.cc:38 DrawMapPoints, :85 DrawKeyFrames incl.
frusta, :155 covisibility graph; src/Viewer.cc run loop; server
corbslam_server/src/ServerMapView.cpp:34). SURVEY.md §2.1 replaces the
OpenGL thread with offline artifact dumps: this module renders a map
snapshot (the `CorbslamClient.save_map` npz, or a live MapState) to PNG —
top-down and side orthographic views with landmarks, keyframe frusta,
covisibility edges, and the keyframe trajectory, colored per client for
fused/global maps (ServerMapView draws exactly that global view).

    python -m corbslam_tpu_torch.apps.render_map map.npz -o map.png
"""

from __future__ import annotations

import argparse

import numpy as np

from .frame_drawer import host


def _covis_edges(kf_mp_idx, kf_fvalid, kf_valid, min_shared: int = 30,
                 max_kfs: int = 512):
    """[E, 2] keyframe row pairs sharing >= min_shared landmarks
    (GetCovisiblesByWeight / the essential-graph edge set)."""
    rows = np.nonzero(kf_valid)[0][:max_kfs]
    if len(rows) < 2:
        return np.zeros((0, 2), np.int64)
    M = int(kf_mp_idx.max()) + 2
    B = np.zeros((len(rows), M), np.int8)
    for i, r in enumerate(rows):
        idx = kf_mp_idx[r][kf_fvalid[r] & (kf_mp_idx[r] >= 0)]
        B[i, idx] = 1
    W = B @ B.T
    np.fill_diagonal(W, 0)
    a, b = np.nonzero(np.triu(W >= min_shared))
    return np.stack([rows[a], rows[b]], -1)


def _frustum_pts(Twc, scale=0.6):
    """Pyramid wireframe of one camera in world coords: [5, 3]."""
    c = Twc[:3, 3]
    R = Twc[:3, :3]
    w, h, z = 0.6 * scale, 0.35 * scale, 0.8 * scale
    corners = np.array([[-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]])
    return c, (R @ corners.T).T + c


def render_map(
    kf_Tcw, kf_valid, kf_client, mp_pos, mp_valid, mp_client,
    out_path: str,
    kf_mp_idx=None, kf_fvalid=None,
    title: str = "corbslam_tpu_torch map",
    draw_covis: bool = True,
):
    """Render one map to `out_path` (PNG): XZ top-down + XY side views."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kf_rows = np.nonzero(kf_valid)[0]
    Twc = np.linalg.inv(kf_Tcw[kf_rows]) if len(kf_rows) else np.zeros((0, 4, 4))
    centers = Twc[:, :3, 3] if len(kf_rows) else np.zeros((0, 3))
    pts = mp_pos[mp_valid]
    pclients = mp_client[mp_valid]
    kclients = kf_client[kf_rows]

    cmap = plt.get_cmap("tab10")
    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    for ax, (ix, iy, xl, yl) in zip(
        axes, [(0, 2, "x [m]", "z [m]"), (0, 1, "x [m]", "y [m]")]
    ):
        if len(pts):
            ax.scatter(pts[:, ix], pts[:, iy], s=0.5,
                       c=[cmap(int(c) % 10) for c in pclients], alpha=0.35,
                       linewidths=0)
        # Covisibility edges.
        if draw_covis and kf_mp_idx is not None and len(kf_rows) >= 2:
            edges = _covis_edges(kf_mp_idx, kf_fvalid, kf_valid)
            inv = {r: i for i, r in enumerate(kf_rows)}
            for a, b in edges:
                ca, cb = centers[inv[a]], centers[inv[b]]
                ax.plot([ca[ix], cb[ix]], [ca[iy], cb[iy]],
                        color="0.65", lw=0.4, alpha=0.6, zorder=1)
        # Keyframe frusta + trajectory polyline per client.
        for cl in np.unique(kclients) if len(kclients) else []:
            sel = kclients == cl
            ax.plot(centers[sel][:, ix], centers[sel][:, iy],
                    color=cmap(int(cl) % 10), lw=1.2, zorder=3)
        for i in range(len(kf_rows)):
            c, corners = _frustum_pts(Twc[i])
            col = cmap(int(kclients[i]) % 10)
            for k in range(4):
                ax.plot([c[ix], corners[k][ix]], [c[iy], corners[k][iy]],
                        color=col, lw=0.5, alpha=0.8, zorder=2)
            loop = corners[[0, 1, 2, 3, 0]]
            ax.plot(loop[:, ix], loop[:, iy], color=col, lw=0.5, alpha=0.8,
                    zorder=2)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
        ax.grid(True, lw=0.3, alpha=0.5)
    n_cl = len(np.unique(kclients)) if len(kclients) else 0
    fig.suptitle(f"{title} — {len(kf_rows)} keyframes, {len(pts)} landmarks"
                 + (f", {n_cl} clients" if n_cl > 1 else ""))
    fig.tight_layout()
    if hasattr(out_path, "write"):  # file-like (the live viewer's buffer)
        fig.savefig(out_path, dpi=130, format="png")
    else:
        fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def render_mapstate(m, out_path: str, **kw):
    """Render a live MapState (client map or server global map)."""
    return render_map(
        host(m.kf.Tcw), host(m.kf.valid), host(m.kf.client),
        host(m.mp.pos), host(m.mp.valid), host(m.mp.client),
        out_path,
        kf_mp_idx=host(m.kf.mp_idx), kf_fvalid=host(m.kf.fvalid),
        **kw,
    )


def render_npz(path: str, out_path: str, **kw):
    """Render a CorbslamClient.save_map checkpoint."""
    d = np.load(path)
    return render_map(
        d["kf_Tcw"], d["kf_valid"], d["kf_client"],
        d["mp_pos"], d["mp_valid"], d["mp_client"],
        out_path, kf_mp_idx=d["kf_mp_idx"], kf_fvalid=d["kf_fvalid"], **kw,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("map_npz", help="CorbslamClient.save_map checkpoint")
    ap.add_argument("-o", "--out", default="map.png")
    ap.add_argument("--title", default="corbslam_tpu_torch map")
    ap.add_argument("--no-covis", action="store_true")
    args = ap.parse_args(argv)
    render_npz(args.map_npz, args.out, title=args.title,
               draw_covis=not args.no_covis)
    print(f"[render_map] wrote {args.out}")


if __name__ == "__main__":
    main()
