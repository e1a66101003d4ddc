"""Trajectory export and accuracy evaluation (ATE), numpy only (a copy of
`corbslam_tpu/io/trajectory.py`: `save_kitti`, `save_tum`,
`umeyama_alignment`, `ate_rmse`).

Covers the reference's `SaveTrajectoryTUM/KITTI` outputs (System.cc:254,
312, 350) and the ATE evaluation the tracker's quality gates use.
"""

from __future__ import annotations

import numpy as np


def save_kitti(path: str, poses_Twc: np.ndarray):
    """poses [T, 3, 4] or [T, 4, 4] -> KITTI 12-number rows."""
    with open(path, "w") as f:
        for T in poses_Twc:
            row = np.asarray(T)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_tum(path: str, timestamps, poses_Twc, quat_fn):
    """TUM format: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_Twc):
            T = np.asarray(T)
            q = quat_fn(T[:3, :3])  # (w, x, y, z)
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment src->dst, both [N, 3].
    Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_Twc: np.ndarray, gt_Twc: np.ndarray, align: bool = True, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE over camera centers, after optional
    rigid (or similarity, for monocular) alignment — the standard KITTI/TUM
    ATE metric used as the reference's accuracy yardstick (BASELINE.md)."""
    p_est = np.asarray([np.asarray(T)[:3, 3] for T in est_Twc])
    p_gt = np.asarray([np.asarray(T)[:3, 3] for T in gt_Twc])
    if p_est.shape != p_gt.shape:
        raise ValueError(f"ate_rmse: {p_est.shape} estimated vs {p_gt.shape} true centres")
    if align:
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt((err**2).mean()))
