"""Trajectory files (TUM format) and the absolute trajectory error (numpy).

Copies of ``nislam_tpu.io.trajectory`` (a test holds them equal).  A TUM
line is ``time x y z qx qy qz qw``; 2D poses are written with z = 0 and a
yaw-only quaternion.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def pose2d_to_tum_line(t: float, pose: Sequence[float]) -> str:
    """``time x y z qx qy qz qw`` with z = 0 and a yaw-only quaternion."""
    x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
    qz = math.sin(th / 2.0)
    qw = math.cos(th / 2.0)
    return f"{t:.6f} {x:.6f} {y:.6f} 0.000000 0.000000 0.000000 {qz:.6f} {qw:.6f}"


def write_tum(path: str, times: Sequence[float], poses: np.ndarray) -> str:
    with open(path, "w") as f:
        for t, pose in zip(times, poses):
            f.write(pose2d_to_tum_line(t, pose) + "\n")
    return path


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """→ (times (N,), poses (N, 3) as (x, y, yaw)); ``#`` lines are skipped."""
    times: List[float] = []
    poses: List[Tuple[float, float, float]] = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            t, x, y, _z, qx, qy, qz, qw = [float(v) for v in ln.split()][:8]
            yaw = math.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
            times.append(t)
            poses.append((x, y, yaw))
    return np.asarray(times), np.asarray(poses)


def associate(times_a: np.ndarray, times_b: np.ndarray, max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association, greedy unique matches within ``max_dt``."""
    ia: List[int] = []
    ib: List[int] = []
    used = set()
    for i in np.argsort(times_a):
        j = int(np.argmin(np.abs(times_b - times_a[i])))
        if abs(times_b[j] - times_a[i]) <= max_dt and j not in used:
            ia.append(i)
            ib.append(j)
            used.add(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_2d(src: np.ndarray, dst: np.ndarray, with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares alignment dst ≈ s·R·src + t → (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[1, 1] = -1.0
    r = u @ s_mat @ vt
    s = float((d * np.diag(s_mat)).sum() / ((xs * xs).sum() / len(src))) if with_scale else 1.0
    t = mu_d - s * r @ mu_s
    return r, t, s


def ate_rmse(
    est_times: np.ndarray, est_xy: np.ndarray, gt_times: np.ndarray, gt_xy: np.ndarray,
    *, max_dt: float = 0.02, align: bool = True, with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE (m) after association and alignment."""
    ia, ib = associate(est_times, gt_times, max_dt)
    if len(ia) < 2:
        raise ValueError("fewer than 2 associated trajectory points")
    e = np.asarray(est_xy)[ia, :2]
    g = np.asarray(gt_xy)[ib, :2]
    if align:
        r, t, s = umeyama_2d(e, g, with_scale)
        e = (s * (r @ e.T)).T + t
    d = e - g
    return float(np.sqrt((d * d).sum(axis=1).mean()))
