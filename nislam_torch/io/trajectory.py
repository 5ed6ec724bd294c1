"""Absolute trajectory error (numpy).

Copies of ``associate``, ``umeyama_2d`` and ``ate_rmse`` from
``nislam_tpu.io.trajectory`` (a test holds them equal).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


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
