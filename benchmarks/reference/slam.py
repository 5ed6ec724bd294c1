"""Plain NI-SLAM over one sequence: the reference that ``correct`` holds
the program to.

A frozen, single-lane, eager copy of the deferred-solve engine's
semantics, written as a loop over frames with a host branch per frame:

- tracking: each frame registered against the current keyframe
  (:class:`~benchmarks.reference.kcc.KCC`), the pose chain in the image
  plane, the camera and the robot frame, and the keyframe decision
  (travel, turn, or a response inside the band);
- the map: keyframes in insertion order (spectra and cached filters kept
  in the configuration's bank type), odometry edges, the spatial-hash
  cell at insertion;
- the loop search of a stored keyframe: the 3×3 cell neighbourhood, the
  frame-gap and travel gates, the nearest ``max_candidates`` by a stable
  sort, all registered in loop mode (or ranked at 1/s resolution first,
  ``coarse_scale`` s > 1), the best accepted if it clears both
  thresholds, then held as a pending match;
- the deferred trigger after every chunk (and at ``finalize``): with two
  or more pending matches, their loop edges added and the pose graph
  solved by Levenberg–Marquardt over the live keyframes (dense normal
  equations, slot 0 pinned), the tracking chain re-derived from the
  optimized pose of the current keyframe.

It takes the rendered frames and the configuration and nothing that the
program made.  The map never evicts here: a run that would fill the bank
raises (each cell's capacity holds every keyframe its sequences store).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks.reference.kcc import (
    KCC, Precision, impulse_spectrum, irfft2, register, rotated_spectrum, spectral_crop,
)


# ---------------------------------------------------------------------------
# SE(2)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor((theta + math.pi) / two_pi)


def rotation2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def relative_pose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    xy = torch.einsum("...ji,...j->...i", rotation2d(p1[..., 2]), p2[..., :2] - p1[..., :2])
    return torch.cat([xy, normalize_angle(p2[..., 2] - p1[..., 2])[..., None]], dim=-1)


def absolute_pose(p1: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    xy = p1[..., :2] + torch.einsum("...ij,...j->...i", rotation2d(p1[..., 2]), rel[..., :2])
    return torch.cat([xy, normalize_angle(p1[..., 2] + rel[..., 2])[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# The camera's frames: image plane (u, v, θ) px; camera (u/fx, v/fy, θ);
# robot extrinsics @ (h·x, h·y, θ)


class Camera:
    def __init__(self, cam: dict, device):
        if any(cam["distortion"]):
            raise ValueError("the reference takes a camera without distortion")
        fx, cx, fy, cy = cam["intrinsics"]
        f32 = dict(dtype=torch.float32, device=device)
        self.fx, self.fy = torch.tensor(fx, **f32), torch.tensor(fy, **f32)
        self.h = cam["height"]
        ext = np.asarray(cam["extrinsics"], np.float32).reshape(3, 3)
        self.ext = torch.from_numpy(ext).to(device)
        self.ext_inv = torch.from_numpy(np.linalg.inv(ext)).to(device)
        self.bias = torch.tensor([cam["image_width"] * 0.5 - cx, cam["image_height"] * 0.5 - cy], **f32)

    def plane_to_camera(self, p):
        return torch.stack([p[..., 0] / self.fx, p[..., 1] / self.fy, p[..., 2]], dim=-1)

    def camera_to_plane(self, p):
        return torch.stack([p[..., 0] * self.fx, p[..., 1] * self.fy, p[..., 2]], dim=-1)

    def camera_to_robot(self, p):
        v = torch.stack([self.h * p[..., 0], self.h * p[..., 1], p[..., 2]], dim=-1)
        return torch.einsum("ij,...j->...i", self.ext, v)

    def robot_to_camera(self, p):
        v = torch.einsum("ij,...j->...i", self.ext_inv, p)
        return torch.stack([v[..., 0] / self.h, v[..., 1] / self.h, v[..., 2]], dim=-1)

    def plane_to_robot(self, p):
        return self.camera_to_robot(self.plane_to_camera(p))

    def center_to_principal(self, p):
        """Correlation shifts are about the image centre, pose chains about
        the principal point."""
        th = p[..., 2]
        corr = self.bias - torch.einsum("...ij,j->...i", rotation2d(th), self.bias)
        return torch.cat([p[..., :2] + corr, th[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Levenberg–Marquardt over the live keyframes


def _residuals(x: torch.Tensor, f, t, T) -> torch.Tensor:
    pa, pb = x[f], x[t]
    r_xy = torch.einsum("eji,ej->ei", rotation2d(pa[:, 2]), pb[:, :2] - pa[:, :2]) - T[:, :2]
    r_th = normalize_angle(pb[:, 2] - pa[:, 2] - T[:, 2])
    return torch.cat([r_xy, r_th[:, None]], dim=-1)


def _cost(x, f, t, T) -> torch.Tensor:
    r = _residuals(x, f, t, T)
    return 0.5 * torch.sum(r * r)


def solve_pose_graph(poses: torch.Tensor, f: torch.Tensor, t: torch.Tensor, T: torch.Tensor, *,
                     max_iterations: int, mu_init: float = 1e-4, mu_factor: float = 10.0,
                     mu_min: float = 1e-9, mu_max: float = 1e8, rtol: float = 1e-6) -> torch.Tensor:
    """LM over the (n, 3) robot-frame poses of the live keyframes, slot 0
    pinned, edges ``f → t`` measuring ``T`` (robot frame, unit
    information) → the optimized poses (angles wrapped)."""
    n = poses.shape[0]
    dev = poses.device
    x = torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=-1)
    free = torch.ones(3 * n, dtype=torch.float32, device=dev)
    free[:3] = 0.0
    f, t = f.long(), t.long()
    cost = _cost(x, f, t, T)
    mu = np.float32(mu_init)
    it = 0
    active = mu < np.float32(mu_max)
    while active and it < max_iterations:
        pa, pb = x[f], x[t]
        th = pa[:, 2]
        c, s = torch.cos(th), torch.sin(th)
        dp = pb[:, :2] - pa[:, :2]
        z, o = torch.zeros_like(c), torch.ones_like(c)
        ja = torch.stack([torch.stack([-c, -s, -s * dp[:, 0] + c * dp[:, 1]], -1),
                          torch.stack([s, -c, -c * dp[:, 0] - s * dp[:, 1]], -1),
                          torch.stack([z, z, -o], -1)], -2)
        jb = torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1), torch.stack([z, z, o], -1)], -2)
        r = _residuals(x, f, t, T)
        blocks = torch.zeros((n, n, 3, 3), dtype=torch.float32, device=dev)
        for a, ja_, b, jb_ in ((f, ja, f, ja), (f, ja, t, jb), (t, jb, f, ja), (t, jb, t, jb)):
            blocks.view(n * n, 3, 3).index_add_(0, a * n + b, torch.einsum("eji,ejk->eik", ja_, jb_))
        h = blocks.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
        g = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        g.index_add_(0, f, torch.einsum("eji,ej->ei", ja, r))
        g.index_add_(0, t, torch.einsum("eji,ej->ei", jb, r))
        g = g.reshape(-1) * free
        h = h * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        hd = h + float(mu) * torch.diag(torch.diagonal(h))
        chol, status = torch.linalg.cholesky_ex(hd)
        delta = torch.cholesky_solve(-g[:, None], chol)[:, 0]
        ok = bool(status == 0) and bool(torch.all(torch.isfinite(delta)))
        x_new = x + (delta.reshape(n, 3) if ok else 0.0)
        x_new = torch.cat([x_new[:, :2], normalize_angle(x_new[:, 2:3])], dim=-1)
        new_cost = _cost(x_new, f, t, T)
        accept = ok and bool(new_cost < cost)
        small = bool((cost - new_cost) / torch.clamp(cost, min=1e-30) < rtol)
        if accept:
            x, cost = x_new, new_cost
            mu = max(np.float32(mu / np.float32(mu_factor)), np.float32(mu_min))
        else:
            mu = min(np.float32(mu * np.float32(mu_factor)), np.float32(mu_max))
        active = not (accept and small) and mu < np.float32(mu_max)
        it += 1
    return x


# ---------------------------------------------------------------------------
# The engine


class ReferenceSlam:
    """The reference over one sequence at a time: ``run(frames, chunk)``."""

    def __init__(self, config: dict, device, precision: str = "f32", find_loops: Optional[bool] = None):
        self.config = config
        self.device = torch.device(device)
        self.p = Precision(precision)
        self.kcc = KCC(config["cf"], self.device, self.p)
        self.cam = Camera(config["camera"], self.device)
        lc = dict(config["loop_closure"])
        if find_loops is not None:
            lc["to_find_loop"] = find_loops
        self.lc = lc
        self.kfs = config["keyframe_selection"]
        self.map = config["map"]
        self.bank_dtype = torch.bfloat16 if self.map["bank_dtype"] == "bf16" else torch.float32

    # -- the bank's storage type ------------------------------------------------

    def _store(self, x: torch.Tensor) -> torch.Tensor:
        return torch.view_as_real(x).to(self.bank_dtype)

    @staticmethod
    def _load(x: torch.Tensor) -> torch.Tensor:
        return torch.view_as_complex(x.float().contiguous())

    # -- one sequence -----------------------------------------------------------

    def run(self, frames: torch.Tensor, chunk: int) -> Dict[str, np.ndarray]:
        """``frames`` (N, H, W) float32 in [0, 1] → per-frame outputs
        (``tracked``, ``inserted``, ``loop_found``, ``keyframe_slot``,
        ``loop_slot``, ``pose`` (N, 3), ``response`` (N, 3)), ``solves``
        and the keyframes after ``finalize`` (``keyframes``: rows of x, y,
        heading and the frame that stored each)."""
        self._reset()
        rows: List[tuple] = []
        for start in range(0, frames.shape[0], chunk):
            imgs = frames[start:start + chunk].to(self.device, torch.float32)
            fft, polar = self.kcc.features(imgs)
            for i in range(imgs.shape[0]):
                rows.append(self._frame(imgs[i], fft[i], polar[i]))
            self._trigger()
        self._trigger()  # finalize: one more trigger, then the pending matches dropped
        self.pending.clear()
        out = {k: np.array([r[j] for r in rows]) for j, k in enumerate(
            ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot"))}
        out["pose"] = torch.stack([r[5] for r in rows]).cpu().numpy()
        out["response"] = torch.stack([r[6] for r in rows]).cpu().numpy()
        out["keyframes"] = torch.cat([self.poses[: self.count].double(),
                                      self.frame_ids[: self.count, None].double()], dim=1).cpu().numpy()
        out["solves"] = np.array(self.solves)
        return out

    def _reset(self) -> None:
        k = self.map["keyframe_capacity"]
        dev, f32 = self.device, torch.float32
        self.count = 0
        self.poses = torch.zeros((k, 3), dtype=f32, device=dev)
        self.grid = torch.zeros((k, 2), dtype=torch.int32, device=dev)
        self.frame_ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
        self.distances = torch.zeros((k,), dtype=f32, device=dev)
        self.spectra: List[tuple] = []  # per slot: (fft, polar, filt, filt_polar) in the bank's type
        self.edges: List[tuple] = []  # (from, to, T camera frame)
        self.pending: List[tuple] = []  # (loop slot, current slot, rel pose principal frame)
        self.frame_id = 0
        self.solves = 0
        self.chain = None

    def _insert(self, fft, polar, fi, fp, pose, distance) -> int:
        slot = self.count
        if slot >= self.map["keyframe_capacity"]:
            raise RuntimeError("the reference's map is full: it does not evict")
        cached = self.map["cache_filters"]
        self.spectra.append((self._store(fft), self._store(polar),
                             self._store(fi) if cached else None, self._store(fp) if cached else None))
        self.poses[slot] = pose
        self.grid[slot] = torch.trunc(pose[:2] / self.map["grid_scale"]).to(torch.int32)
        self.frame_ids[slot] = self.frame_id
        self.distances[slot] = distance
        self.count += 1
        return slot

    def _frame(self, img, fft, polar) -> tuple:
        cam, kfs, dev = self.cam, self.kfs, self.device
        if self.chain is None:  # the first frame: the first keyframe, at the origin
            zero = torch.zeros(3, dtype=torch.float32, device=dev)
            robot0 = cam.plane_to_robot(zero)
            fi, fp = self.kcc.filters(fft, polar)
            slot = self._insert(fft, polar, fi, fp, robot0, torch.zeros((), device=dev))
            self.chain = dict(fft=fft, polar=polar, fi=fi, fp=fp, cf=zero, cf_real=cam.plane_to_camera(zero),
                              pose=robot0, slot=slot, distance=torch.zeros((), device=dev))
            self.frame_id += 1
            return (True, True, False, slot, -1, robot0, torch.full((3,), torch.inf, device=dev))
        ch = self.chain
        rel, resp = self.kcc.pose(ch["fft"], img, ch["polar"], polar, large_rotation=False,
                                  filters=(ch["fi"], ch["fp"]))
        cur_cf = absolute_pose(ch["cf"], cam.center_to_principal(rel))
        cur_real = cam.plane_to_camera(cur_cf)
        rel_robot = relative_pose(cam.plane_to_robot(ch["cf"]), cam.plane_to_robot(cur_cf))
        cur_pose = absolute_pose(ch["pose"], rel_robot)
        da = cam.plane_to_camera(cur_cf - ch["cf"])
        d = torch.linalg.vector_norm(da[:2])
        a = torch.abs(da[2])
        lower_rot = kfs["lower_rotation_response_thr"]
        upper_rot = kfs["upper_rotation_response_thr"]
        good = (resp[0] > kfs["lower_response_thr"]) & (resp[2] > lower_rot)
        band = ((resp[0] > kfs["lower_response_thr"]) & (resp[0] < kfs["upper_response_thr"])) | (
            (resp[2] > lower_rot) & (resp[2] < upper_rot))
        insert = good & ((d > kfs["max_distance"]) | (a > kfs["max_angle"]) | band)
        good_h, insert_h = torch.stack([good, insert]).tolist()
        new_distance = ch["distance"] + torch.where(insert, d, 0.0)
        keyframe_slot, loop_found, loop_slot = -1, False, -1
        if insert_h:
            fi, fp = self.kcc.filters(fft, polar)
            slot = self._insert(fft, polar, fi, fp, cur_pose, new_distance)
            self.edges.append((ch["slot"], slot, relative_pose(ch["cf_real"], cur_real)))
            keyframe_slot = slot
            if self.lc["to_find_loop"]:
                found, best, rel_loop = self._search(img, fft, polar, cur_pose, new_distance)
                if found:
                    loop_found, loop_slot = True, best
                    if len(self.pending) < self.lc["pending_capacity"]:
                        self.pending.append((best, slot, cam.center_to_principal(rel_loop)))
            self.chain = dict(fft=fft, polar=polar, fi=fi, fp=fp, cf=cur_cf, cf_real=cur_real, pose=cur_pose,
                              slot=slot, distance=new_distance)
        else:
            ch["distance"] = new_distance
        self.frame_id += 1
        return (bool(good_h), bool(insert_h), loop_found, keyframe_slot, loop_slot, cur_pose, resp)

    def _candidates(self, prior_pose, distance):
        """The gates and the nearest ``max_candidates`` slots by a stable
        descending sort → (slots, picked)."""
        lc, k = self.lc, self.map["keyframe_capacity"]
        valid = torch.arange(k, device=self.device) < self.count
        cur = torch.trunc(prior_pose[:2] / self.map["grid_scale"]).to(torch.int32)
        m = torch.all(torch.abs(self.grid - cur[None, :]) <= 1, dim=-1) & valid
        if lc["frame_gap_thr"] > 0:
            m = m & (torch.abs(self.frame_id - self.frame_ids) >= lc["frame_gap_thr"])
        if lc["distance_thr"] > 0:
            m = m & (torch.abs(distance - self.distances) >= lc["distance_thr"])
        d2 = torch.sum((self.poses[:, :2] - prior_pose[:2]) ** 2, dim=-1)
        score = torch.where(m, -d2, -torch.inf)
        slots = torch.sort(score, descending=True, stable=True).indices[: min(lc["max_candidates"], k)]
        return slots.tolist(), m[slots]

    def _gather(self, slots, part: int, shape) -> torch.Tensor:
        """Part ``part`` of each slot's spectra (zeros for an empty slot),
        read in float32."""
        zero = torch.zeros(shape + (2,), dtype=self.bank_dtype, device=self.device)
        return self._load(torch.stack([self.spectra[s][part] if s < self.count else zero for s in slots]))

    def _search(self, img, fft, polar, prior_pose, distance):
        """The loop search of the keyframe just stored → (found, loop slot,
        relative pose about the image centre)."""
        kcc, lc = self.kcc, self.lc
        slots, picked = self._candidates(prior_pose, distance)
        h, w = kcc.ishape
        ispec, pspec = (h, w // 2 + 1), (kcc.pshape[0], kcc.pshape[1] // 2 + 1)
        zf = self._gather(slots, 0, ispec)
        zp = self._gather(slots, 1, pspec)
        cached = self.map["cache_filters"]
        s = lc["coarse_scale"]
        if s > 1:
            fpol = self._gather(slots, 3, pspec) if cached else None
            degree, info_rot = kcc.rotation(zp, polar[None], fpol)
            cshape = (h // s, w // s)
            cimg = self.p.q(irfft2(spectral_crop(fft, kcc.ishape, s), cshape))
            rfc = rotated_spectrum(cimg[None], -degree, self.p)
            rot2 = torch.stack([rfc, torch.conj(rfc)], dim=-3)
            zc = spectral_crop(zf, kcc.ishape, s)
            _, cpsr = register(zc[:, None], rot2, impulse_spectrum(*cshape, self.device), cshape, kcc.cf, self.p)
            score = 2.0 * s * torch.amax(cpsr, dim=-1) + info_rot
            best = int(torch.argmax(torch.where(picked, score, -torch.inf)))
            filters = (self._gather([slots[best]], 2, ispec)[0], fpol[best]) if cached else None
            pose, info = kcc.pose(zf[best], img, zp[best], polar, large_rotation=True, filters=filters,
                                  rotation=(degree[best], info_rot[best]))
        else:
            filters = (self._gather(slots, 2, ispec), self._gather(slots, 3, pspec)) if cached else None
            poses, infos = kcc.pose(zf, img[None], zp, polar[None], large_rotation=True, filters=filters)
            best = int(torch.argmax(torch.where(picked, infos.sum(dim=-1), -torch.inf)))
            pose, info = poses[best], infos[best]
        found = bool(picked.any() & (info[0] > lc["position_response_thr"]) & (info[2] > lc["angle_response_thr"]))
        return found, slots[best], pose

    def _trigger(self) -> None:
        """The deferred trigger: with two or more pending matches, their
        loop edges added, the graph solved, the pending matches cleared and
        the chain re-derived from the current keyframe's optimized pose."""
        if len(self.pending) < 2:
            return
        cam = self.cam
        for loop_slot, cur_slot, rel in self.pending:
            self.edges.append((loop_slot, cur_slot, cam.plane_to_camera(rel)))
        self.pending.clear()
        f = torch.tensor([e[0] for e in self.edges], device=self.device)
        t = torch.tensor([e[1] for e in self.edges], device=self.device)
        T = cam.camera_to_robot(torch.stack([e[2] for e in self.edges]))
        n = self.count
        self.poses[:n] = solve_pose_graph(self.poses[:n], f, t, T,
                                          max_iterations=self.config["optimizer"]["max_iterations"])
        self.solves += 1
        opt = self.poses[self.chain["slot"]]
        real = cam.robot_to_camera(opt)
        self.chain.update(pose=opt, cf_real=real, cf=cam.camera_to_plane(real))
