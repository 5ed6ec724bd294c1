"""2D pose-graph optimizer: Levenberg–Marquardt over dense normal equations.

Counterpart of ``nislam_tpu.core.pose_graph``: whitened SE(2) residuals,
angles wrapped on the circle, base slot 0 pinned, dead slots and edges
masked, optional joint metric scale.  The ``lax.while_loop`` becomes a
Python loop with one host read of (accept, converged) per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from nislam_torch.core.se2 import normalize_angle, rotation2d


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_iterations: int = 100
    mu_init: float = 1e-4
    mu_factor: float = 10.0
    mu_min: float = 1e-9
    mu_max: float = 1e8
    rtol: float = 1e-6  # relative cost-decrease stop
    estimate_scale: bool = False


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor  # (K, 3) initial values
    pose_mask: torch.Tensor  # (K,) bool live slots
    from_slot: torch.Tensor  # (E,) i32
    to_slot: torch.Tensor  # (E,) i32
    T: torch.Tensor  # (E, 3) measured relative pose (robot frame)
    sqrt_info: torch.Tensor  # (E, 3, 3) lower Cholesky factor of the information
    edge_mask: torch.Tensor  # (E,) bool


def sqrt_information(info: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the information matrix.  ``cholesky_ex``:
    like JAX, a non-PD input does not raise (the caller masks it)."""
    return torch.linalg.cholesky_ex(info).L


def residuals(poses: torch.Tensor, prob: PoseGraphProblem, scale) -> torch.Tensor:
    """(E, 3) whitened residuals; masked edges give zero."""
    f, t = prob.from_slot.long(), prob.to_slot.long()
    pa = poses[f]
    pb = poses[t]
    rat = rotation2d(pa[:, 2])
    dp = pb[:, :2] - pa[:, :2]
    r_xy = torch.einsum("eji,ej->ei", rat, dp) - scale * prob.T[:, :2]
    r_th = normalize_angle(pb[:, 2] - pa[:, 2] - prob.T[:, 2])
    r = torch.cat([r_xy, r_th[:, None]], dim=-1)
    r = torch.einsum("eij,ej->ei", prob.sqrt_info, r)
    return torch.where(prob.edge_mask[:, None], r, 0.0)


def _edge_jacobians(poses: torch.Tensor, prob: PoseGraphProblem, scale):
    """Whitened analytic Jacobians (Ja, Jb, Js) per edge."""
    f, t = prob.from_slot.long(), prob.to_slot.long()
    pa = poses[f]
    pb = poses[t]
    th = pa[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    dp = pb[:, :2] - pa[:, :2]
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    drt_dp = torch.stack([-s * dp[:, 0] + c * dp[:, 1], -c * dp[:, 0] - s * dp[:, 1]], dim=-1)
    ja = torch.stack(
        [
            torch.stack([-c, -s, drt_dp[:, 0]], dim=-1),
            torch.stack([s, -c, drt_dp[:, 1]], dim=-1),
            torch.stack([zeros, zeros, -ones], dim=-1),
        ],
        dim=-2,
    )
    jb = torch.stack(
        [
            torch.stack([c, s, zeros], dim=-1),
            torch.stack([-s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    js = torch.cat([-prob.T[:, :2], zeros[:, None]], dim=-1)
    ja = torch.einsum("eij,ejk->eik", prob.sqrt_info, ja)
    jb = torch.einsum("eij,ejk->eik", prob.sqrt_info, jb)
    js = torch.einsum("eij,ej->ei", prob.sqrt_info, js)
    m = prob.edge_mask[:, None].to(ja.dtype)
    return ja * m[..., None], jb * m[..., None], js * m


def _assemble_normal_eqs(poses, prob: PoseGraphProblem, scale, est_scale: bool):
    """Dense H = JᵀJ (N, N), g = Jᵀr (N,) and the cost, N = 3K (+1 with
    scale).  The (K, 3, K, 3) block scatter-add is an accumulating
    ``index_put_`` on a (K, K, 3, 3) tensor, permuted at the end."""
    k = poses.shape[0]
    r = residuals(poses, prob, scale)
    cost = 0.5 * torch.sum(r * r)
    ja, jb, js = _edge_jacobians(poses, prob, scale)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    ga = torch.einsum("eji,ej->ei", ja, r)
    gb = torch.einsum("eji,ej->ei", jb, r)

    f, t = prob.from_slot.long(), prob.to_slot.long()
    h4 = torch.zeros((k, k, 3, 3), dtype=torch.float32, device=poses.device)
    h4.index_put_((f, f), haa, accumulate=True)
    h4.index_put_((f, t), hab, accumulate=True)
    h4.index_put_((t, f), hab.transpose(-1, -2), accumulate=True)
    h4.index_put_((t, t), hbb, accumulate=True)
    g = torch.zeros((k, 3), dtype=torch.float32, device=poses.device)
    g.index_put_((f,), ga, accumulate=True)
    g.index_put_((t,), gb, accumulate=True)

    h = h4.permute(0, 2, 1, 3).reshape(3 * k, 3 * k)
    g = g.reshape(3 * k)
    if est_scale:
        hs_col = torch.zeros((k, 3), dtype=torch.float32, device=poses.device)
        hs_col.index_put_((f,), torch.einsum("eij,ei->ej", ja, js), accumulate=True)
        hs_col.index_put_((t,), torch.einsum("eij,ei->ej", jb, js), accumulate=True)
        hs_col = hs_col.reshape(3 * k)
        hss = torch.sum(js * js)
        gs = torch.sum(js * r)
        h = torch.cat(
            [torch.cat([h, hs_col[:, None]], dim=1),
             torch.cat([hs_col[None, :], hss.reshape(1, 1)], dim=1)],
            dim=0,
        )
        g = torch.cat([g, gs[None]])
    return h, g, cost


def _pin(h: torch.Tensor, g: torch.Tensor, free: torch.Tensor):
    """Clamp non-free variables: unit diagonal rows/cols, zero gradient."""
    fm = free.to(h.dtype)
    h = h * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    return h, g * fm


def solve_pose_graph(
    prob: PoseGraphProblem, cfg: SolverConfig = SolverConfig(), *,
    init_scale: float = 1.0, scale_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM solve → ``(poses, scale, final_cost)``."""
    dev = prob.poses.device
    k = prob.poses.shape[0]
    free = prob.pose_mask.repeat_interleave(3).clone()
    free[:3] = False  # pin base slot 0
    if cfg.estimate_scale:
        free = torch.cat([free, torch.tensor([bool(scale_free)], device=dev)])

    def pack(poses, scale):
        x = poses.reshape(3 * k)
        if cfg.estimate_scale:
            x = torch.cat([x, torch.as_tensor(scale, dtype=torch.float32, device=dev).reshape(1)])
        return x

    def unpack(x):
        poses = x[: 3 * k].reshape(k, 3)
        scale = x[3 * k] if cfg.estimate_scale else torch.ones((), device=dev)
        return poses, scale

    def norm_poses(poses):
        return torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=-1)

    def cost_of(x):
        poses, scale = unpack(x)
        r = residuals(poses, prob, scale)
        return 0.5 * torch.sum(r * r)

    x = pack(norm_poses(prob.poses), init_scale)
    cost = cost_of(x)
    # The damping schedule runs on the host in float32, as JAX carries it.
    mu = np.float32(cfg.mu_init)
    factor = np.float32(cfg.mu_factor)
    for _ in range(cfg.max_iterations):
        if not mu < np.float32(cfg.mu_max):
            break
        poses, scale = unpack(x)
        h, g, _ = _assemble_normal_eqs(poses, prob, scale, cfg.estimate_scale)
        h, g = _pin(h, g, free)
        hd = h + float(mu) * torch.diag(torch.diag(h))
        # cholesky_ex, not cholesky: a non-PD matrix must reject the step
        # (as JAX's NaN factor does), not raise.
        chol, status = torch.linalg.cholesky_ex(hd)
        delta = torch.cholesky_solve(-g[:, None], chol)[:, 0]
        solve_ok = (status == 0) & torch.all(torch.isfinite(delta))
        x_new = x + torch.where(solve_ok, delta, 0.0)
        p_new, s_new = unpack(x_new)
        x_new = pack(norm_poses(p_new), s_new)
        new_cost = cost_of(x_new)
        accept = solve_ok & (new_cost < cost)
        rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        accept_h, small = torch.stack([accept, rel_drop < cfg.rtol]).tolist()
        if accept_h:
            x, cost = x_new, new_cost
            mu = max(mu / factor, np.float32(cfg.mu_min))
            if small:
                break
        else:
            mu = min(mu * factor, np.float32(cfg.mu_max))
    poses, scale = unpack(x)
    poses = torch.where(prob.pose_mask[:, None], poses, prob.poses)
    return poses, scale, cost
