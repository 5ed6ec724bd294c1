"""2D pose-graph optimizer: Levenberg–Marquardt over dense normal equations.

Counterpart of ``nislam_tpu.core.pose_graph``: whitened SE(2) residuals,
angles wrapped on the circle, base slot 0 pinned, dead slots and edges
masked, optional joint metric scale.  The ``lax.while_loop`` becomes a
Python loop with one host read of (accept, converged) per iteration.
:func:`solve_pose_graph_lanes` solves a stack of problems in one such
loop, as JAX's batch engine vmaps the solve: one batched Cholesky and one
(R, 2) read per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.se2 import normalize_angle, rotation2d
from nislam_torch.ops.scatter_add import ScatterPlan, index_add_ordered, spread_masked


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


class NormalEqPlan(NamedTuple):
    """The scatters of :func:`_assemble_normal_eqs`, which depend only on
    the edge set: made once per solve, used at every iteration."""

    h: ScatterPlan  # rows f·K+f, f·K+t, t·K+f, t·K+t of the (K·K, 9) blocks
    g: ScatterPlan  # rows f, t of a (K, 3) vector


def normal_eq_plan(prob: PoseGraphProblem) -> NormalEqPlan:
    """A dead edge's blocks are exact zeros (its Jacobians are masked),
    so its rows are spread (:func:`spread_masked`) rather than all left at
    slot 0's."""
    k = prob.poses.shape[0]
    f, t = prob.from_slot.long(), prob.to_slot.long()
    live = prob.edge_mask
    return NormalEqPlan(
        h=ScatterPlan.of(spread_masked(torch.cat([f * k + f, f * k + t, t * k + f, t * k + t]),
                                       live.repeat(4), k * k)),
        g=ScatterPlan.of(spread_masked(torch.cat([f, t]), live.repeat(2), k)))


def _assemble_normal_eqs(poses, prob: PoseGraphProblem, scale, est_scale: bool,
                         plan: NormalEqPlan | None = None):
    """Dense H = JᵀJ (N, N), g = Jᵀr (N,) and the cost, N = 3K (+1 with
    scale).  The (K, 3, K, 3) block scatter-add is one fixed-order
    :func:`index_add_ordered` of the four edge blocks into the rows of a
    (K·K, 9) tensor, permuted at the end; ``plan`` (made from ``prob`` if
    None) holds its sorted keys."""
    k = poses.shape[0]
    e = prob.from_slot.shape[0]
    plan = normal_eq_plan(prob) if plan is None else plan
    r = residuals(poses, prob, scale)
    cost = 0.5 * torch.sum(r * r)
    ja, jb, js = _edge_jacobians(poses, prob, scale)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    ga = torch.einsum("eji,ej->ei", ja, r)
    gb = torch.einsum("eji,ej->ei", jb, r)

    def vec_sum(va, vb):
        out = torch.zeros((k, 3), dtype=torch.float32, device=poses.device)
        return index_add_ordered(out, plan.g, torch.cat([va, vb])).reshape(3 * k)

    h4 = torch.zeros((k * k, 9), dtype=torch.float32, device=poses.device)
    blocks = torch.cat([haa, hab, hab.transpose(-1, -2), hbb]).reshape(4 * e, 9)
    index_add_ordered(h4, plan.h, blocks)
    h = h4.view(k, k, 3, 3).permute(0, 2, 1, 3).reshape(3 * k, 3 * k)
    g = vec_sum(ga, gb)
    if est_scale:
        hs_col = vec_sum(torch.einsum("eij,ei->ej", ja, js), torch.einsum("eij,ei->ej", jb, js))
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
    plan = normal_eq_plan(prob)
    # The damping schedule runs on the host in float32, as JAX carries it.
    mu = np.float32(cfg.mu_init)
    factor = np.float32(cfg.mu_factor)
    for _ in range(cfg.max_iterations):
        if not mu < np.float32(cfg.mu_max):
            break
        poses, scale = unpack(x)
        h, g, _ = _assemble_normal_eqs(poses, prob, scale, cfg.estimate_scale, plan)
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


def _lane_plan(prob: PoseGraphProblem) -> NormalEqPlan:
    """:func:`normal_eq_plan` of each lane of a stacked problem, lane r's
    rows offset by r·K·K (H) and r·K (g): the lanes' keys stay disjoint,
    and each lane's sums keep the order that its own plan gives them."""
    r, k = prob.poses.shape[:2]
    f, t = prob.from_slot.long(), prob.to_slot.long()
    live = prob.edge_mask
    lane = torch.arange(r, device=f.device)[:, None]
    h = spread_masked(torch.cat([f * k + f, f * k + t, t * k + f, t * k + t], dim=1), live.repeat(1, 4), k * k)
    g = spread_masked(torch.cat([f, t], dim=1), live.repeat(1, 2), k)
    return NormalEqPlan(h=ScatterPlan.of(h + lane * (k * k)), g=ScatterPlan.of(g + lane * k))


def _flat_edges(prob: PoseGraphProblem) -> PoseGraphProblem:
    """A stacked problem's edges as one problem over the (R·K, 3) poses:
    lane r's slots offset by r·K."""
    r, k = prob.poses.shape[:2]
    off = torch.arange(r, device=prob.poses.device)[:, None] * k
    return PoseGraphProblem(
        poses=prob.poses.reshape(r * k, 3), pose_mask=prob.pose_mask.reshape(r * k),
        from_slot=(prob.from_slot + off).reshape(-1), to_slot=(prob.to_slot + off).reshape(-1),
        T=prob.T.reshape(-1, 3), sqrt_info=prob.sqrt_info.reshape(-1, 3, 3), edge_mask=prob.edge_mask.reshape(-1),
    )


def _edge_scale(scale: torch.Tensor, flat: PoseGraphProblem) -> torch.Tensor:
    """The (R,) lanes' scales as one (R·E, 1) column over their edges."""
    return scale.repeat_interleave(flat.from_slot.shape[0] // scale.shape[0])[:, None]


def _lane_costs(r: torch.Tensor, lanes: int) -> torch.Tensor:
    """½‖r‖² of each lane's (E, 3) residuals in the flat (R·E, 3) ``r``."""
    return 0.5 * torch.sum((r * r).reshape(lanes, -1), dim=-1)


def _assemble_lanes(poses, flat: PoseGraphProblem, scale, est_scale: bool, plan: NormalEqPlan):
    """:func:`_assemble_normal_eqs` of each lane: ``poses`` (R, K, 3),
    ``flat`` the lanes' edges (:func:`_flat_edges`), ``scale`` (R,) →
    (R, N, N) H, (R, N) g and the (R,) costs.  Every edge is computed as
    in one lane's assembly, and each lane's sums run in its own plan's
    order."""
    r_, k = poses.shape[:2]
    e = flat.from_slot.shape[0] // r_
    scale_e = _edge_scale(scale, flat)
    res = residuals(poses.reshape(r_ * k, 3), flat, scale_e)
    cost = _lane_costs(res, r_)
    ja, jb, js = _edge_jacobians(poses.reshape(r_ * k, 3), flat, scale_e)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    ga = torch.einsum("eji,ej->ei", ja, res)
    gb = torch.einsum("eji,ej->ei", jb, res)

    def lanes(*parts, width):
        """Each lane's rows of ``parts`` one after another, as a lane's own
        ``torch.cat(parts)`` orders them."""
        return torch.cat([p.reshape(r_, e, width) for p in parts], dim=1).reshape(-1, width)

    def vec_sum(va, vb):
        out = torch.zeros((r_ * k, 3), dtype=torch.float32, device=poses.device)
        return index_add_ordered(out, plan.g, lanes(va, vb, width=3)).reshape(r_, 3 * k)

    h4 = torch.zeros((r_ * k * k, 9), dtype=torch.float32, device=poses.device)
    index_add_ordered(h4, plan.h, lanes(haa, hab, hab.transpose(-1, -2), hbb, width=9))
    h = h4.view(r_, k, k, 3, 3).permute(0, 1, 3, 2, 4).reshape(r_, 3 * k, 3 * k)
    g = vec_sum(ga, gb)
    if est_scale:
        hs_col = vec_sum(torch.einsum("eij,ei->ej", ja, js), torch.einsum("eij,ei->ej", jb, js))
        hss = torch.sum((js * js).reshape(r_, -1), dim=-1)
        gs = torch.sum((js * res).reshape(r_, -1), dim=-1)
        h = torch.cat(
            [torch.cat([h, hs_col[:, :, None]], dim=2),
             torch.cat([hs_col[:, None, :], hss.reshape(r_, 1, 1)], dim=2)],
            dim=1,
        )
        g = torch.cat([g, gs[:, None]], dim=1)
    return h, g, cost


def _host_values(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` with no host sync: through pinned
    memory on a card."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def solve_pose_graph_lanes(
    prob: PoseGraphProblem, cfg: SolverConfig = SolverConfig(), *,
    init_scale: float = 1.0, scale_free: bool = False, trace: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`solve_pose_graph` of R problems stacked on a leading lane
    axis (every leaf), in one LM loop → ``(poses (R, K, 3), scale (R,),
    final_cost (R,))``.  Each iteration assembles every lane's normal
    equations, factors them with one batched ``cholesky_ex`` and reads
    the (R, 2) ``[accept, small]`` flags once.  Each lane keeps its own
    damping μ, an f32 on the host on the single solve's schedule, and its
    own stop; a lane that has stopped keeps its x and cost (a
    ``torch.where``), as a vmapped ``while_loop`` freezes a finished lane.
    Each lane's result is the single solve's of that lane, bit for bit
    where the batched operations compute each lane as the single ones do
    (LAPACK factors each matrix alone).  ``trace``, a list, gets each
    iteration's flags as read: per lane ``(accept, small)``, or None for
    a lane that had stopped."""
    dev = prob.poses.device
    r_, k = prob.poses.shape[:2]
    free = prob.pose_mask.repeat_interleave(3, dim=1).clone()
    free[:, :3] = False  # pin base slot 0
    if cfg.estimate_scale:
        free = torch.cat([free, torch.full((r_, 1), bool(scale_free), device=dev)], dim=1)
    fm = free.to(torch.float32)
    flat = _flat_edges(prob)

    def pack(poses, scale):
        x = poses.reshape(r_, 3 * k)
        if cfg.estimate_scale:
            x = torch.cat([x, scale.reshape(r_, 1)], dim=1)
        return x

    def unpack(x):
        poses = x[:, : 3 * k].reshape(r_, k, 3)
        scale = x[:, 3 * k] if cfg.estimate_scale else torch.ones(r_, device=dev)
        return poses, scale

    def norm_poses(poses):
        return torch.cat([poses[..., :2], normalize_angle(poses[..., 2:3])], dim=-1)

    def cost_of(x):
        poses, scale = unpack(x)
        return _lane_costs(residuals(poses.reshape(r_ * k, 3), flat, _edge_scale(scale, flat)), r_)

    x = pack(norm_poses(prob.poses), torch.full((r_,), init_scale, dtype=torch.float32, device=dev))
    cost = cost_of(x)
    plan = _lane_plan(prob)
    # Each lane's damping schedule runs on the host in float32, as JAX
    # carries it.
    mu = np.full(r_, cfg.mu_init, np.float32)
    factor, mu_min, mu_max = np.float32(cfg.mu_factor), np.float32(cfg.mu_min), np.float32(cfg.mu_max)
    active = np.ones(r_, bool)
    for _ in range(cfg.max_iterations):
        active &= mu < mu_max
        if not active.any():
            break
        poses, scale = unpack(x)
        h, g, _ = _assemble_lanes(poses, flat, scale, cfg.estimate_scale, plan)
        # _pin, lane by lane
        h = h * fm[:, :, None] * fm[:, None, :] + torch.diag_embed(1.0 - fm)
        g = g * fm
        mu_d = _host_values(mu, dev)
        hd = h + mu_d[:, None, None] * torch.diag_embed(torch.diagonal(h, dim1=-2, dim2=-1))
        chol, status = torch.linalg.cholesky_ex(hd)
        delta = torch.cholesky_solve(-g[:, :, None], chol)[:, :, 0]
        solve_ok = (status == 0) & torch.all(torch.isfinite(delta), dim=1)
        x_new = x + torch.where(solve_ok[:, None], delta, 0.0)
        p_new, s_new = unpack(x_new)
        x_new = pack(norm_poses(p_new), s_new)
        new_cost = cost_of(x_new)
        accept = solve_ok & (new_cost < cost)
        rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        take = accept & _host_values(active, dev)
        flags = torch.stack([accept, rel_drop < cfg.rtol], dim=1).tolist()
        x = torch.where(take[:, None], x_new, x)
        cost = torch.where(take, new_cost, cost)
        if trace is not None:
            trace.append([tuple(f) if a else None for f, a in zip(flags, active)])
        for i, (accept_h, small) in enumerate(flags):
            if not active[i]:
                continue
            if accept_h:
                mu[i] = max(mu[i] / factor, mu_min)
                if small:
                    active[i] = False
            else:
                mu[i] = min(mu[i] * factor, mu_max)
    poses, scale = unpack(x)
    poses = torch.where(prob.pose_mask[..., None], poses, prob.poses)
    return poses, scale, cost
