"""Distributed pose-graph solver: edge-sharded Gauss-Newton over ranks.

Counterpart of ``nislam_tpu.parallel.solver``.  Poses are replicated on
every rank (3K floats); rank r holds the contiguous edge block
[r·E/n, (r+1)·E/n), as JAX's ``P(axis)`` on the edge axis.  Each
Gauss-Newton step solves ``(JᵀJ + μI) δ = −Jᵀr`` matrix-free with
Jacobi-preconditioned conjugate gradients; the reduced normal equations
are never formed.  Collectives, all through the :class:`RankGroup`:

- one ``all_reduce`` of the stacked (2, K, 3) gradient and JᵀJ diagonal
  per Gauss-Newton step (JAX makes two ``psum``);
- one ``all_reduce`` of a (K, 3) vector per Hessian-vector product;
- one of the final cost.

The CG stop test reads ‖r‖² on the host each iteration.  ``r`` is built
from all-reduced vectors only, and an all-reduce leaves the same bits on
every rank, so every rank leaves the loop at the same iteration (a rank
that left early would wait forever in the next collective); the iteration
count is JAX's ``while_loop``'s.  The scatter-adds run in a fixed order
(:func:`~nislam_torch.ops.scatter_add.index_add_ordered`, one sort of the
rank's edge slots per solve), so a solve on the card repeats bit for bit,
its iteration count included.

Same residual, whitening and pinning semantics as the dense solver
(``nislam_torch.core.pose_graph``): slot 0 and dead slots stay fixed,
angles wrap on the circle.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from nislam_torch.core.pose_graph import PoseGraphProblem, _edge_jacobians, residuals
from nislam_torch.core.se2 import normalize_angle
from nislam_torch.ops.scatter_add import ScatterPlan, index_add_ordered, spread_masked
from nislam_torch.parallel.mesh import RankGroup


@dataclasses.dataclass(frozen=True)
class CGSolverConfig:
    outer_iterations: int = 20  # Gauss-Newton steps
    cg_iterations: int = 64  # CG steps per GN step
    cg_tol: float = 1e-6
    damping: float = 1e-6  # Levenberg diagonal damping


def _scatter(k: int, plan: ScatterPlan, va, vb) -> torch.Tensor:
    """(K, 3): ``va`` added at ``from_slot``, ``vb`` at ``to_slot``, in one
    fixed-order scatter whose ``plan`` holds the keys ``cat([f, t])`` (a
    dead edge's spread, see :func:`solve_pose_graph_cg`)."""
    out = torch.zeros((k, 3), dtype=va.dtype, device=va.device)
    return index_add_ordered(out, plan, torch.cat([va, vb]))


def _local_jtj_vec(ja, jb, from_slot, to_slot, plan: ScatterPlan, x: torch.Tensor) -> torch.Tensor:
    """This rank's JᵀJ·x (K, 3) from its edges' Jacobians — no collective."""
    jx = torch.einsum("eij,ej->ei", ja, x[from_slot]) + torch.einsum("eij,ej->ei", jb, x[to_slot])
    return _scatter(x.shape[0], plan, torch.einsum("eij,ei->ej", ja, jx), torch.einsum("eij,ei->ej", jb, jx))


def _local_grad_and_diag(poses: torch.Tensor, prob: PoseGraphProblem, plan: ScatterPlan):
    """This rank's Jᵀr and diag(JᵀJ) stacked → (2, K, 3), and its edges'
    whitened Jacobians (Ja, Jb) for the Hessian-vector products."""
    r = residuals(poses, prob, 1.0)
    ja, jb, _ = _edge_jacobians(poses, prob, 1.0)
    k = poses.shape[0]
    g = _scatter(k, plan, torch.einsum("eij,ei->ej", ja, r), torch.einsum("eij,ei->ej", jb, r))
    d = _scatter(k, plan, torch.einsum("eij,eij->ej", ja, ja), torch.einsum("eij,eij->ej", jb, jb))
    return torch.stack([g, d]), ja, jb


def _edge_block(prob: PoseGraphProblem, group: RankGroup) -> PoseGraphProblem:
    e = prob.from_slot.shape[0]
    if e % group.size:
        raise ValueError(f"edge capacity {e} not divisible by {group.size} ranks")
    lo, hi = group.rank * e // group.size, (group.rank + 1) * e // group.size
    return prob._replace(from_slot=prob.from_slot[lo:hi], to_slot=prob.to_slot[lo:hi],
                         T=prob.T[lo:hi], sqrt_info=prob.sqrt_info[lo:hi],
                         edge_mask=prob.edge_mask[lo:hi])


def solve_pose_graph_cg(
    prob: PoseGraphProblem, group: RankGroup, cfg: CGSolverConfig = CGSolverConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GN-CG solve → ``(poses, final_cost)``, both the same on every rank.

    ``prob`` is the whole problem, the same on every rank (the map state
    is replicated); its edge capacity must divide by the group size
    (masked edges contribute zero)."""
    local = _edge_block(prob, group)
    f, t = local.from_slot.long(), local.to_slot.long()
    k = prob.poses.shape[0]
    # The rank's edges, fixed for the whole solve; dead edges add exact zeros.
    plan = ScatterPlan.of(spread_masked(torch.cat([f, t]), local.edge_mask.repeat(2), k))
    free = (prob.pose_mask & (torch.arange(k, device=prob.poses.device) > 0))[:, None]
    tol2 = cfg.cg_tol ** 2

    poses = torch.cat([prob.poses[:, :2], normalize_angle(prob.poses[:, 2:3])], dim=-1)
    for _ in range(cfg.outer_iterations):
        gd, ja, jb = _local_grad_and_diag(poses, local, plan)
        g, d = group.all_reduce(gd)
        g = torch.where(free, g, 0.0)
        dinv = torch.where(free, 1.0 / (d + cfg.damping + 1e-12), 0.0)

        def hvp(x):
            hx = group.all_reduce(_local_jtj_vec(ja, jb, f, t, plan, x)) + cfg.damping * x
            return torch.where(free, hx, 0.0)

        # Jacobi-preconditioned CG on H δ = −g.
        r = -g
        x = torch.zeros_like(r)
        z = dinv * r
        p = z
        rz = torch.sum(r * z)
        it = 0
        while it < cfg.cg_iterations and float(torch.sum(r * r)) > tol2:
            hp = hvp(p)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            z = dinv * r
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new
            it += 1
        poses = poses + torch.where(free, x, 0.0)
        poses = torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=-1)
    r = residuals(poses, local, 1.0)
    cost = group.all_reduce((0.5 * torch.sum(r * r)).reshape(1))[0]
    return torch.where(prob.pose_mask[:, None], poses, prob.poses), cost
