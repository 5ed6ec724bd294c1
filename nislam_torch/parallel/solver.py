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

:class:`CGGraph` runs the same solve as a graph program, JAX's one
``shard_map`` (``nislam_tpu/parallel/solver.py``: a ``fori_loop`` over
the Gauss-Newton steps around a ``lax.while_loop`` CG) with the host
keeping the collectives and the stop test: the local work between two
collectives is one :class:`~nislam_torch.core.track_graph.CapturedStep`
over fixed buffers, captured at its first run on a card and replayed
after it, and run eagerly on the CPU (the plain program).  A CG
iteration is one replay, the all-reduce, one replay and one read of
‖r‖², where :func:`solve_pose_graph_cg` launches ~45 operations; its
bits are that function's, the iteration count included.  The
distributed engine's ``solver_fn`` is one.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Dict, Tuple

import torch

from nislam_torch.core.pose_graph import PoseGraphProblem, _edge_jacobians, residuals
from nislam_torch.core.se2 import normalize_angle
from nislam_torch.core.track_graph import CapturedStep
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


# ---------------------------------------------------------------------------
# The graph program
# ---------------------------------------------------------------------------

# The steps between the collectives, in the order a solve runs them:
# ``setup`` once; per Gauss-Newton step ``grad`` → all_reduce(gd) →
# ``start``, per CG iteration ``hvp`` → all_reduce(hp) → ``update``, and
# ``advance``; ``cost`` → all_reduce(cost).
STEPS = ("setup", "grad", "start", "hvp", "update", "advance", "cost")


def _setup(b: SimpleNamespace) -> None:
    """The solve's fixed parts from the loaded problem: the rank's edge
    slots, their scatter plan (one sort), the free mask and the wrapped
    initial poses."""
    k = b.poses.shape[0]
    f, t = b.local.from_slot.long(), b.local.to_slot.long()
    b.f.copy_(f)
    b.t.copy_(t)
    plan = ScatterPlan.of(spread_masked(torch.cat([f, t]), b.local.edge_mask.repeat(2), k))
    for buf, value in zip(b.plan, plan):
        if buf is not None:  # the CPU's plan is its keys
            buf.copy_(value)
    b.free.copy_((b.pose_mask & (torch.arange(k, device=b.poses.device) > 0))[:, None])
    b.poses.copy_(torch.cat([b.poses0[:, :2], normalize_angle(b.poses0[:, 2:3])], dim=-1))


def _grad(b: SimpleNamespace) -> None:
    """(a) The rank's Jᵀr and diag(JᵀJ), and its edges' Jacobians."""
    gd, ja, jb = _local_grad_and_diag(b.poses, b.local, b.plan)
    b.gd.copy_(gd)
    b.ja.copy_(ja)
    b.jb.copy_(jb)


def _start(b: SimpleNamespace, damping: float) -> None:
    """(b) The CG's start from the all-reduced ``gd``, and ‖r‖²."""
    g, d = b.gd
    g = torch.where(b.free, g, 0.0)
    dinv = torch.where(b.free, 1.0 / (d + damping + 1e-12), 0.0)
    r = -g
    z = dinv * r
    b.dinv.copy_(dinv)
    b.r.copy_(r)
    b.x.zero_()
    b.p.copy_(z)
    b.rz.copy_(torch.sum(r * z))
    b.r2.copy_(torch.sum(r * r))


def _hvp(b: SimpleNamespace) -> None:
    """(c) The rank's JᵀJ·p."""
    b.hp.copy_(_local_jtj_vec(b.ja, b.jb, b.f, b.t, b.plan, b.p))


def _update(b: SimpleNamespace, damping: float) -> None:
    """(d) One CG iteration from the all-reduced ``hp``: the damping, the
    free mask, α, x, r, z, β, p, rz, and ‖r‖²."""
    hp = torch.where(b.free, b.hp + damping * b.p, 0.0)
    alpha = b.rz / torch.clamp(torch.sum(b.p * hp), min=1e-30)
    b.x.copy_(b.x + alpha * b.p)
    r = b.r - alpha * hp
    z = b.dinv * r
    rz_new = torch.sum(r * z)
    beta = rz_new / torch.clamp(b.rz, min=1e-30)
    b.r.copy_(r)
    b.p.copy_(z + beta * b.p)
    b.rz.copy_(rz_new)
    b.r2.copy_(torch.sum(r * r))


def _advance(b: SimpleNamespace) -> None:
    """(e) The Gauss-Newton step: the poses moved by the CG's x, in place."""
    poses = b.poses + torch.where(b.free, b.x, 0.0)
    b.poses.copy_(torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=-1))


def _cost(b: SimpleNamespace) -> None:
    """(f) The rank's cost, and the solve's poses (dead slots kept)."""
    r = residuals(b.poses, b.local, 1.0)
    b.cost.copy_((0.5 * torch.sum(r * r)).reshape(1))
    b.out.copy_(torch.where(b.pose_mask[:, None], b.poses, b.poses0))


class _Program:
    """One solve shape's buffers and steps: K poses, this rank's block of
    the edges."""

    def __init__(self, prob: PoseGraphProblem, group: RankGroup, cfg: CGSolverConfig):
        local = _edge_block(prob, group)
        k, n = prob.poses.shape[0], local.from_slot.shape[0]
        dev = prob.poses.device
        like = lambda x: torch.zeros_like(x, memory_format=torch.contiguous_format)
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        plan_fields = len(ScatterPlan._fields) if dev.type == "cuda" else 1  # on the CPU the keys alone
        # The steps hold no reference to self (see TrackGraph).
        self.b = b = SimpleNamespace(
            poses0=like(prob.poses), pose_mask=like(prob.pose_mask),
            local=PoseGraphProblem(poses=None, pose_mask=None, **{
                name: like(getattr(local, name)) for name in ("from_slot", "to_slot", "T", "sqrt_info", "edge_mask")}),
            f=zeros(n, dtype=torch.int64), t=zeros(n, dtype=torch.int64),
            plan=ScatterPlan(*(zeros(2 * n, dtype=torch.int64) for _ in range(plan_fields))),
            free=zeros(k, 1, dtype=torch.bool), poses=zeros(k, 3), gd=zeros(2, k, 3),
            ja=zeros(n, 3, 3), jb=zeros(n, 3, 3), dinv=zeros(k, 3), x=zeros(k, 3), r=zeros(k, 3),
            p=zeros(k, 3), hp=zeros(k, 3), rz=zeros(), r2=zeros(), cost=zeros(1), out=zeros(k, 3),
        )
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None  # the steps run one at a time
        fns = {"setup": _setup, "grad": _grad, "start": functools.partial(_start, damping=cfg.damping),
               "hvp": _hvp, "update": functools.partial(_update, damping=cfg.damping), "advance": _advance,
               "cost": _cost}
        self.steps: Dict[str, CapturedStep] = {
            name: CapturedStep(dev, functools.partial(fns[name], b), stream, pool) for name in STEPS}

    def load(self, prob: PoseGraphProblem, group: RankGroup) -> None:
        """Copy ``prob`` (this rank's block of its edges) into the buffers."""
        b, local = self.b, _edge_block(prob, group)
        b.poses0.copy_(prob.poses)
        b.pose_mask.copy_(prob.pose_mask)
        for name in ("from_slot", "to_slot", "T", "sqrt_info", "edge_mask"):
            getattr(b.local, name).copy_(getattr(local, name))


def _key(prob: PoseGraphProblem) -> tuple:
    """What a program is made for: every field's shape, dtype and device."""
    return tuple((tuple(x.shape), x.dtype, x.device) for x in prob)


class CGGraph:
    """:func:`solve_pose_graph_cg` over ``group`` as a graph program:
    ``solver(prob) → (poses, final_cost)``, the same bits.  A program
    (fixed buffers, the steps captured at their first run on a card) is
    made at the first solve of each problem shape: an engine's K and edge
    capacity, so one.  Per solve the problem is copied in; the host runs
    the collectives and the CG's stop test (``float`` of ‖r‖², one read
    per iteration: every rank reads the same bits, so every rank leaves
    at the same iteration, and a gloo collective cannot be captured).
    Each step runs on the current stream, as the collectives do, so a
    replay that feeds a collective is ordered before it and one that
    reads its result after it.  ``cg_iterations``: the last solve's CG
    iterations, over all its Gauss-Newton steps."""

    def __init__(self, group: RankGroup, cfg: CGSolverConfig = CGSolverConfig()):
        self.group = group
        self.cfg = cfg
        self.cg_iterations = 0
        self._programs: Dict[tuple, _Program] = {}

    def program(self, prob: PoseGraphProblem) -> _Program:
        """The program for ``prob``'s shapes, made at its first use."""
        key = _key(prob)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(prob, self.group, self.cfg)
        return prog

    def __call__(self, prob: PoseGraphProblem) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, group = self.cfg, self.group
        prog = self.program(prob)
        prog.load(prob, group)
        b, steps = prog.b, prog.steps
        tol2 = cfg.cg_tol ** 2
        iterations = 0
        steps["setup"].run()
        for _ in range(cfg.outer_iterations):
            steps["grad"].run()
            group.all_reduce(b.gd)
            steps["start"].run()
            it = 0
            while it < cfg.cg_iterations and float(b.r2) > tol2:
                steps["hvp"].run()
                group.all_reduce(b.hp)
                steps["update"].run()
                it += 1
            iterations += it
            steps["advance"].run()
        steps["cost"].run()
        group.all_reduce(b.cost)
        self.cg_iterations = iterations
        return b.out.clone(), b.cost[0].clone()
