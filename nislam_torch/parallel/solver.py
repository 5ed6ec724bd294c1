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
distributed engine's ``solver_fn`` is one (its host-loop trigger's).

:class:`CGTrigger` is the distributed engine's whole deferred trigger as
one program, JAX's ``maybe_optimize`` around that ``shard_map``: the
trigger kernel, the masked pending-edge loop and the problem on the
device, the same steps over fixed buffers with ``cg_step`` (a kernel of
``csrc/cond_graph.cu``, the counterpart of the CG ``while_loop``'s
condition and of the Gauss-Newton ``fori_loop``'s counter) at each loop
edge, the finish and the sharded recompute.  On a group whose all-reduce
a conditional graph body holds (a card at any rank count: the peer
all-reduce kernel, ``ops/all_reduce.py``) it is one graph launch, the
all-reduces and the stop test inside; else (gloo on CPU tensors) the host
makes the all-reduces and reads ‖r‖² once per CG check, as
:class:`CGGraph` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from nislam_torch.core.pose_graph import PoseGraphProblem, SolverConfig, _edge_jacobians, lm_control, residuals
from nislam_torch.core.se2 import normalize_angle
from nislam_torch.core.solve_graph import ANY, CTL_WORDS, RUN, TRIGGERS, trigger
from nislam_torch.core.track_graph import CapturedStep
from nislam_torch.kernels.launch import cg_step_args, cuda_check, launch_cg_step, trigger_args
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


def _buffers(prob: PoseGraphProblem, group: RankGroup) -> SimpleNamespace:
    """A solve's fixed buffers for ``prob``'s shapes: K poses, this rank's
    block of the edges."""
    local = _edge_block(prob, group)
    k, n = prob.poses.shape[0], local.from_slot.shape[0]
    dev = prob.poses.device
    like = lambda x: torch.zeros_like(x, memory_format=torch.contiguous_format)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    plan_fields = len(ScatterPlan._fields) if dev.type == "cuda" else 1  # on the CPU the keys alone
    return SimpleNamespace(
        poses0=like(prob.poses), pose_mask=like(prob.pose_mask),
        local=PoseGraphProblem(poses=None, pose_mask=None, **{
            name: like(getattr(local, name)) for name in ("from_slot", "to_slot", "T", "sqrt_info", "edge_mask")}),
        f=zeros(n, dtype=torch.int64), t=zeros(n, dtype=torch.int64),
        plan=ScatterPlan(*(zeros(2 * n, dtype=torch.int64) for _ in range(plan_fields))),
        free=zeros(k, 1, dtype=torch.bool), poses=zeros(k, 3), gd=zeros(2, k, 3),
        ja=zeros(n, 3, 3), jb=zeros(n, 3, 3), dinv=zeros(k, 3), x=zeros(k, 3), r=zeros(k, 3),
        p=zeros(k, 3), hp=zeros(k, 3), rz=zeros(), r2=zeros(), cost=zeros(1), out=zeros(k, 3),
    )


def _load(b: SimpleNamespace, prob: PoseGraphProblem, group: RankGroup) -> None:
    """Copy ``prob`` (this rank's block of its edges) into the buffers."""
    local = _edge_block(prob, group)
    b.poses0.copy_(prob.poses)
    b.pose_mask.copy_(prob.pose_mask)
    for name in ("from_slot", "to_slot", "T", "sqrt_info", "edge_mask"):
        getattr(b.local, name).copy_(getattr(local, name))


def _step_fns(b: SimpleNamespace, cfg: CGSolverConfig) -> Dict[str, Callable[[], None]]:
    """:data:`STEPS`' functions over the buffers ``b``."""
    fns = {"setup": _setup, "grad": _grad, "start": functools.partial(_start, damping=cfg.damping),
           "hvp": _hvp, "update": functools.partial(_update, damping=cfg.damping), "advance": _advance,
           "cost": _cost}
    return {name: functools.partial(fn, b) for name, fn in fns.items()}


def _capture_stream(dev: torch.device):
    """A capture stream and a memory pool for steps that run one at a time
    (None, None on the CPU)."""
    if dev.type != "cuda":
        return None, None
    return torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()


class _Program:
    """One solve shape's buffers and steps: K poses, this rank's block of
    the edges."""

    def __init__(self, prob: PoseGraphProblem, group: RankGroup, cfg: CGSolverConfig):
        dev = prob.poses.device
        # The steps hold no reference to self (see TrackGraph).
        self.b = b = _buffers(prob, group)
        stream, pool = _capture_stream(dev)
        fns = _step_fns(b, cfg)
        self.steps: Dict[str, CapturedStep] = {name: CapturedStep(dev, fns[name], stream, pool) for name in STEPS}

    def load(self, prob: PoseGraphProblem, group: RankGroup) -> None:
        """Copy ``prob`` (this rank's block of its edges) into the buffers."""
        _load(self.b, prob, group)


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


# ---------------------------------------------------------------------------
# The distributed engine's deferred trigger
# ---------------------------------------------------------------------------

# The GN-CG trigger's control words, after the solve graph's in one block
# (csrc/cond_graph.cu's kGn ... kCgTotal): the Gauss-Newton step and the CG
# iteration of the running solve, the CG and Gauss-Newton WHILE conditions,
# then the Gauss-Newton steps and CG iterations run inside graphs (counts
# that only grow).
GN, CG_IT, CG_LOOP, GN_LOOP, GN_TOTAL, CG_TOTAL = range(CTL_WORDS, CTL_WORDS + 6)
TRIGGER_WORDS = CTL_WORDS + 6
# The cg_step kernel's modes: the Gauss-Newton loop's start and step, the
# CG loop's start and step.
GN_BEGIN, GN_STEP, CG_BEGIN, CG_STEP = range(4)
TRIGGER_STRUCTURE = ("outer_nodes", "if_body_nodes", "gn_body_nodes", "cg_body_nodes")


def cg_step_reference(ctl: torch.Tensor, r2: torch.Tensor, mode: int, cfg: CGSolverConfig) -> None:
    """The ``cg_step`` kernel's plain version, on tensors (no host read): a
    start (``GN_BEGIN``, ``CG_BEGIN``) sets its counter to 0, a step adds
    one; the CG condition is ``it < cg_iterations and r2 > cg_tol ** 2``
    with ``r2`` widened to float64 against the Python float, as the host's
    ``float(r2) > cg_tol ** 2`` compares; the Gauss-Newton condition
    ``gn < outer_iterations``."""
    if mode in (GN_BEGIN, GN_STEP):
        gn = ctl[GN] + 1 if mode == GN_STEP else torch.zeros_like(ctl[GN])
        ctl[GN] = gn
        ctl[GN_LOOP] = (gn < cfg.outer_iterations).to(torch.int32)
    elif mode in (CG_BEGIN, CG_STEP):
        it = ctl[CG_IT] + 1 if mode == CG_STEP else torch.zeros_like(ctl[CG_IT])
        ctl[CG_IT] = it
        ctl[CG_LOOP] = ((it < cfg.cg_iterations) & (r2.reshape(()).double() > cfg.cg_tol ** 2)).to(torch.int32)
    else:
        raise ValueError(f"invalid cg_step mode {mode}")


def cg_step(ctl: torch.Tensor, r2: torch.Tensor, mode: int, cfg: CGSolverConfig,
            force: Optional[str] = None) -> None:
    """One start or step of the GN-CG loops: the kernel on a card (outside a
    graph: no WHILE handle), :func:`cg_step_reference` for CPU tensors.
    ``force`` ∈ {"kernel", "reference"} pins the choice;
    ``cg_step.launches`` counts kernel launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and ctl.is_cuda):
        launch_cg_step(ctl, r2, mode, cfg)
        cg_step.launches += 1
    else:
        cg_step_reference(ctl, r2, mode, cfg)


cg_step.launches = 0


def trigger_body(canvas: bool) -> tuple:
    """The GN-CG trigger's program, in order: JAX's ``maybe_optimize``
    around ``solve_pose_graph_cg`` (``nislam_tpu/core/slam.py:755-787``,
    ``nislam_tpu/parallel/solver.py:89-166``).  ``("reduce", x)`` is an
    all-reduce of buffer ``x``; ``("while", word, body)`` runs ``body``
    while control word ``word`` is set (``cg_step`` sets it); ``canvas``:
    with the online canvas's sharded recompute."""
    cg = (("hvp",), ("reduce", "hp"), ("update",), ("cg_step", CG_STEP))
    gn = (("grad",), ("reduce", "gd"), ("start",), ("cg_step", CG_BEGIN), ("while", CG_LOOP, cg), ("advance",),
          ("cg_step", GN_STEP))
    tail = (("reduce", "delta"), ("commit",)) if canvas else ()
    return (("trigger",), ("if", (("setup",), ("cg_step", GN_BEGIN), ("while", GN_LOOP, gn), ("cost",),
                                  ("reduce", "cost"), ("finish",), *tail)))


def segments(body: tuple, reduces: bool) -> tuple:
    """``body`` with each run of local steps between two control points
    (the trigger, ``cg_step``, a conditional, and an all-reduce unless
    ``reduces``: one that a graph captures) as one ``("step", name, ops)``:
    what is captured as one graph."""
    out, run = [], []

    def flush() -> None:
        if run:
            name = ",".join(op[1] if op[0] == "reduce" else op[0] for op in run)
            out.append(("step", name, tuple(run)))
            run.clear()

    for op in body:
        if op[0] == "if":
            flush()
            out.append(("if", segments(op[1], reduces)))
        elif op[0] == "while":
            flush()
            out.append(("while", op[1], segments(op[2], reduces)))
        elif op[0] in ("trigger", "cg_step") or (op[0] == "reduce" and not reduces):
            flush()
            out.append(op)
        else:
            run.append(op)
    flush()
    return tuple(out)


def _steps_of(body: tuple) -> List[tuple]:
    """Every ``("step", name, ops)`` of a segmented body, in order."""
    found = []
    for op in body:
        if op[0] == "step":
            found.append(op)
        elif op[0] == "if":
            found += _steps_of(op[1])
        elif op[0] == "while":
            found += _steps_of(op[2])
    return found


def _run_ops(ops: tuple, fns: Dict[str, Callable[[], None]], bufs: Dict[str, torch.Tensor], group: RankGroup) -> None:
    """A step's operations; a captured step's all-reduces count once per
    replay (``core/track_graph.py``)."""
    for op in ops:
        if op[0] == "reduce":
            group.all_reduce(bufs[op[1]])
        else:
            fns[op[0]]()


def _trigger_setup(b: SimpleNamespace, state, run: torch.Tensor, problem, group: RankGroup) -> None:
    """``setup``: the problem built from the state on the device (the masked
    pending-edge loop, the map's problem), this rank's block of it loaded,
    the solve's fixed parts (:func:`_setup`)."""
    _load(b, problem(state, run), group)
    _setup(b)


def _trigger_finish(b: SimpleNamespace, state, run: torch.Tensor, finish, canvas) -> None:
    """``finish``: the poses, the pending count and the chain; with the
    online canvas, this rank's masked part of the recompute."""
    finish(state, run, b.out)
    if canvas is not None:
        canvas.stage()


class CGTrigger:
    """The distributed engine's deferred trigger over ``state`` (the frame
    graph's buffers, one lane) as one program: the ``trigger`` kernel
    (``core/solve_graph.py``'s, one lane), then, if it runs, ``setup``
    (``problem(state, run)``: the masked pending-edge loop and the map's
    problem, on the device), the Gauss-Newton steps around the CG loop of
    :func:`solve_pose_graph_cg` over fixed buffers, the cost, and the
    finish (``finish(state, run, poses)``: the poses, the pending count,
    the chain; with ``canvas``, a namespace of ``stage()``, ``commit()`` and
    the (2, S, S) ``delta``, the sharded recompute: this rank's masked part,
    the delta's all-reduce, the copy).  :func:`trigger_body` is the program;
    :meth:`run` the entry point.

    The route follows the group (:attr:`RankGroup.capturable`), never a
    failure:

    - on a group whose captured all-reduce a conditional body holds (a
      card, any rank count: ``RankGroup.capturable``), after the first
      trigger that solves, ONE graph launch (``csrc/cond_graph.cu``'s
      ``nislam_tg_create``: the trigger, an IF, a WHILE over the
      Gauss-Newton steps holding a WHILE over the CG iterations, the
      all-reduces inside the captured children, ``cg_step`` setting the
      WHILE handles) and one host read after it: the run flag and the
      counts that only grow, which give the steps' replays, ``cg_step``'s
      launches and the all-reduces by payload;
    - else (gloo on CPU tensors, or the first trigger that solves, which
      captures the steps) the plain program: the steps between the control points as
      captured steps on a card (eager on the CPU), the host making the
      all-reduces, one read of the run flag and one of ‖r‖² per CG check,
      as :class:`CGGraph` reads it (the Gauss-Newton steps are a fixed
      count: no read).

    Every rank leaves every loop at the same iteration: the stop test reads
    ‖r‖², made from all-reduced values only, which have the same bits on
    every rank, and the Gauss-Newton steps are a fixed count.  The bits are
    ``optimize_host_loop``'s with :class:`CGGraph` (the edge store, the
    poses, the canvas, the chain, the iteration count), and the all-reduces
    by payload too."""

    # Graph launches on a card, by every instance.
    launches = 0

    def __init__(self, state, group: RankGroup, cfg: CGSolverConfig, template: PoseGraphProblem, problem, finish,
                 canvas: Optional[SimpleNamespace] = None, stream=None):
        self.device = dev = template.poses.device
        self.group, self.cfg = group, cfg
        self.ctl = torch.zeros(TRIGGER_WORDS, dtype=torch.int32, device=dev)
        self.run_flags = torch.zeros(1, dtype=torch.bool, device=dev)
        self.control = lm_control(1, dev, self.ctl)  # the trigger kernel's LM words, unused here
        self._lm = SolverConfig()
        self._pending = state.pending
        self.b = b = _buffers(template, group)
        self.reduces = {"gd": b.gd, "hp": b.hp, "cost": b.cost}
        if canvas is not None:
            self.reduces["delta"] = canvas.delta
        fns = _step_fns(b, cfg)
        fns["setup"] = functools.partial(_trigger_setup, b, state, self.run_flags, problem, group)
        fns["finish"] = functools.partial(_trigger_finish, b, state, self.run_flags, finish, canvas)
        if canvas is not None:
            fns["commit"] = canvas.commit
        self.body = segments(trigger_body(canvas is not None), group.capturable)
        if stream is None:
            stream, pool = _capture_stream(dev)
        else:
            pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.steps: Dict[str, CapturedStep] = {
            name: CapturedStep(dev, functools.partial(_run_ops, ops, fns, self.reduces, group), stream, pool)
            for _, name, ops in _steps_of(self.body)}
        self.cg_iterations = 0  # the last trigger's CG iterations, over all its Gauss-Newton steps
        self.node_types: Dict[str, int] = {}  # of the graphs the card's build nested
        self.structure: Dict[str, int] = {}  # of the card's build (TRIGGER_STRUCTURE)
        self._seen = [0] * 4  # triggers, solves, Gauss-Newton steps, CG iterations already counted
        self._graph: Optional[_CardTriggerGraph] = None

    @classmethod
    def for_problem(cls, prob: PoseGraphProblem, group: RankGroup, cfg: CGSolverConfig = CGSolverConfig()):
        """The GN-CG solve of ``prob`` alone as this program: a trigger whose
        pending buffer always holds two live matches, whose setup loads
        ``prob`` and whose finish writes nothing → (program, ``solve() →
        (poses, final_cost)``, the bits of :func:`solve_pose_graph_cg`).
        What the measuring scripts time against :class:`CGGraph`."""
        dev = prob.poses.device
        pending = SimpleNamespace(count=torch.full((), 2, dtype=torch.int32, device=dev),
                                  loop_slot=torch.zeros(2, dtype=torch.int32, device=dev))
        program = cls(SimpleNamespace(pending=pending), group, cfg, prob, lambda state, run: prob,
                      lambda state, run, poses: None)

        def solve() -> Tuple[torch.Tensor, torch.Tensor]:
            program.run()
            return program.b.out.clone(), program.b.cost[0].clone()

        return program, solve

    @property
    def built(self) -> bool:
        """Whether triggers run as one graph launch."""
        return self._graph is not None

    @staticmethod
    def read(words: torch.Tensor) -> List[int]:
        """The program's one kind of host read: control words to the host."""
        return words.tolist()

    def run(self) -> bool:
        """One trigger of the loaded state → whether it solved."""
        if self._graph is None:
            ran = self._plain()
            if self.device.type == "cuda" and self.group.capturable and self._captured():
                self._graph = _CardTriggerGraph(self)
                self.node_types, self.structure = self._graph.node_types, self._graph.structure
                CapturedStep.captures += 1
            return ran
        self._graph.launch()
        CGTrigger.launches += 1
        words = self.read(self.ctl)
        self.group.check()
        self._account(words)
        return bool(words[RUN])

    def _captured(self) -> bool:
        return all(step.captured for step in self.steps.values())

    def _trigger_args(self) -> tuple:
        p = self._pending
        return self.ctl, p.count.reshape(1), p.loop_slot.reshape(1, -1), self.run_flags, self.control, self._lm

    def _account(self, words: List[int]) -> None:
        """Add what a launch ran (the growth of the counts since the last
        read): the trigger's and ``cg_step``'s launches, the steps' replays
        and the all-reduces by payload."""
        counts = [words[TRIGGERS], words[TRIGGERS + 1], words[GN_TOTAL], words[CG_TOTAL]]
        d_trig, d_solve, d_gn, d_cg = (a - b for a, b in zip(counts, self._seen))
        self._seen = counts
        trigger.launches += d_trig
        cg_step.launches += d_solve + 2 * d_gn + d_cg
        runs = {"setup": d_solve, "head": d_gn, "iteration": d_cg, "advance": d_gn, "finish": d_solve}
        for role, (name, _) in zip(runs, self._graph.roles):
            self.steps[name].count_replays(runs[role])
        if d_solve:
            self.cg_iterations = d_cg

    def _plain(self) -> bool:
        """The plain program: :attr:`body` as a loop on the host, whose loop
        conditions the host tests as :class:`CGGraph` does (``cg_step``'s
        conditions, in the card's graph): the Gauss-Newton steps a fixed
        count, the CG loop's ``it < cg_iterations and float(r2) > cg_tol
        ** 2`` with one read of ‖r‖² per check."""
        ran, iterations = False, 0
        tol2 = self.cfg.cg_tol ** 2
        r2 = self.b.r2.reshape(1)

        def walk(ops) -> None:
            nonlocal ran, iterations
            for op in ops:
                kind = op[0]
                if kind == "trigger":
                    trigger(*self._trigger_args())
                elif kind == "if":
                    ran = bool(self.read(self.ctl[ANY:ANY + 1])[0])
                    if ran:
                        walk(op[1])
                elif kind == "while" and op[1] == GN_LOOP:
                    for _ in range(self.cfg.outer_iterations):
                        walk(op[2])
                elif kind == "while":
                    it = 0
                    while it < self.cfg.cg_iterations and self.read(r2)[0] > tol2:
                        walk(op[2])
                        it += 1
                    iterations += it
                elif kind == "cg_step":
                    pass  # the graph's loop control: the host tests the conditions here
                elif kind == "reduce":
                    self.group.all_reduce(self.reduces[op[1]])
                else:
                    self.steps[op[1]].run()

        walk(self.body)
        self.group.check()
        if ran:
            self.cg_iterations = iterations
        return ran


class _CardTriggerGraph:
    """The built graph on a card: holds the nested steps for as long as it
    lives, and is destroyed with it."""

    def __init__(self, t: CGTrigger):
        from nislam_torch.core.chunk_graph import body_node_types
        from nislam_torch.kernels.launch import cond_graph_library

        self._lib = lib = cond_graph_library()
        self._device = t.device
        (_, (kind, inner)) = t.body
        setup, gn_begin, (while_, word, gn), finish = inner
        head, cg_begin, (_, cg_word, cg), advance, gn_step = gn
        iteration, step = cg
        if (kind, while_, word, cg_word, gn_begin[0], cg_begin[0], step[0], gn_step[0]) != (
                "if", "while", GN_LOOP, CG_LOOP, "cg_step", "cg_step", "cg_step", "cg_step"):
            raise ValueError("the trigger's body does not have the graph's shape")
        # The steps in the graph's order: setup, head, iteration, advance, finish.
        self.roles = tuple((op[1], op[2]) for op in (setup, head, iteration, advance, finish))
        graphs = [t.steps[name].raw_graph() for name, _ in self.roles]
        self.nested = tuple(t.steps[name] for name, _ in self.roles)
        self.node_types = body_node_types(lib, graphs)
        h = ctypes.c_void_p()
        _, r2, cg_it, outer, tol2 = cg_step_args(t.ctl, t.b.r2, t.cfg)
        cuda_check(lib.nislam_tg_create(ctypes.byref(h), *trigger_args(*t._trigger_args()), *graphs, r2, cg_it, outer,
                                        tol2), "building the GN-CG trigger's graph")
        try:
            cuda_check(lib.nislam_sg_instantiate(h), "instantiating the GN-CG trigger's graph")
        except BaseException:
            lib.nislam_sg_destroy(h)
            raise
        self._h = h
        self._finalizer = weakref.finalize(self, lib.nislam_sg_destroy, h)
        counts = (ctypes.c_int * len(TRIGGER_STRUCTURE))()
        cuda_check(lib.nislam_sg_describe(h, counts, len(TRIGGER_STRUCTURE)), "walking the GN-CG trigger's graph")
        self.structure = dict(zip(TRIGGER_STRUCTURE, counts))

    def launch(self) -> None:
        cuda_check(self._lib.nislam_sg_launch(self._h, torch.cuda.current_stream(self._device).cuda_stream),
                   "launching the GN-CG trigger's graph")
