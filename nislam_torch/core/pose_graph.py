"""2D pose-graph optimizer: Levenberg–Marquardt over dense normal equations.

Counterpart of ``nislam_tpu.core.pose_graph``: whitened SE(2) residuals,
angles wrapped on the circle, base slot 0 pinned, dead slots and edges
masked, optional joint metric scale.

One LM loop serves every solve: :func:`solve_pose_graph_lanes` solves R
problems stacked on a leading lane axis, as JAX's batch engine vmaps the
solve (one batched Cholesky per iteration), and :func:`solve_pose_graph`
is its R = 1 case.  The ``lax.while_loop``'s carry lives on the device at
fixed addresses (:class:`LMCarry`, :class:`LMControl`): x, the cost, each
lane's damping μ, its ``active`` flag, the iteration count and the loop
condition.  An iteration is :func:`lm_iterate` (PyTorch operations, no
host read), then :func:`lm_step`, which updates μ, the lane mask, the count
and the condition: on a card the ``lm_step`` kernel of
``csrc/cond_graph.cu``, on the CPU its plain version
:func:`lm_step_reference`.  :func:`solve_pose_graph_lanes` reads the
condition once per iteration; ``core/solve_graph.py`` runs the same
iteration as a captured graph under a WHILE node, with no read.
"""

from __future__ import annotations

import contextlib
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
    """The scatters of :func:`_assemble_lanes`, which depend only on the
    edge set: made once per solve, used at every iteration."""

    h: ScatterPlan  # rows f·K+f, f·K+t, t·K+f, t·K+t of the (R·K·K, 9) blocks
    g: ScatterPlan  # rows f, t of an (R·K, 3) vector


def _one_lane(prob: PoseGraphProblem) -> PoseGraphProblem:
    """A problem as the one lane of a stacked problem (views)."""
    return PoseGraphProblem(*(x[None] for x in prob))


def normal_eq_plan(prob: PoseGraphProblem) -> NormalEqPlan:
    """:func:`_lane_plan` of one problem (its one lane's keys)."""
    return _lane_plan(_one_lane(prob))


def _assemble_normal_eqs(poses, prob: PoseGraphProblem, scale, est_scale: bool,
                         plan: NormalEqPlan | None = None):
    """Dense H = JᵀJ (N, N), g = Jᵀr (N,) and the cost of one problem, N =
    3K (+1 with scale): :func:`_assemble_lanes` of its one lane.  ``plan``
    (made from ``prob`` if None) holds its sorted keys."""
    one = _one_lane(prob)
    plan = _lane_plan(one) if plan is None else plan
    scale = torch.as_tensor(scale, dtype=torch.float32, device=poses.device).reshape(1)
    h, g, cost = _assemble_lanes(poses[None], _flat_edges(one), scale, est_scale, plan)
    return h[0], g[0], cost[0]


def _pin(h: torch.Tensor, g: torch.Tensor, free: torch.Tensor):
    """Clamp non-free variables: unit diagonal rows/cols, zero gradient;
    over lanes ``(R, N, N)``, ``(R, N)``, ``free`` (R, N), or one problem."""
    fm = free.to(h.dtype)
    h = h * fm[..., :, None] * fm[..., None, :] + torch.diag_embed(1.0 - fm)
    return h, g * fm


def _lane_plan(prob: PoseGraphProblem) -> NormalEqPlan:
    """The scatter plans of a stacked problem's normal equations, lane r's
    rows offset by r·K·K (H) and r·K (g): the lanes' keys stay disjoint,
    and each lane's sums keep the order that its own plan gives them.  A
    dead edge's blocks are exact zeros (its Jacobians are masked), so its
    rows are spread (:func:`spread_masked`) rather than all left at slot
    0's."""
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
    """The normal equations of each lane: ``poses`` (R, K, 3), ``flat`` the
    lanes' edges (:func:`_flat_edges`), ``scale`` (R,) → (R, N, N) H, (R,
    N) g and the (R,) costs.  The (K, 3, K, 3) block scatter-add of a lane
    is one fixed-order :func:`index_add_ordered` of its four edge blocks
    into the rows of a (K·K, 9) tensor, permuted at the end; every lane's
    in one launch, each lane's sums in its own plan's order."""
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


# ---------------------------------------------------------------------------
# The LM loop's carry on the device
# ---------------------------------------------------------------------------

# The control words (int32), csrc/cond_graph.cu's kIt and kLoop.
IT, LOOP = 0, 1
CONTROL_WORDS = 2


@dataclasses.dataclass
class LMControl:
    """The damping schedule's state of R lanes, on the device: what the
    ``lm_step`` kernel reads and writes (and ``core/solve_graph.py``'s
    trigger kernel sets up)."""

    mu: torch.Tensor  # (R,) f32 damping
    active: torch.Tensor  # (R,) bool: the lane still iterates
    accept: torch.Tensor  # (R,) bool: the last iteration's step was accepted
    small: torch.Tensor  # (R,) bool: ... and its relative cost drop was below rtol
    ctl: torch.Tensor  # (≥ CONTROL_WORDS,) i32: the iteration count, the loop condition


def lm_control(lanes: int, device: torch.device, ctl: Optional[torch.Tensor] = None) -> LMControl:
    """Zeroed control buffers for ``lanes`` lanes (``ctl``: words of a
    larger control block to use)."""
    z = lambda dtype: torch.zeros(lanes, dtype=dtype, device=device)
    ctl = torch.zeros(CONTROL_WORDS, dtype=torch.int32, device=device) if ctl is None else ctl
    return LMControl(mu=z(torch.float32), active=z(torch.bool), accept=z(torch.bool), small=z(torch.bool), ctl=ctl)


@dataclasses.dataclass
class LMCarry:
    """A stacked problem made ready for the LM loop, and the loop's x and
    cost: what :func:`lm_iterate` reads, and x and the cost, which it
    updates in place."""

    cfg: SolverConfig
    flat: PoseGraphProblem  # the lanes' edges (:func:`_flat_edges`)
    plan: NormalEqPlan
    fm: torch.Tensor  # (R, N) f32: 1 for a free variable
    pose_mask: torch.Tensor  # (R, K) live slots
    poses0: torch.Tensor  # (R, K, 3) the initial poses: a dead slot keeps its own
    x: torch.Tensor  # (R, N)
    cost: torch.Tensor  # (R,)


def _unpack(x: torch.Tensor, k: int, est_scale: bool):
    """(R, N) x → poses (R, K, 3), scale (R,)."""
    poses = x[:, : 3 * k].reshape(x.shape[0], k, 3)
    scale = x[:, 3 * k] if est_scale else torch.ones(x.shape[0], device=x.device)
    return poses, scale


def _pack(poses: torch.Tensor, scale: torch.Tensor, est_scale: bool) -> torch.Tensor:
    x = poses.reshape(poses.shape[0], -1)
    return torch.cat([x, scale.reshape(-1, 1)], dim=1) if est_scale else x


def _norm_poses(poses: torch.Tensor) -> torch.Tensor:
    return torch.cat([poses[..., :2], normalize_angle(poses[..., 2:3])], dim=-1)


def _cost_of(x: torch.Tensor, flat: PoseGraphProblem, k: int, est_scale: bool) -> torch.Tensor:
    poses, scale = _unpack(x, k, est_scale)
    r_ = x.shape[0]
    return _lane_costs(residuals(poses.reshape(r_ * k, 3), flat, _edge_scale(scale, flat)), r_)


def _write_into(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, field by field (named tuples
    nested; None stays None)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for d, s in zip(dst, src):
            _write_into(d, s)


def lm_setup(prob: PoseGraphProblem, cfg: SolverConfig, *, init_scale: float = 1.0, scale_free: bool = False,
             into: Optional[LMCarry] = None) -> LMCarry:
    """The LM carry of the stacked ``prob`` (every leaf on a leading lane
    axis): its flat edges, scatter plans and pin mask, x0 (poses with
    their angles wrapped, the scale) and its cost.  ``into``: a carry of
    the same shapes whose buffers take the values (a captured graph's
    fixed addresses); else new tensors."""
    dev = prob.poses.device
    r_, k = prob.poses.shape[:2]
    free = prob.pose_mask.repeat_interleave(3, dim=1).clone()
    free[:, :3] = False  # pin base slot 0
    if cfg.estimate_scale:
        free = torch.cat([free, torch.full((r_, 1), bool(scale_free), device=dev)], dim=1)
    flat = _flat_edges(prob)
    x = _pack(_norm_poses(prob.poses), torch.full((r_,), init_scale, dtype=torch.float32, device=dev),
              cfg.estimate_scale)
    carry = LMCarry(cfg=cfg, flat=flat, plan=_lane_plan(prob), fm=free.to(torch.float32), pose_mask=prob.pose_mask,
                    poses0=prob.poses, x=x, cost=_cost_of(x, flat, k, cfg.estimate_scale))
    if into is None:
        return carry
    for f in dataclasses.fields(LMCarry):
        if f.name != "cfg":
            _write_into(getattr(into, f.name), getattr(carry, f.name))
    return into


def lm_begin(control: LMControl, run: torch.Tensor, cfg: SolverConfig) -> None:
    """The loop's start, with no host read: μ = μ_init, the lanes of
    ``run`` (R,) active (if μ_init is below μ_max), count 0, the condition
    ``any(active) and max_iterations > 0`` (JAX's ``cond`` at the start):
    the plain version of what ``core/solve_graph.py``'s trigger kernel
    sets."""
    control.mu.fill_(cfg.mu_init)
    control.active.copy_(run & bool(np.float32(cfg.mu_init) < np.float32(cfg.mu_max)))
    control.ctl[IT] = 0
    control.ctl[LOOP] = (control.active.any() & (cfg.max_iterations > 0)).to(torch.int32)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER for ``cholesky_ex`` on a card, whatever the batch (cuSOLVER's
    ``potrf`` for one matrix, ``potrfBatched`` for more; never MAGMA, whose
    calls do not capture into a graph): the same for the host loop and the
    captured graph."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _lm_assemble(carry: LMCarry):
    """The normal equations of every lane at x → (H, g, cost)."""
    poses, scale = _unpack(carry.x, carry.poses0.shape[1], carry.cfg.estimate_scale)
    return _assemble_lanes(poses, carry.flat, scale, carry.cfg.estimate_scale, carry.plan)


def _lm_damp(carry: LMCarry, control: LMControl, h: torch.Tensor, g: torch.Tensor):
    """H and g pinned (:func:`_pin`), H damped with each lane's μ → (H + μ·diag H, g)."""
    h, g = _pin(h, g, carry.fm)
    return h + control.mu[:, None, None] * torch.diag_embed(torch.diagonal(h, dim1=-2, dim2=-1)), g


def _lm_factor(hd: torch.Tensor):
    """``cholesky_ex``, not ``cholesky``: a non-PD matrix must reject the
    step (as JAX's NaN factor does), not raise, and its status stays on
    the device → (L, status)."""
    with _cusolver(hd.device):
        return torch.linalg.cholesky_ex(hd)


# Lanes per triangular solve: PyTorch solves up to 8 matrices of n ≥ 64 one
# by one with cuBLAS's trsm, more than 8 of n > 512 with MAGMA, whose calls
# do not capture into a graph.
TRSM_LANES = 8


def _lm_solve(chol: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The step δ of each lane: L y = −g, then Lᵀ δ = y, two triangular
    solves (what LAPACK's ``potrs`` does), at most :data:`TRSM_LANES` lanes
    at a time.  Not ``cholesky_solve``: on a card that sends one matrix to
    cuSOLVER's 64-bit ``potrs``, which allocates memory inside a capture
    (memory nodes, which a conditional body cannot hold)."""
    parts = []
    for lo in range(0, chol.shape[0], TRSM_LANES):
        l = chol[lo:lo + TRSM_LANES]
        y = torch.linalg.solve_triangular(l, -g[lo:lo + TRSM_LANES, :, None], upper=False)
        parts.append(torch.linalg.solve_triangular(l.mT, y, upper=True)[:, :, 0])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _lm_take(carry: LMCarry, control: LMControl, delta: torch.Tensor, status: torch.Tensor) -> None:
    """The step's new x and cost, ``accept`` and ``small``, and x and the
    cost taken where the lane is active and accepts (as a vmapped
    ``while_loop`` freezes a finished lane)."""
    x, cost, est = carry.x, carry.cost, carry.cfg.estimate_scale
    k = carry.poses0.shape[1]
    solve_ok = (status == 0) & torch.all(torch.isfinite(delta), dim=1)
    x_new = x + torch.where(solve_ok[:, None], delta, 0.0)
    p_new, s_new = _unpack(x_new, k, est)
    x_new = _pack(_norm_poses(p_new), s_new, est)
    new_cost = _cost_of(x_new, carry.flat, k, est)
    accept = solve_ok & (new_cost < cost)
    rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
    take = accept & control.active
    control.accept.copy_(accept)
    control.small.copy_(rel_drop < carry.cfg.rtol)
    x.copy_(torch.where(take[:, None], x_new, x))
    cost.copy_(torch.where(take, new_cost, cost))


def lm_iterate(carry: LMCarry, control: LMControl) -> None:
    """One LM iteration of every lane over fixed buffers, with no host
    read: assemble, pin, damp with each lane's μ, ``cholesky_ex``, the
    two triangular solves, the step and its cost, ``accept`` and
    ``small``, x and the cost updated in place (the stages ``stagebench``
    times)."""
    h, g, _ = _lm_assemble(carry)
    hd, g = _lm_damp(carry, control, h, g)
    chol, status = _lm_factor(hd)
    _lm_take(carry, control, _lm_solve(chol, g), status)


def lm_step_reference(control: LMControl, cfg: SolverConfig) -> None:
    """The ``lm_step`` kernel's plain version: for each active lane, on
    accept μ = max(μ / f, μ_min) and the lane stops if ``small``, on reject
    μ = min(μ · f, μ_max); a lane stops once μ ≥ μ_max.  Then count + 1
    and the loop condition ``any(active) and count < max_iterations``
    (JAX's ``cond``).  The damping is the host schedule's float32, bit for
    bit: μ / f divides (a device tensor divisor, never a reciprocal)."""
    mu, active = control.mu, control.active
    f32 = dict(dtype=torch.float32, device=mu.device)
    factor = torch.full((), cfg.mu_factor, **f32)
    up = torch.maximum(mu / factor, torch.full((), cfg.mu_min, **f32))
    down = torch.minimum(mu * factor, torch.full((), cfg.mu_max, **f32))
    new = torch.where(control.accept, up, down)
    mu.copy_(torch.where(active, new, mu))
    active &= ~(control.accept & control.small) & (new < cfg.mu_max)
    ctl = control.ctl
    ctl[IT] += 1
    ctl[LOOP] = (active.any() & (ctl[IT] < cfg.max_iterations)).to(torch.int32)


def lm_step(control: LMControl, cfg: SolverConfig, force: Optional[str] = None) -> None:
    """The damping schedule's step: the ``lm_step`` kernel on a card
    (outside a graph: no conditional handle), :func:`lm_step_reference`
    for CPU tensors.  ``force`` ∈ {"kernel", "reference"} pins the choice.
    ``lm_step.launches`` counts kernel launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and control.mu.is_cuda):
        from nislam_torch.kernels.launch import launch_lm_step

        launch_lm_step(control, cfg)
        lm_step.launches += 1
    else:
        lm_step_reference(control, cfg)


lm_step.launches = 0


def lm_result(carry: LMCarry) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(poses (R, K, 3), scale (R,), cost (R,))`` of the carry: a dead
    slot keeps its initial pose."""
    poses, scale = _unpack(carry.x, carry.poses0.shape[1], carry.cfg.estimate_scale)
    return torch.where(carry.pose_mask[..., None], poses, carry.poses0), scale, carry.cost


def solve_pose_graph_lanes(
    prob: PoseGraphProblem, cfg: SolverConfig = SolverConfig(), *,
    init_scale: float = 1.0, scale_free: bool = False, trace: Optional[list] = None,
    run: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """R problems stacked on a leading lane axis (every leaf), in one LM
    loop → ``(poses (R, K, 3), scale (R,), final_cost (R,))``.  Each
    iteration is :func:`lm_iterate` (one batched ``cholesky_ex``) and
    :func:`lm_step`, then one host read of the loop condition.  Each lane
    keeps its own damping μ and its own stop; a lane that has stopped
    keeps its x and cost.  Each lane's result is the R = 1 solve's of that
    lane, bit for bit where the batched operations compute each lane as
    the single ones do (LAPACK factors each matrix alone).  ``run`` (R,)
    bool: the lanes that solve (None: all); the others never iterate.
    ``trace``, a list, gets each iteration's flags: per lane ``(accept,
    small)``, or None for a lane that had stopped."""
    dev = prob.poses.device
    carry = lm_setup(prob, cfg, init_scale=init_scale, scale_free=scale_free)
    control = lm_control(prob.poses.shape[0], dev)
    lm_begin(control, torch.ones_like(control.active) if run is None else run, cfg)
    while bool(control.ctl[LOOP]):  # the one host read of an iteration
        lm_iterate(carry, control)
        if trace is not None:
            flags = torch.stack([control.active, control.accept, control.small], dim=1).tolist()
            trace.append([(a, s) if on else None for on, a, s in flags])
        lm_step(control, cfg)
    return lm_result(carry)


def solve_pose_graph(
    prob: PoseGraphProblem, cfg: SolverConfig = SolverConfig(), *,
    init_scale: float = 1.0, scale_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM solve of one problem → ``(poses, scale, final_cost)``: the R = 1
    case of :func:`solve_pose_graph_lanes`."""
    poses, scale, cost = solve_pose_graph_lanes(_one_lane(prob), cfg, init_scale=init_scale, scale_free=scale_free)
    return poses[0], scale[0], cost[0]
