"""The fixed-order scatter-add: its plain version, its three call sites, the kernel.

On the CPU, ``index_add_ordered`` is ``index_add_``, which adds source rows
one after another in index order; every comparison here is bit for bit
(``torch.equal`` on the float bits), because that order is the function's
contract and the kernel's.  The call sites, which each merge several
accumulating scatters into one, are held bit for bit against the code
they replaced (copied below), so the port's CPU results did not move.
The cases marked ``gpu`` run the kernel on the card against the plain
version on CPU copies of the same inputs, bit for bit, and skip without a
CUDA device.
"""

import numpy as np
import pytest
import torch

import nislam_torch.core.camera as tcam
import nislam_torch.core.pose_graph as tpg
import nislam_torch.core.stitcher as tst
import nislam_torch.parallel.solver as tsolver
from nislam_torch.core.config import CameraConfig, MapStitcherConfig
from nislam_torch.ops import scatter_add as tsa
from nislam_torch.utils.scaling import chain_problem

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scatter_add kernel has no CPU mode")
    return torch.device("cuda")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def sequential(out: np.ndarray, keys: np.ndarray, src: np.ndarray) -> np.ndarray:
    """The contract, one float32 add at a time in index order."""
    out = out.copy()
    for i, k in enumerate(keys):
        out[k] = out[k] + src[i]
    return out


def ragged_case(rng, s: int, c: int | None):
    """Keys over S rows with empty rows, single rows and one long run (row
    3 takes a fifth of the keys), shuffled; a non-zero starting ``out``."""
    n = 5 * s
    keys = rng.integers(0, s // 2, n)  # rows s/2 .. s-1 stay empty
    keys[rng.random(n) < 0.2] = 3
    keys[0] = s - 1  # one row with a single key
    shape = (s,) if c is None else (s, c)
    out = rng.standard_normal(shape).astype(np.float32)
    src = (rng.standard_normal((n,) + shape[1:]) * 10.0 ** rng.integers(-3, 4, (n,) + shape[1:])).astype(np.float32)
    return out, keys, src


@pytest.mark.parametrize("s, c", [(64, None), (64, 1), (37, 9), (500, 3)])
def test_plain_version_is_the_sequential_order(rng, s, c):
    out, keys, src = ragged_case(rng, s, c)
    got = tsa.index_add_ordered(torch.from_numpy(out.copy()), torch.from_numpy(keys), torch.from_numpy(src))
    assert bits_equal(got, torch.from_numpy(sequential(out, keys, src)))
    plan = tsa.ScatterPlan.of(torch.from_numpy(keys).int())
    again = tsa.index_add_ordered(torch.from_numpy(out.copy()), plan, torch.from_numpy(src))
    assert bits_equal(again, got)
    assert plan.keys.dtype == torch.int64 and plan.sorted_keys is None  # no sort on the CPU


def test_empty_source_leaves_out_alone():
    out = torch.arange(6.0).reshape(3, 2)
    got = tsa.index_add_ordered(out.clone(), torch.zeros(0, dtype=torch.int64), torch.zeros(0, 2))
    assert bits_equal(got, out)


@pytest.mark.parametrize("bad", [-1, 8])
def test_bad_key_raises_on_the_cpu(bad):
    out = torch.zeros(8, 3)
    with pytest.raises(RuntimeError, match="out of bounds"):
        tsa.index_add_ordered(out, torch.tensor([1, bad, 2]), torch.ones(3, 3))


def test_force_routing():
    out, keys, src = torch.zeros(4, 2), torch.tensor([0, 3, 0]), torch.ones(3, 2)
    before = tsa.index_add_ordered.launches
    assert bits_equal(tsa.index_add_ordered(out.clone(), keys, src, force="reference"),
                      tsa.index_add_ordered(out.clone(), keys, src))
    assert tsa.index_add_ordered.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        tsa.index_add_ordered(out, keys, src, force="kernel")  # a CPU tensor cannot take the kernel
    with pytest.raises(ValueError):
        tsa.index_add_ordered(out, keys, src, force="atomics")


# ---------------------------------------------------------------------------
# The call sites against the code they replaced
# ---------------------------------------------------------------------------


def old_assemble_normal_eqs(poses, prob, scale, est_scale):
    """``_assemble_normal_eqs`` before the fixed-order scatter: six
    accumulating ``index_put_`` (eight with scale)."""
    k = poses.shape[0]
    r = tpg.residuals(poses, prob, scale)
    cost = 0.5 * torch.sum(r * r)
    ja, jb, js = tpg._edge_jacobians(poses, prob, scale)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    ga = torch.einsum("eji,ej->ei", ja, r)
    gb = torch.einsum("eji,ej->ei", jb, r)
    f, t = prob.from_slot.long(), prob.to_slot.long()
    h4 = torch.zeros((k, k, 3, 3), dtype=torch.float32)
    h4.index_put_((f, f), haa, accumulate=True)
    h4.index_put_((f, t), hab, accumulate=True)
    h4.index_put_((t, f), hab.transpose(-1, -2), accumulate=True)
    h4.index_put_((t, t), hbb, accumulate=True)
    g = torch.zeros((k, 3), dtype=torch.float32)
    g.index_put_((f,), ga, accumulate=True)
    g.index_put_((t,), gb, accumulate=True)
    h = h4.permute(0, 2, 1, 3).reshape(3 * k, 3 * k)
    g = g.reshape(3 * k)
    if est_scale:
        hs_col = torch.zeros((k, 3), dtype=torch.float32)
        hs_col.index_put_((f,), torch.einsum("eij,ei->ej", ja, js), accumulate=True)
        hs_col.index_put_((t,), torch.einsum("eij,ei->ej", jb, js), accumulate=True)
        hs_col = hs_col.reshape(3 * k)
        hss = torch.sum(js * js)
        gs = torch.sum(js * r)
        h = torch.cat([torch.cat([h, hs_col[:, None]], dim=1),
                       torch.cat([hs_col[None, :], hss.reshape(1, 1)], dim=1)], dim=0)
        g = torch.cat([g, gs[None]])
    return h, g, cost


def perturbed(prob, seed: int):
    rng = np.random.default_rng(seed)
    poses = prob.poses + torch.from_numpy((0.05 * rng.standard_normal(prob.poses.shape)).astype(np.float32))
    return prob._replace(poses=poses)


@pytest.mark.parametrize("k, e", [(24, 64), (64, 256)])
@pytest.mark.parametrize("est_scale", [False, True])
def test_normal_equations_bit_equal_to_index_put(k, e, est_scale):
    """The four H blocks in one scatter, g (and the scale column) in one
    each: H, g and the cost equal the six (eight) ``index_put_`` bit for
    bit, on a chain with masked edges (all at slot 0: a long run)."""
    prob = perturbed(chain_problem(k, e, seed=1), 2)
    scale = torch.tensor(1.03)
    new = tpg._assemble_normal_eqs(prob.poses, prob, scale, est_scale, tpg.normal_eq_plan(prob))
    old = old_assemble_normal_eqs(prob.poses, prob, scale, est_scale)
    for a, b, name in zip(new, old, ("H", "g", "cost")):
        assert bits_equal(a, b), name


def test_normal_equations_in_fixed_order_at_config_hd_size():
    """At K = 1024 / E = 4096 the CPU's multi-threaded ``index_put_`` may
    accumulate in another order; the new H is the sequential sum."""
    prob = perturbed(chain_problem(1024, 4096, seed=1), 3)
    k, e = 1024, 4096
    plan = tpg.normal_eq_plan(prob)
    h, _, _ = tpg._assemble_normal_eqs(prob.poses, prob, torch.tensor(1.0), False, plan)
    ja, jb, _ = tpg._edge_jacobians(prob.poses, prob, torch.tensor(1.0))
    blocks = torch.cat([torch.einsum("eji,ejk->eik", ja, ja), torch.einsum("eji,ejk->eik", ja, jb),
                        torch.einsum("eji,ejk->eik", jb, ja), torch.einsum("eji,ejk->eik", jb, jb)])
    want = sequential(np.zeros((k * k, 9), np.float32), plan.h.keys.numpy(), blocks.reshape(4 * e, 9).numpy())
    assert bits_equal(h, torch.from_numpy(want).view(k, k, 3, 3).permute(0, 2, 1, 3).reshape(3 * k, 3 * k))


def old_solver_scatter(k, from_slot, to_slot, va, vb):
    out = torch.zeros((k, 3), dtype=va.dtype)
    out.index_add_(0, from_slot, va)
    out.index_add_(0, to_slot, vb)
    return out


def test_solver_scatter_bit_equal_to_index_add(rng):
    """GN-CG's per-slot sums (gradient, diagonal, Hessian-vector product):
    one scatter of ``cat([va, vb])`` at ``cat([f, t])`` equals the two
    ``index_add_`` it replaced; so does a whole local step."""
    prob = perturbed(chain_problem(64, 256, seed=4), 5)
    f, t = prob.from_slot.long(), prob.to_slot.long()
    plan = tsa.ScatterPlan.of(torch.cat([f, t]))
    va, vb = (torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32)) for _ in range(2))
    assert bits_equal(tsolver._scatter(64, plan, va, vb), old_solver_scatter(64, f, t, va, vb))
    gd, ja, jb = tsolver._local_grad_and_diag(prob.poses, prob, plan)
    r = tpg.residuals(prob.poses, prob, 1.0)
    want_g = old_solver_scatter(64, f, t, torch.einsum("eij,ei->ej", ja, r), torch.einsum("eij,ei->ej", jb, r))
    assert bits_equal(gd[0], want_g)
    x = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    jx = torch.einsum("eij,ej->ei", ja, x[f]) + torch.einsum("eij,ej->ei", jb, x[t])
    want_hx = old_solver_scatter(64, f, t, torch.einsum("eij,ei->ej", ja, jx), torch.einsum("eij,ei->ej", jb, jx))
    assert bits_equal(tsolver._local_jtj_vec(ja, jb, f, t, plan, x), want_hx)


H, W = 48, 64
CAMERA = CameraConfig(image_width=W, image_height=H, height=1.0, intrinsics=(60.0, 31.0, 62.0, 24.5))
STITCH = MapStitcherConfig(canvas_size=192, canvas_center=(20, -10))


def old_stitch_scatter(canvas, images, poses, camera, enabled, sign):
    """The stitcher's scatter before the fixed-order scatter: two flat
    ``index_add_``."""
    h, w = images.shape[-2], images.shape[-1]
    xi, yi = tst._frame_targets((h, w), poses, camera)
    s = canvas.size
    col = xi - canvas.center_x + s // 2
    row = yi - canvas.center_y + s // 2
    inb = (col >= 0) & (col < s) & (row >= 0) & (row < s)
    en = torch.as_tensor(enabled, dtype=torch.bool)
    ok = inb & en.reshape(en.shape + (1, 1))
    idx = torch.where(ok, row * s + col, 0).reshape(-1).long()
    vals = torch.where(ok, images * (sign * 100.0), 0.0).reshape(-1)
    wts = sign * ok.to(torch.float32).reshape(-1)
    canvas.data.view(-1).index_add_(0, idx, vals)
    canvas.weight.view(-1).index_add_(0, idx, wts)
    return canvas


def test_stitcher_scatter_bit_equal_to_index_add(rng):
    """Single inserts (one disabled, one negated, frames partly off the
    canvas) and a recompute batch of several frames: both canvases equal
    the two ``index_add_`` bit for bit."""
    camera = tcam.make_camera_ops(CAMERA)
    imgs = torch.from_numpy(rng.random((8, H, W)).astype(np.float32))
    poses = torch.from_numpy((rng.standard_normal((8, 3)) * [0.6, 0.6, 2.0]).astype(np.float32))
    new, old = tst.make_canvas(STITCH, torch.device("cpu")), tst.make_canvas(STITCH, torch.device("cpu"))
    for i, (enabled, sign) in enumerate([(True, 1.0), (True, 1.0), (False, 1.0), (True, -1.0), (True, 1.0)]):
        tst.insert_frame(new, imgs[i], poses[i], camera, enabled=torch.tensor(enabled), sign=sign)
        old_stitch_scatter(old, imgs[i], poses[i], camera, enabled, sign)
    tst._scatter(new, imgs[5:], poses[5:], camera, True, 1.0)
    old_stitch_scatter(old, imgs[5:], poses[5:], camera, True, 1.0)
    assert bits_equal(new.data, old.data) and bits_equal(new.weight, old.weight)
    assert float(new.weight.sum()) > 0


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("s, c", [(64, None), (37, 9), (500, 3), (50, 5), (1 << 20, None)])
def test_kernel_matches_plain_version_bit_for_bit(cuda, s, c):
    """Channel counts 1, 3 and 9 in registers, 5 one channel at a time."""
    out, keys, src = ragged_case(np.random.default_rng(s), s, c)  # no conftest on the card
    want = tsa.index_add_ordered(torch.from_numpy(out.copy()), torch.from_numpy(keys), torch.from_numpy(src))
    before = tsa.index_add_ordered.launches
    plan = tsa.ScatterPlan.of(torch.from_numpy(keys).to(cuda))
    got = tsa.index_add_ordered(torch.from_numpy(out.copy()).to(cuda), plan, torch.from_numpy(src).to(cuda))
    again = tsa.index_add_ordered(torch.from_numpy(out.copy()).to(cuda), plan, torch.from_numpy(src).to(cuda))
    tsa.raise_on_bad_keys(cuda)
    assert tsa.index_add_ordered.launches == before + 2
    assert bits_equal(got.cpu(), want) and bits_equal(again, got)


@pytest.mark.gpu
def test_kernel_reports_a_bad_key(cuda):
    out = torch.zeros(8, 3, device=cuda)
    tsa.index_add_ordered(out, torch.tensor([1, 9, 2, -4], device=cuda), torch.ones(4, 3, device=cuda))
    with pytest.raises(IndexError):
        tsa.raise_on_bad_keys(cuda)
    want = torch.zeros(8, 3)
    want[1] = want[2] = 1.0
    assert torch.equal(out.cpu(), want)  # the good keys are added, the bad never written
    tsa.raise_on_bad_keys(cuda)  # the report was taken


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    keys = torch.tensor([0, 1], device=cuda)
    with pytest.raises(TypeError):
        tsa.index_add_ordered(torch.zeros(4, 2, dtype=torch.float64, device=cuda), keys,
                              torch.ones(2, 2, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        tsa.index_add_ordered(torch.zeros(4, 2, device=cuda), keys, torch.ones(3, 2, device=cuda))
    with pytest.raises(ValueError):
        tsa.index_add_ordered(torch.zeros(4, 2, device=cuda)[:, :1], keys, torch.ones(2, 1, device=cuda))
