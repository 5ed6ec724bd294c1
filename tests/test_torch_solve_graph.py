"""The deferred pose-graph trigger as one graph (``nislam_torch.core.solve_graph``) on the CPU.

On the CPU the solve graph runs as its plain program: ``solve_body``'s
steps as a loop on the host over the frame graph's buffers (the trigger's
and ``lm_step``'s plain versions; the setup, the LM iteration and the
finish eagerly).  The states are made by hand at a small size (24 slots,
64 edges, 32 pending slots): a ring of 20 keyframes with noisy poses, an
odometry edge between neighbours and pending loop matches, so that every
case is exact and cheap:

- the engine's trigger equals the host loop (``optimize_host_loop``,
  ``finalize_host_loop``) bit for bit, in its decisions and every state
  leaf, for the single engine (with and without the online canvas) and
  for 8 lanes of the batch engine, with 0, 1 and ≥ 2 live pending
  matches, a match voided by eviction, entries past the count, a solve
  that stops on a small cost drop, one whose every step is rejected
  until μ reaches μ_max, and ``max_iterations`` reached;
- against JAX's ``maybe_optimize`` and ``check_and_optimize_final``:
  decisions equal, poses and chain within 2e-3;
- ``lm_step``'s plain version against the host's ``np.float32`` schedule
  at μ_min and μ_max, and the trigger's against the live count;
- the masked edge loop (``add_edge_lanes``) against ``add_edge`` one lane
  and one edge at a time, bit for bit, on stores that reclaim dead slots,
  append, replace KCC edges and drop;
- on a card (``gpu`` marker, skipped here): the graph against the host
  loop bit for bit, no host sync inside a launch, the captured steps'
  node types and the built graph's nodes.

JAX is imported only inside the test that compares with it, so the
``gpu`` cases run on a card without it (``--noconftest``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import nislam_torch.core.pose_graph as tpg
import nislam_torch.core.solve_graph as tsg
from nislam_torch.core.config import CameraConfig, CFConfig, MapConfig, MapStitcherConfig, SlamConfig
from nislam_torch.core.frame_graph import lane_view
from nislam_torch.core.map_store import EDGE_KCC, EDGE_LOOP, add_edge, add_edge_lanes
from nislam_torch.core.se2 import relative_pose
from nislam_torch.core.slam import (
    finalize_host_loop, make_engine, map_state, optimize_host_loop, state_leaves, state_to_numpy,
)
from nislam_torch.parallel import make_batch_engine
from nislam_torch.parallel import batch as tbatch

torch.set_num_threads(1)  # one reduction order, as the batch tests keep

H, W = 64, 96
K, E = 24, 64
N_KF = 20  # keyframes in each bank
CPU = torch.device("cpu")
POSE_ATOL = 2e-3  # against JAX: another LM's rounding
# Each case's pending matches (loop slot, current slot) and count: -1 is a
# match voided by eviction; entries past the count are stale.
CASES = {
    "none": ([], 0),
    "one": ([(1, 17)], 1),
    "voided": ([(1, 17), (-1, 16)], 2),
    "run": ([(1, 17), (-1, 16), (2, 18), (0, 15)], 4),
    "stale": ([(1, 17), (2, 18), (3, 19), (4, 14)], 2),
    "mu_max": ([(1, 17), (2, 18)], 2),  # slot 19 joined by no edge: H is singular, every step rejected
}
BATCH_CASES = ("none", "run", "one", "mu_max", "voided", "stale", "run", "none")


def _config(**optimizer):
    config = SlamConfig(
        cf=CFConfig(width=W, height=H, rotation_divisor=90, rotation_channel=48),
        map=MapConfig(grid_scale=0.15, keyframe_capacity=K, edge_capacity=E),
        camera=CameraConfig(image_width=W, image_height=H, height=1.0,
                            intrinsics=(100.0, W / 2.0, 100.0, H / 2.0)),
    )
    if optimizer.pop("online", False):
        config = dataclasses.replace(config, map_stitcher=MapStitcherConfig(
            stitch_map=True, online=True, canvas_size=128))
    return dataclasses.replace(config, optimizer=dataclasses.replace(config.optimizer, **optimizer))


def _fill(state, camera, case: str, seed: int) -> None:
    """One lane's state (views) made a ring of ``N_KF`` keyframes with an
    odometry edge between neighbours and ``case``'s pending matches."""
    rng = np.random.default_rng(seed)
    dev = state.bank.count.device
    host = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    t = np.arange(N_KF) * 2 * np.pi / N_KF
    truth = host(np.stack([0.5 * np.cos(t), 0.5 * np.sin(t), np.mod(t + np.pi / 2 + np.pi, 2 * np.pi) - np.pi], 1))
    noise = rng.normal(0, 1, (N_KF, 3)) * [0.02, 0.02, 0.01]
    noise[0] = 0
    bank, edges, pending, track = state.bank, state.edges, state.pending, state.track
    bank.poses[:N_KF] = truth + host(noise)
    bank.count.fill_(N_KF)
    pairs = [(i, i + 1) for i in range(N_KF - 1) if case != "mu_max" or i + 1 < N_KF - 1]
    f, to = (torch.tensor(x, device=dev) for x in zip(*pairs))
    meas = camera.robot_to_camera(relative_pose(truth[f], truth[to]))
    m = len(pairs)
    edges.from_slot[:m], edges.to_slot[:m] = f.int(), to.int()
    edges.T[:m] = meas + host(rng.normal(0, 0.002, (m, 3)))
    edges.info[:m] = torch.diag(host([400.0, 400.0, 2500.0]))
    edges.types[:m] = EDGE_KCC
    edges.alive[:m] = True
    edges.count.fill_(m)
    matches, count = CASES[case]
    for i, (a, b) in enumerate(matches):
        rel = relative_pose(truth[max(a, 0)], truth[b]) + host(rng.normal(0, 0.003, 3))
        pending.loop_slot[i], pending.cur_slot[i] = a, b
        pending.rel_pose[i] = camera.camera_to_image_plane(camera.robot_to_camera(rel))
    pending.count.fill_(count)
    track.last_slot.fill_(N_KF - 1)
    track.initialized.fill_(True)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _assert_states_equal(a, b) -> None:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        assert _same_bits(x.cpu(), y.cpu()), f"state leaf {i}"


def _single(config, case: str, device=CPU, seed: int = 3):
    engine = make_engine(config, device)
    state = engine.init_state()
    _fill(state, engine.camera, case, seed)
    return engine, state


def _control(engine):
    """The solve graph's control words and μ after its last trigger."""
    sg = engine.solve_graph
    return sg.ctl.tolist(), sg.control.mu.tolist()


@pytest.mark.parametrize("case,options", [(c, {}) for c in CASES] + [
    ("run", {"max_iterations": 3}), ("run", {"max_iterations": 0}), ("run", {"online": True}),
    ("run", {"with_scale": True})])
def test_single_trigger_equals_host_loop(case, options):
    """The engine's trigger (the plain program) and its host loop, on the
    same state, in both orders of ``optimize`` and ``finalize``: decisions
    and every state leaf bit for bit."""
    config = _config(**options)
    engine, state = _single(config, case)
    for trigger, host in ((engine.optimize, optimize_host_loop), (engine.finalize, finalize_host_loop)):
        want = map_state(state, torch.clone)
        got, ran = trigger(map_state(state, torch.clone))
        want, want_ran = host(engine, want)
        assert ran == want_ran == (case in ("run", "stale", "mu_max"))
        _assert_states_equal(got, want)
    ctl, mu = _control(engine)
    if case == "mu_max":  # every step rejected: μ × 10 from 1e-4 to its 1e8 cap (13 float32 steps)
        assert mu[0] == np.float32(1e8) and ctl[tpg.IT] == 13
    elif "max_iterations" in options:  # 0: the graph holds no WHILE, as JAX's cond is false at the start
        assert ctl[tpg.IT] == options["max_iterations"]
    elif case == "run":  # stopped on a small cost drop, μ still below its cap
        assert 1 < ctl[tpg.IT] < config.optimizer.max_iterations and mu[0] < 1e8
    if case in ("run", "stale"):
        assert int(got.edges.count) == N_KF - 1 + {"run": 3, "stale": 2}[case]


@pytest.mark.parametrize("options", [{}, {"max_iterations": 3}])
def test_batch_trigger_equals_host_loop(options):
    """8 lanes of the batch engine, each its own case: the trigger (every
    lane in one batched LM under the lane mask) and the host loop, bit for
    bit in every lane's state and the decisions."""
    engine = make_batch_engine(_config(**options), len(BATCH_CASES), device="cpu")
    states = engine.init_states()
    for b, case in enumerate(BATCH_CASES):
        _fill(lane_view(states, b), engine.camera, case, seed=b)
    for trigger, host in ((engine.optimize, tbatch.optimize_host_loop), (engine.finalize, tbatch.finalize_host_loop)):
        got, ran = trigger(map_state(states, torch.clone))
        want, want_ran = host(engine, map_state(states, torch.clone))
        assert ran == want_ran == [c in ("run", "stale", "mu_max") for c in BATCH_CASES]
        _assert_states_equal(got, want)


def test_single_trigger_matches_jax():
    """Against JAX's ``maybe_optimize`` and ``check_and_optimize_final`` on
    the same states: decisions, edges and pending counts equal, poses and
    the chain within 2e-3."""
    import jax.numpy as jnp

    from nislam_tpu.core.slam import make_engine as make_jax_engine

    config = _config()
    je = make_jax_engine(config)
    for case in ("voided", "run", "stale"):
        engine, state = _single(config, case)
        host = state_to_numpy(state)
        for trigger, jax_trigger in ((engine.optimize, je.optimize), (engine.finalize, je.finalize)):
            template = je.init_state()
            js = dataclasses.replace(template, **{
                part: dataclasses.replace(getattr(template, part), **{
                    f.name: jnp.asarray(getattr(getattr(host, part), f.name),
                                        dtype=getattr(getattr(template, part), f.name).dtype)
                    for f in dataclasses.fields(getattr(template, part))})
                for part in ("bank", "edges", "track", "pending")})
            js, jran = jax_trigger(js)
            got, ran = trigger(map_state(state, torch.clone))
            assert ran == bool(jran), case
            for part, names in (("edges", ("from_slot", "to_slot", "alive", "types", "count")), ("pending", ("count",))):
                for name in names:
                    np.testing.assert_array_equal(getattr(getattr(got, part), name).numpy(),
                                                  np.asarray(getattr(getattr(js, part), name)), err_msg=name)
            np.testing.assert_allclose(got.bank.poses.numpy(), np.asarray(js.bank.poses), atol=POSE_ATOL)
            np.testing.assert_allclose(got.track.last_pose.numpy(), np.asarray(js.track.last_pose), atol=POSE_ATOL)


def _host_schedule(mu, active, accept, small, cfg):
    """The host loop's damping step in ``np.float32``, lane by lane."""
    f, lo, hi = np.float32(cfg.mu_factor), np.float32(cfg.mu_min), np.float32(cfg.mu_max)
    mu, active = mu.copy(), active.copy()
    for i in range(len(mu)):
        if not active[i]:
            continue
        if accept[i]:
            mu[i] = max(mu[i] / f, lo)
            active[i] = not small[i]
        else:
            mu[i] = min(mu[i] * f, hi)
        active[i] &= mu[i] < hi
    return mu, active


def test_lm_step_plain_version_matches_host_schedule():
    """``lm_step_reference`` against the host's ``np.float32`` schedule,
    μ bit for bit, over steps from μ near μ_min and near μ_max; the count
    and the loop condition as JAX's ``cond``."""
    cfg = tpg.SolverConfig(max_iterations=7)
    rng = np.random.default_rng(11)
    starts = np.array([1e-9, 1e-8, 1.1e-8, 3e-9, 1e-4, 1e7, 1.2e7, 9.9e7, 1e8, 5e7, 2e-9, 1e-5], np.float32)
    control = tpg.lm_control(len(starts), CPU)
    control.mu.copy_(torch.from_numpy(starts))
    control.active.fill_(True)
    mu, active = starts, np.ones(len(starts), bool)
    for step in range(6):
        accept, small = rng.random(len(starts)) < 0.5, rng.random(len(starts)) < 0.2
        control.accept.copy_(torch.from_numpy(accept))
        control.small.copy_(torch.from_numpy(small))
        tpg.lm_step_reference(control, cfg)
        mu, active = _host_schedule(mu, active, accept, small, cfg)
        assert control.mu.numpy().tobytes() == mu.tobytes(), step
        assert control.active.numpy().tolist() == active.tolist(), step
        assert control.ctl.tolist() == [step + 1, int(active.any() and step + 1 < cfg.max_iterations)]
    assert np.float32(1e-9) in mu and np.float32(1e8) in mu  # both ends reached


def test_trigger_plain_version_counts_live_matches():
    """The trigger's plain version: run where ≥ 2 matches below the count
    are not voided; μ, the lane mask, the count and the conditions set."""
    cfg = tpg.SolverConfig()
    rng = np.random.default_rng(5)
    count = torch.from_numpy(rng.integers(0, 6, 16).astype(np.int32))
    slots = torch.from_numpy(rng.integers(-1, 4, (16, 32)).astype(np.int32))
    ctl = torch.zeros(tsg.CTL_WORDS, dtype=torch.int32)
    run = torch.zeros(16, dtype=torch.bool)
    control = tpg.lm_control(16, CPU, ctl)
    tsg.trigger(ctl, count, slots, run, control, cfg)
    live = [sum(1 for i in range(int(c)) if s[i] >= 0) for c, s in zip(count, slots)]
    assert run.tolist() == [n >= 2 for n in live] == [bool(x) for x in ctl[tsg.RUN:tsg.RUN + 16]]
    assert control.active.tolist() == run.tolist()
    assert control.mu.numpy().tobytes() == np.full(16, cfg.mu_init, np.float32).tobytes()
    assert ctl[:tsg.RUN].tolist() == [0, int(any(run)), int(any(run))]


def test_masked_edge_loop_equals_add_edge():
    """``add_edge_lanes`` over 4 lanes and 24 constraints against
    ``add_edge`` of each lane's enabled constraints one at a time: every
    leaf bit for bit, on stores with dead slots to reclaim, room to append,
    only KCC edges left to replace, and only loop edges (a drop)."""
    from nislam_torch.core.map_store import make_edge_store

    rng = np.random.default_rng(9)
    lanes, cap = 4, 12
    one = lambda: make_edge_store(MapConfig(edge_capacity=cap), CPU)
    stores = [one() for _ in range(lanes)]
    for b, st in enumerate(stores):
        n = [5, cap, cap, cap][b]
        st.count.fill_(n)
        st.alive[:n] = torch.from_numpy(rng.random(n) < [0.7, 0.8, 1.0, 1.0][b])
        st.types[:n] = EDGE_LOOP if b == 3 else torch.from_numpy(rng.integers(1, 3, n).astype(np.int32))
        st.from_slot[:n] = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    stacked = type(stores[0])(**{f.name: torch.stack([getattr(s, f.name) for s in stores])
                                 for f in dataclasses.fields(stores[0])})
    for i in range(24):
        fr = torch.from_numpy(rng.integers(-1, 9, lanes).astype(np.int32))
        to = torch.from_numpy(rng.integers(0, 9, lanes).astype(np.int32))
        t = torch.from_numpy(rng.normal(0, 1, (lanes, 3)).astype(np.float32))
        on = torch.from_numpy(rng.random(lanes) < 0.7)
        add_edge_lanes(stacked, from_slot=fr, to_slot=to, T=t, edge_type=EDGE_LOOP, enabled=on)
        for b, st in enumerate(stores):
            add_edge(st, from_slot=fr[b], to_slot=to[b], T=t[b], edge_type=EDGE_LOOP, enabled=bool(on[b]))
    for f in dataclasses.fields(stores[0]):
        want = torch.stack([getattr(s, f.name) for s in stores])
        assert _same_bits(getattr(stacked, f.name), want), f.name
    assert int(stacked.overflow.sum()) > 0  # some lane dropped or replaced


def test_solve_body_describes_both_programs():
    """One description: the IF holds the setup, the WHILE (iteration, then
    ``lm_step``) and the finish; a configuration that stops the loop before
    its first iteration has no WHILE."""
    assert tsg.solve_body(True) == (("trigger",), ("if", (("setup",), ("while", (("iteration",), ("lm_step",))),
                                                          ("finish",))))
    assert tsg.solve_body(False) == (("trigger",), ("if", (("setup",), ("finish",))))
    assert tsg.loops(tpg.SolverConfig()) and not tsg.loops(tpg.SolverConfig(max_iterations=0))
    assert not tsg.loops(tpg.SolverConfig(mu_init=1e8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve graph is built only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 8])
def test_graph_trigger_on_the_card(cuda, lanes, monkeypatch):
    """On the card: the first trigger that solves captures the steps and
    builds the graph, the next ones are one graph launch each with no host sync inside it, bit
    for bit against the host loop; the captured steps hold only nodes a
    conditional body takes; the built graph: the trigger and the IF, the
    IF body's setup, WHILE and finish, the WHILE body's iteration and
    ``lm_step``."""
    config = _config()
    if lanes == 1:
        engine, state = _single(config, "run", cuda)
        host = optimize_host_loop
    else:
        engine = make_batch_engine(config, lanes, device=cuda)
        state = engine.init_states()
        for b, case in enumerate(BATCH_CASES):
            _fill(lane_view(state, b), engine.camera, case, seed=b)
        host = tbatch.optimize_host_loop
    engine.optimize(map_state(state, torch.clone))  # captures, then builds
    assert engine.solve_graph.built
    real = tsg._CardSolveGraph.launch

    def checked(self):  # a host sync inside the launch raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(tsg._CardSolveGraph, "launch", checked)
    for _ in range(2):
        launches = tsg.SolveGraph.launches
        got, ran = engine.optimize(map_state(state, torch.clone))
        assert tsg.SolveGraph.launches == launches + 1
    want, want_ran = host(engine, map_state(state, torch.clone))
    assert ran == want_ran
    _assert_states_equal(got, want)
    sg = engine.solve_graph
    assert set(sg.node_types) <= tsg.BODY_TYPES and sg.node_types.get("kernel", 0) > 0
    assert sg.structure == {"outer_nodes": 2, "if_body_nodes": 4, "while_body_nodes": 2}


def test_stagebench_solve_row_on_the_cpu():
    """``stagebench --solve``'s row on a small stacked chain (two lanes):
    the LM's iterations, the stages' times, a solve equal to itself."""
    from nislam_torch.scripts import stagebench

    row = stagebench.solve_row(stagebench.solve_problem(16, 48, 2, CPU), 1, CPU)
    assert row["equal"] and row["iterations"] > 0
    stages = ("assembly", "pin + damping", "cholesky_ex", "triangular solves", "step + new cost", "lm_step", "iteration")
    assert all(row[name]["cpu_us"] > 0 for name in stages)
    assert "graph_ms" not in row  # the solve graph is built only on a card


def test_captureprobe_needs_a_card():
    """``captureprobe`` refuses the CPU: captures exist only on a card."""
    from nislam_torch.scripts import captureprobe

    assert captureprobe.main(["--device", "cpu"]) == 2
