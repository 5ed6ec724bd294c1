"""The tracked frame's graph (``nislam_torch.core.track_graph``) at the golden size.

On the CPU the graph's body runs eagerly on its buffers (its plain
version), and the engine's ``run_chunk`` and ``step`` go through it (as
the frame graph's track graph, ``tests/test_torch_frame_graph.py``; with
the inline solve as the track-graph path):

- (a) the body makes no host read and builds no tensor from host data
  (``item``, ``tolist``, ``__bool__``, ``__int__``, ``__float__``,
  ``numpy``, ``cpu`` and ``torch.tensor`` / ``torch.as_tensor`` of host
  data all raise while it runs);
- (b) ``run_chunk`` (through ``run_sequence``, ``finalize`` included) and
  ``step`` through the graph equal the eager per-frame loop
  (``run_chunk_eager``, ``slam_step``) bit for bit, outputs and every
  state leaf: the golden workload, the inline solve, and the online
  canvas with ring eviction (``test_torch_engine.py``'s workloads);
- (c) the same runs against JAX's engine: decisions exactly, poses atol
  2e-3, responses rtol 1e-3 (``test_torch_engine.py``'s tolerances);
- (d) no stale buffer: on one engine, a second fresh state, a state
  converted from JAX's state mid-sequence (``state_from_numpy``) and the
  bench's pattern (a warm-up run, then a fresh state) each give what a new
  engine gives, and a state that a run returned does not change when the
  engine runs another;
- ``launch_counts`` on a hand-made trace;
- on a card (``gpu`` marker, skipped here): the engine's captured graphs
  equal the eager loop bit for bit, are captured at the first run only,
  and their replays count the ``peak_stats`` launches that the eager loop
  makes.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nislam_torch.core.slam import (
    SlamEngine,
    frontend,
    make_engine,
    optimize_host_loop,
    pack_outputs,
    run_chunk_eager,
    slam_step,
    state_from_numpy,
    state_leaves,
)
from nislam_torch.core.track_graph import CapturedStep
from nislam_torch.utils.profiling import launch_counts
from nislam_tpu.core.slam import chunked_deferred_drive
from nislam_tpu.core.slam import make_engine as make_jax_engine
from nislam_tpu.utils.synthetic import heading_loop_path, make_world, render_sequence

from test_torch_engine import _assert_outputs_match, _golden_config, _option_config

torch.set_num_threads(1)  # see test_torch_engine.py

CPU = torch.device("cpu")
WORKLOADS = ("golden", "inline", "online")
GOLDEN_CHUNK = 32  # test_torch_engine.py's golden run
OPTION_CHUNK = 40  # and its option runs


class EagerEngine:
    """``engine`` with the eager per-frame loop in place of its graph."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run_chunk(self, state, images):
        return run_chunk_eager(self.engine, state, images)

    def run_sequence(self, *args, **kwargs):
        return SlamEngine.run_sequence(self, *args, **kwargs)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _assert_states_equal(a, b) -> None:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        assert _same_bits(x, y), f"state leaf {i}"


def _assert_outputs_equal(a, b) -> None:
    """Two runs' numpy outputs, bit for bit."""
    assert pack_outputs(a).tobytes() == pack_outputs(b).tobytes()


def _workload(name):
    """(config, frames, chunk) of a workload of test_torch_engine.py."""
    world = make_world(1024, 3.0, seed=1234)
    if name == "golden":
        return _golden_config(), render_sequence(world, 96, 128, heading_loop_path(100, step=5.5, tail=10)), GOLDEN_CHUNK
    frames = render_sequence(world, 96, 128, heading_loop_path(120, step=5.5, tail=30))
    return _option_config(name), frames, OPTION_CHUNK


def _run(engine, frames, chunk):
    """``run_sequence`` + ``finalize`` → (state, outputs, solves between chunks)."""
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=chunk, solve_tally=tally)
    state, _ = engine.finalize(state)
    return state, outs, tally


def _jax_run(config, frames, chunk):
    je = make_jax_engine(config)
    if config.optimizer.inline:
        js, jo = je.run_sequence(je.init_state(), jnp.asarray(frames))
    else:
        js, jo = chunked_deferred_drive(je, je.init_state(), jnp.asarray(frames), chunk_frames=chunk)
    js, _ = je.finalize(js)
    return jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jo)


@pytest.fixture(scope="module", params=WORKLOADS)
def runs(request):
    """One workload through the graph and through the eager loop, on one engine."""
    config, frames, chunk = _workload(request.param)
    engine = make_engine(config, CPU)
    return types.SimpleNamespace(
        name=request.param, config=config, frames=frames, chunk=chunk,
        graph=_run(engine, frames, chunk), eager=_run(EagerEngine(engine), frames, chunk),
    )


def test_body_makes_no_host_read(monkeypatch):
    """(a) One tracked frame through the graph's body with every host read
    and every tensor built from host data refused."""
    config, frames, _ = _workload("golden")
    engine = make_engine(config, CPU)
    state, _ = engine.run_chunk(engine.init_state(), frames[:8])
    graph = engine.track_graph
    graph.load(state)
    img_u, _, polar = frontend(torch.from_numpy(frames[8]), cf_ops=engine.cf_ops, camera=engine.camera)
    frame_id = int(graph.inputs.next_frame_id)

    def refused(name):
        def raise_(*args, **kwargs):
            raise AssertionError(f"the body called Tensor.{name}")
        return raise_

    def tensors_only(real):
        def build(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"the body built a tensor from host data {data!r}")
            return real(data, *args, **kwargs)
        return build

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__int__", "__float__", "numpy", "cpu"):
            m.setattr(torch.Tensor, name, refused(name))
        m.setattr(torch, "tensor", tensors_only(torch.tensor))
        m.setattr(torch, "as_tensor", tensors_only(torch.as_tensor))
        with pytest.raises(AssertionError, match="Tensor.__bool__"):
            bool(torch.ones(()))  # the guard is on
        with pytest.raises(AssertionError, match="host data"):
            torch.as_tensor(1.0)
        outs = graph.run(img_u, polar)
    assert outs.flags.dtype == torch.bool and outs.flags.shape == (2,)
    assert outs.packed.shape == (17,) and bool(torch.isfinite(outs.packed).all())
    assert int(outs.packed[13]) == frame_id and int(graph.inputs.next_frame_id) == frame_id + 1
    assert CapturedStep.captures == 0  # nothing is captured on the CPU


def test_graph_run_chunk_equals_eager_loop(runs):
    """(b) ``run_sequence`` through the graph equals the eager loop bit
    for bit: every output, every solve, every state leaf."""
    (gs, go, gt), (es, eo, et) = runs.graph, runs.eager
    assert len(go.tracked) == len(runs.frames) and go.tracked.all()
    _assert_outputs_equal(go, eo)
    _assert_states_equal(gs, es)
    assert gt == et
    if runs.name == "inline":
        assert go.optimized.any()
    else:
        assert any(gt)
    if runs.name == "online":
        assert int(gs.bank.overflow) > 0  # the ring evicted


@pytest.mark.parametrize("name", WORKLOADS)
def test_graph_step_equals_eager_step(name):
    """(b) ``step`` through the graph equals ``slam_step`` bit for bit
    over a whole workload, with the deferred trigger after every frame as
    ``run --mode step`` has it."""
    config, frames, _ = _workload(name)
    engine = make_engine(config, CPU)
    kw = engine._steps()
    gs, es = engine.init_state(), engine.init_state()
    for frame in frames:
        image = torch.from_numpy(frame)
        gs, g = engine.step(gs, image)
        es, e = slam_step(es, engine._features(image), **kw)
        for field, x, y in zip(g._fields, g, e):
            assert _same_bits(x.to(y.dtype), y), field
        if not config.optimizer.inline:
            gs, _ = engine.optimize(gs)
            es, _ = optimize_host_loop(engine, es)
    _assert_states_equal(gs, es)


def test_graph_matches_jax(runs):
    """(c) The graph's run against JAX's engine on the same frames."""
    js, jo = _jax_run(runs.config, runs.frames, runs.chunk)
    state, outs, _ = runs.graph
    _assert_outputs_match(outs, jo)
    np.testing.assert_allclose(state.bank.poses.numpy(), js.bank.poses, atol=2e-3)


def test_no_stale_buffer():
    """(d) One engine's graph reused across states gives what a new
    engine gives each time, and leaves the states it returned alone."""
    config, frames, chunk = _workload("golden")
    engine = make_engine(config, CPU)

    def fresh(fn):
        return fn(make_engine(config, CPU))

    first, first_outs, _ = _run(engine, frames, chunk)
    kept = [x.clone() for x in state_leaves(first)]
    # A second fresh state.
    state, outs, _ = _run(engine, frames, chunk)
    _assert_outputs_equal(outs, first_outs)
    _assert_states_equal(state, first)
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(first), kept))
    # A state converted from JAX's mid-sequence state.
    je = make_jax_engine(config)
    js, _ = chunked_deferred_drive(je, je.init_state(), jnp.asarray(frames[:32]), chunk_frames=32)
    mid = jax.tree.map(np.asarray, js)
    state, outs = engine.run_chunk(state_from_numpy(mid, CPU), frames[32:64])
    want_state, want = fresh(lambda e: e.run_chunk(state_from_numpy(mid, CPU), frames[32:64]))
    assert _same_bits(outs.pack(), want.pack())
    _assert_states_equal(state, want_state)
    assert all(_same_bits(x, y) for x, y in zip(state_leaves(first), kept))

    # The bench's pattern: every chunk with its trigger as a warm-up, then
    # the same on a fresh state.
    def bench(e):
        state = e.init_state()
        for start in range(0, 96, chunk):
            state, _ = e.run_chunk(state, frames[start:start + chunk])
            state, _ = e.optimize(state)
        return state

    bench(engine)
    _assert_states_equal(bench(engine), fresh(bench))


def test_launch_counts_reads_one_trace(tmp_path):
    """The host's kernel and graph launch calls apart from the device's
    kernels, a replayed graph's among them."""
    def x(cat, name, ts):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1.0}

    events = [
        x("cuda_runtime", "cudaLaunchKernel", 0.0), x("cuda_driver", "cuLaunchKernel", 1.0),
        x("cuda_runtime", "cudaGraphLaunch", 2.0), x("cuda_runtime", "cudaMemcpyAsync", 3.0),
        x("kernel", "k1", 10.0), x("kernel", "k2", 11.0), x("kernel", "k3", 12.0), x("kernel", "k1", 13.0),
        x("gpu_memcpy", "Memcpy DtoD", 14.0), x("cpu_op", "aten::copy_", 0.0),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert launch_counts(str(path)) == {"kernel_launches": 2, "graph_launches": 1, "host_launches": 3, "kernels": 4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_captured_graph_equals_eager_loop_on_the_card(cuda, name):
    """The engine's own graphs (the frame graph's, the inline solve's
    included) against the eager loop: captured at the first run only, bit
    for bit, with as many ``peak_stats`` launches."""
    from nislam_torch.ops.peak_stats import peak_stats

    config, frames, chunk = _workload(name)
    engine = make_engine(config, cuda)
    frames_d = torch.from_numpy(frames).to(cuda)
    _run(engine, frames_d, chunk)  # captures
    graph = engine.frame_graph
    assert graph.captured and engine._track_graph is None
    captures = CapturedStep.captures
    torch.cuda.synchronize()
    launches = peak_stats.launches
    gs, go, gt = _run(engine, frames_d, chunk)
    graph_launches, launches = peak_stats.launches - launches, peak_stats.launches
    es, eo, et = _run(EagerEngine(engine), frames_d, chunk)
    assert CapturedStep.captures == captures
    assert peak_stats.launches - launches == graph_launches > 0
    _assert_outputs_equal(go, eo)
    assert gt == et
    for x, y in zip(state_leaves(gs), state_leaves(es), strict=True):
        assert _same_bits(x.cpu(), y.cpu())
