"""The port's all-reduce (``nislam_torch/ops/all_reduce.py``) and the routes it opens.

Ranks are subprocesses that run this file as a worker (``__main__``
below): gloo over ``tcp://127.0.0.1:<free port>``, CPU tensors, one thread
each, no JAX; one launch per world size (2 and 4) writes each rank's
results to an ``.npz``.  On CPU tensors ``RankGroup.all_reduce`` is the
kernel's plain version, ``all_reduce_reference``: every rank's payload
gathered exactly through the process group, then summed in rank order.
Its payloads are made from seeds with numpy, so the test knows every
rank's values:

- float32 values scaled by 2^-20 to 2^20, whose sum depends on its
  order: every rank's result has the same bits, and they are numpy's
  float32 sum in rank order, ``((x_0 + x_1) + x_2) + …``, bit for bit
  (the reversed order gives other bits, so the order is held);
- int32 over the whole range: the exact sum, wrapped;
- a zero-filled ``gather_rows`` record reads back its writers' bits, and
  ``gather_exact`` keeps every bit (a −0.0, NaN payloads);
- the collectives by payload, as ``RankGroup.counts`` records them.

At one rank in this process, a stub group: ``capturable`` selects the
routes (the keyframe branch in the chunk graph, ``branch_on_host``
false, the trigger's all-reduces inside its steps; else the host
routes), and the distributed engine through the graph route's plain
program (its branch, the collectives inside, one captured step per kind
in the chunk graph's SWITCH) equals the host route's chunk graph and the
track-graph path bit for bit, with and without the online canvas over a
ring that evicts.

On a card (``gpu`` marker, skipped here): the kernel at one NCCL rank
against its plain version bit for bit, a captured call's replay against
the eager call, its launches against its device count; two ranks sharing
the card, one of which stops calling: the other's captured graph of many
calls ends after about one timeout (the group's broken word), and both
ranks' hosts raise.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from nislam_torch.core.frame_graph import CollectiveFrameGraph, HostBranchFrameGraph  # noqa: E402
from nislam_torch.core.slam import pack_outputs, run_chunk_track_graph, state_leaves, unpack_step_output  # noqa: E402
from nislam_torch.ops.all_reduce import all_reduce_reference  # noqa: E402
from nislam_torch.parallel.engine import make_distributed_engine  # noqa: E402
from nislam_torch.parallel.mesh import RankGroup  # noqa: E402

torch.set_num_threads(1)

LAUNCH_TIMEOUT_S = 240
STALL_TIMEOUT_S = 1.0  # the kernel's clock bound in the stopped-peer test
STALL_CALLS = 8  # calls in that test's captured graph
SHAPE = (3, 257)  # a payload of the size of a few CG vectors
WORLDS = (2, 4)


def payload(kind: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s values of ``kind``: float32 normals scaled by 2^-20
    to 2^20, or int32 over the whole range."""
    rng = np.random.default_rng([7, rank, kind == "int32"])
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, size=SHAPE, dtype=np.int64).astype(np.int32)
    return (rng.standard_normal(SHAPE) * np.exp2(rng.integers(-20, 21, size=SHAPE))).astype(np.float32)


def special_row(rank: int) -> np.ndarray:
    """A row whose bits a float sum would change: −0.0 and NaN payloads."""
    bits = np.array([0x80000000, 0x7FC00000 + rank, 0xFFC00001, 0x00000001 + rank], np.uint32)
    return bits.view(np.float32)


# ---------------------------------------------------------------------------
# One rank (the worker)
# ---------------------------------------------------------------------------


def rank_main(world: int, rank: int, port: str, workdir: str) -> int:
    from nislam_torch.parallel.mesh import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{port}", world, rank, "gloo", "cpu", timeout_s=LAUNCH_TIMEOUT_S)
    out = {}
    for kind in ("float32", "int32"):
        x = torch.from_numpy(payload(kind, rank))
        out[f"{kind}_sum"] = group.all_reduce(x.clone()).numpy()
        out[f"{kind}_input"] = x.numpy()  # untouched by the call on the clone
    row = torch.from_numpy(payload("float32", rank)[0])
    out["rows"] = group.gather_rows(row).numpy()
    out["rows_int32"] = group.gather_rows(torch.from_numpy(payload("int32", rank)[0])).numpy()
    out["exact"] = group.gather_exact(torch.from_numpy(special_row(rank))).numpy()
    out["counts"] = np.array(sorted((nbytes, n) for (_, nbytes), n in group.counts.items()), np.int64)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    assert "jax" not in sys.modules and "nislam_tpu" not in sys.modules
    return 0


def stall_main(world: int, rank: int, port: str, workdir: str) -> int:
    """Two ranks sharing the card: one all-reduce together, then rank 1
    stops calling (it waits in the process group's barrier) while rank 0
    replays a captured graph of ``STALL_CALLS`` all-reduces, each bounded
    by ``STALL_TIMEOUT_S``; after the barrier rank 1 makes one call.  Each
    rank's seconds (the replay; rank 1's call) and whether its host
    raised."""
    import torch.distributed as dist

    from nislam_torch.core.track_graph import no_collection
    from nislam_torch.parallel.mesh import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{port}", world, rank, "gloo", "cuda:0", timeout_s=LAUNCH_TIMEOUT_S)
    group.peers.timeout_ns = int(STALL_TIMEOUT_S * 1e9)  # before the capture freezes it
    dev = group.device
    x = torch.full((272, 3), float(rank + 1), device=dev)
    group.all_reduce(x)
    torch.cuda.synchronize(dev)
    out = {"summed": bool((x == 3.0).all())}

    def timed(fn) -> None:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize(dev)
        out["seconds"] = time.monotonic() - t0
        try:
            group.check()
            out["raised"] = False
        except RuntimeError:
            out["raised"] = True

    if rank == 0:
        buf = torch.ones(272, 3, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with no_collection(), torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            for _ in range(STALL_CALLS):
                group.all_reduce(buf)
        timed(graph.replay)
    dist.barrier()
    if rank == 1:
        timed(lambda: group.all_reduce(x))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.barrier()
    return 0


# ---------------------------------------------------------------------------
# Launching the ranks (pytest side)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, workdir: str, mode: str = "sum") -> list:
    """``world`` ranks of this file on ``workdir`` (``mode``: ``"sum"``,
    :func:`rank_main`; ``"stall"``, :func:`stall_main`), waited for within
    the launch's timeout → each rank's arrays."""
    port = _free_port()
    path = os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    start = time.monotonic()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(world), str(r), str(port), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, LAUNCH_TIMEOUT_S - (time.monotonic() - start)))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks did not finish in {LAUNCH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
    results = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            results.append(dict(f))
    return results


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request):
    with tempfile.TemporaryDirectory(prefix="nislam_all_reduce_") as workdir:
        yield request.param, launch(request.param, workdir)


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def test_float_sum_in_rank_order(ranks):
    """Every rank the same bits, numpy's float32 sum in rank order, which
    the reversed order does not give at 4 ranks (two addends commute)."""
    n, results = ranks
    xs = [payload("float32", r) for r in range(n)]
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["float32_input"], xs[r])
    want = xs[0].copy()
    for x in xs[1:]:
        want = want + x  # float32 + float32: one rounding per add, in rank order
    back = xs[-1].copy()
    for x in xs[-2::-1]:
        back = back + x
    assert want.dtype == np.float32 and (_bits(want) != _bits(back)) == (n > 2)
    for r, res in enumerate(results):
        assert _bits(res["float32_sum"]) == _bits(want), f"rank {r}"


def test_int32_sum_exact(ranks):
    """int32 sums are exact: the sum of the ranks' values, wrapped."""
    n, results = ranks
    want = np.sum([payload("int32", r).astype(np.int64) for r in range(n)], axis=0)
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["int32_sum"], want, err_msg=f"rank {r}")


def test_gather_rows_reads_back_the_writers_bits(ranks):
    """A zero-filled record's all-reduce: row q on every rank has rank q's
    bits (float32 and int32)."""
    n, results = ranks
    for r, res in enumerate(results):
        for q in range(n):
            assert _bits(res["rows"][q]) == _bits(payload("float32", q)[0]), (r, q)
            assert _bits(res["rows_int32"][q]) == _bits(payload("int32", q)[0]), (r, q)


def test_gather_exact_keeps_every_bit(ranks):
    """The process group's exact gather keeps a −0.0 and NaN payloads,
    which a float sum would change: the handle exchange's and the plain
    version's gather."""
    n, results = ranks
    want = np.stack([special_row(q) for q in range(n)])
    for r, res in enumerate(results):
        assert _bits(res["exact"]) == _bits(want), f"rank {r}"


def test_counts_by_payload(ranks):
    """Each call counted once by its payload bytes; the exact gather is not
    counted."""
    n, results = ranks
    row = SHAPE[1] * 4
    want = sorted([(SHAPE[0] * SHAPE[1] * 4, 2), (n * row, 2)])
    for r, res in enumerate(results):
        assert res["counts"].tolist() == [list(x) for x in want], f"rank {r}"


def test_reference_sums_in_rank_order():
    """``all_reduce_reference`` over given rows: the rank-order sum, float32
    and int32, a new tensor; other dtypes refused."""
    rows = torch.from_numpy(np.stack([payload("float32", r) for r in range(3)]))
    got = all_reduce_reference(rows[0], lambda x: rows)
    assert got.data_ptr() != rows.data_ptr()
    assert _bits(got.numpy()) == _bits(((rows[0].numpy() + rows[1].numpy()) + rows[2].numpy()))
    ints = torch.tensor([[2 ** 31 - 1], [1]], dtype=torch.int32)
    assert int(all_reduce_reference(ints[0], lambda x: ints)) == -2 ** 31
    with pytest.raises(TypeError):
        all_reduce_reference(torch.zeros(2, dtype=torch.float64), lambda x: x[None])


# ---------------------------------------------------------------------------
# The routes, at one rank (a stub group)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StubGroup(RankGroup):
    """One rank with no process group, whose all-reduce is the sum over one
    rank (its input), counted; ``graphs`` sets ``capturable``."""

    graphs: bool = False

    @property
    def capturable(self) -> bool:
        return self.graphs

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._record("all_reduce", t)
        return t


def _stub(graphs: bool) -> StubGroup:
    return StubGroup(rank=0, size=1, axis="bank", device=torch.device("cpu"), graphs=graphs)


def _config(online: bool):
    """``tests/test_torch_dist_graph.py``'s workloads: the golden 96×128
    config, or the online canvas over a ring of 40 slots that evicts."""
    from nislam_torch.core import config as c

    h, w = 96, 128
    config = c.SlamConfig(
        cf=c.CFConfig(width=w, height=h, rotation_divisor=360, rotation_channel=96),
        keyframe_selection=c.KeyframeSelectionConfig(
            max_distance=0.10, max_angle=0.05, lower_response_thr=4.0, upper_response_thr=6.0),
        map=c.MapConfig(grid_scale=0.15, keyframe_capacity=128, edge_capacity=512),
        loop_closure=c.LoopClosureConfig(to_find_loop=True, position_response_thr=8.0, angle_response_thr=8.0,
                                         frame_gap_thr=30, distance_thr=1.0, max_candidates=8),
        camera=c.CameraConfig(image_width=w, image_height=h, height=1.0, intrinsics=(100.0, w / 2.0, 100.0, h / 2.0)),
    )
    if online:
        config = dataclasses.replace(
            config, map=dataclasses.replace(config.map, keyframe_capacity=40),
            map_stitcher=dataclasses.replace(config.map_stitcher, online=True, canvas_size=1024))
    return config


def _frames(online: bool) -> np.ndarray:
    from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

    world = make_world(1024, 3.0, seed=1234)
    path = heading_loop_path(120, step=5.5, tail=30) if online else heading_loop_path(100, step=5.5, tail=10)
    return render_sequence(world, 96, 128, path)


@pytest.mark.parametrize("graphs", (True, False), ids=("capturable", "host"))
def test_capturable_selects_the_route(graphs):
    """A capturable group: the keyframe branch in the chunk graph
    (``branch_on_host`` false, a ``CollectiveFrameGraph``), the trigger's
    all-reduces inside its captured steps (its one-launch route); else the
    host routes (a ``HostBranchFrameGraph``, the trigger's all-reduces
    made by the host between its steps)."""
    engine = make_distributed_engine(_config(False), _stub(graphs))
    assert engine.collectives_in_graph == graphs and engine.branch_on_host == (not graphs)
    fg = engine.frame_graph
    assert isinstance(fg, CollectiveFrameGraph) and isinstance(fg, HostBranchFrameGraph) == (not graphs)

    def top_reduces(body) -> int:
        found = 0
        for op in body:
            if op[0] == "reduce":
                found += 1
            elif op[0] == "if":
                found += top_reduces(op[1])
            elif op[0] == "while":
                found += top_reduces(op[2])
        return found

    assert (top_reduces(engine.trigger_program.body) == 0) == graphs


class _TrackGraph:
    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run_chunk(self, state, images):
        return run_chunk_track_graph(self.engine, state, images)

    def run_sequence(self, *args, **kwargs):
        return type(self.engine).run_sequence(self, *args, **kwargs)


def _run(engine, frames, chunk: int = 32):
    tally = []
    state, outs = engine.run_sequence(engine.init_state(), frames, chunk_frames=chunk, solve_tally=tally)
    state, ran = engine.finalize(state)
    return state, pack_outputs(outs), tally + [ran]


@pytest.fixture(scope="module", params=(False, True), ids=("golden", "online"))
def routes(request):
    """One workload through the graph route (a capturable stub), the host
    route's chunk graph and the track-graph path, each engine its own."""
    online = request.param
    config, frames = _config(online), _frames(online)
    res = {}
    for label, graphs, wrap in (("graph", True, lambda e: e), ("host", False, lambda e: e),
                                ("track graph", False, _TrackGraph)):
        group = _stub(graphs)
        engine = make_distributed_engine(config, group)
        res[label] = (engine, group, *_run(wrap(engine), frames))
    return types.SimpleNamespace(online=online, frames=frames, res=res, config=config)


def test_graph_route_equals_host_routes(routes):
    """The branch and its collectives inside the chunk graph (its plain
    program here) against the host route's chunk graph and the track-graph
    path: outputs, tallies, every state leaf bit for bit; the all-reduces
    by payload equal, but for the evicted image's, which the graph route
    makes at every stored keyframe (zeros when nothing is evicted) and the
    host routes at every eviction."""
    engine, group, state, outs, tally = routes.res["graph"]
    assert any(tally) and engine.chunk_graph.host_exits == 0
    o = unpack_step_output(outs)
    stored = int(((o.keyframe_slot >= 0) & o.inserted)[1:].sum())
    image_bytes = routes.config.cf.height * routes.config.cf.width * 4
    for label in ("host", "track graph"):
        _, ref_group, ref_state, ref_outs, ref_tally = routes.res[label]
        assert outs.tobytes() == ref_outs.tobytes(), label
        assert tally == ref_tally, label
        for i, (x, y) in enumerate(zip(state_leaves(state), state_leaves(ref_state), strict=True)):
            assert x.numpy().tobytes() == y.numpy().tobytes(), (label, i)
        key = ("all_reduce", image_bytes)
        mine, theirs = dict(group.counts), dict(ref_group.counts)
        if routes.online:
            assert mine.pop(key) == stored and theirs.pop(key) == int(ref_state.bank.overflow) > 0, label
        assert mine == theirs, label


def test_graph_route_runs_the_branch_in_the_chunk_graph(routes):
    """No host exit, no early exit past the first use: the chunk graph's
    control block counts each stored branch (its SWITCH body), and each
    kind is one step, made once."""
    engine, _, _, outs, _ = routes.res["graph"]
    chunk, fg = engine.chunk_graph, engine.frame_graph
    o = unpack_step_output(outs)
    stored = int(((o.keyframe_slot >= 0) & o.inserted)[1:].sum())
    assert chunk.host_exits == 0 and chunk.early_exits <= 2
    assert set(fg.branch_slots()) <= {0, 1} and 0 in fg.branch_slots()
    assert chunk.runs[0] + fg.branch_slots()[0].replays + (1 if chunk.early_exits else 0) >= stored > 0
    host_engine = routes.res["host"][0]
    assert host_engine.chunk_graph.host_exits == int(o.inserted[1:].sum())


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_group():
    """One NCCL rank on the card, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the all_reduce kernel runs only on a card")
    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, "nccl", "cuda:0", timeout_s=60.0)
    yield group
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("float32", "int32"))
def test_kernel_equals_plain_version_on_the_card(nccl_group, kind):
    """At one rank the kernel against its plain version, bit for bit, at a
    payload of several rounds' slots and at the small ones; its launches
    against its device count."""
    from nislam_torch.ops import all_reduce as ar

    group = nccl_group
    assert group.capturable
    cuda = group.device
    ran, counted = ar.device_launches(cuda), ar.launches()
    for shape in (SHAPE, (1,), (2, 272, 3), (2, 1500, 1500)):
        rng = np.random.default_rng(len(shape))
        x = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        t = torch.from_numpy(x.view(np.int32) if kind == "int32" else x).to(cuda)
        want = ar.all_reduce(t.clone(), group, force="reference")
        got = ar.all_reduce(t.clone(), group)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), shape
    assert ar.device_launches(cuda) - ran == ar.launches() - counted == 4


@pytest.mark.gpu
def test_captured_call_equals_the_eager_call(nccl_group):
    """A capture of the kernel (after the copy of its payload in) is one
    kernel node and that memcpy (a conditional body holds them), and its
    replay gives the eager call's bits."""
    from nislam_torch.ops.all_reduce import all_reduce
    from nislam_torch.scripts.captureprobe import probe_all_reduce

    group = nccl_group
    for shape in ((272, 3), (2, 1024, 1024)):
        res = probe_all_reduce(lambda t: all_reduce(t, group), shape, group.device)
        assert res.get("nodes") == {"kernel": 1, "memcpy": 1} and res["body"] and res["bits"], (shape, res)


@pytest.mark.gpu
def test_a_stopped_peer_ends_a_graph_of_calls_after_one_timeout():
    """Two ranks sharing the card; rank 1 stops calling.  Rank 0's
    captured graph of ``STALL_CALLS`` all-reduces ends after about one
    timeout (its first call's wait runs out and sets the group's broken
    word; every later call returns at once), not one per call, and its host
    raises; rank 1's next call returns at once and its host raises too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the all_reduce kernel runs only on a card")
    with tempfile.TemporaryDirectory(prefix="nislam_all_reduce_stall_") as workdir:
        first, second = launch(2, workdir, mode="stall")
    assert first["summed"] and second["summed"]
    assert first["raised"] and second["raised"]
    assert 0.9 * STALL_TIMEOUT_S <= first["seconds"] < 2.5 * STALL_TIMEOUT_S, first["seconds"]
    assert second["seconds"] < 0.5 * STALL_TIMEOUT_S, second["seconds"]


if __name__ == "__main__":
    main_of = {"sum": rank_main, "stall": stall_main}[sys.argv[1]]
    sys.exit(main_of(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
