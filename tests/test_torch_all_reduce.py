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

The kernel's launch plan on the host: its pieces cover every element
once at 1 to 8 ranks, from one element to the 32 MB canvas delta in
rounds; a numpy model of the two shot (each owner sums its range in rank
order, every rank gathers) equals the plain version bit for bit; at one
rank nothing is launched and the group still counts the call.

On a card (``gpu`` marker, skipped here): at one NCCL rank the call
against its plain version bit for bit with no launch, a captured call's
replay against the eager call; two ranks sharing the card at every
payload and protocol edge, bits against the plain version and across
ranks, captured replays, launches against the device count; two ranks
sharing the card, one of which stops calling: the other's captured graph
of many calls ends after about one timeout (the group's broken word), and
both ranks' hosts raise.

Each rank ends with a barrier and ``destroy_process_group`` (:func:`close`):
a gloo rank that exits with its process group alive may abort at exit.
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
    close()
    return 0


def close() -> None:
    """A rank's end: a barrier, so that no rank tears down while a peer's
    last collective is in flight, then the process group destroyed, so
    that gloo's threads are joined before the interpreter exits (a rank
    that exits with them running may abort in C++ teardown with
    "terminate called without an active exception", SIGABRT)."""
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


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
    close()
    return 0


def edges_main(world: int, rank: int, port: str, workdir: str) -> int:
    """Two ranks sharing the card: the kernel at every payload of the
    distributed engine and every protocol edge
    (``scripts/captureprobe.py``'s ``peer_payloads`` and ``edge_payloads``):
    its bits against its plain version and the other rank's, a captured
    call's replay against the eager call; its launches against its device
    count."""
    from nislam_torch.ops import all_reduce as ar
    from nislam_torch.parallel.mesh import init_distributed
    from nislam_torch.scripts.captureprobe import edge_payloads, peer_payloads

    group = init_distributed(f"tcp://127.0.0.1:{port}", world, rank, "gloo", "cuda:0", timeout_s=LAUNCH_TIMEOUT_S)
    dev = group.device
    cases = {label: (shape, dtype, None) for label, (shape, dtype) in peer_payloads(272, 1024, world).items()}
    cases.update(edge_payloads(world))
    out, ran, counted = {}, ar.device_launches(dev), ar.launches()
    for i, (label, (shape, dtype, one_shot)) in enumerate(cases.items()):
        with group.peers.tuned(one_shot):
            out.update(edge_case(group, i, shape, dtype))
    out["launches"] = np.int64([ar.device_launches(dev) - ran, ar.launches() - counted])
    out["labels"] = np.array(list(cases))
    out["shared"] = np.bool_(group.peers.shared)
    group.check()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    close()
    return 0


def edge_case(group, i: int, shape, dtype) -> dict:
    """One payload of :func:`edges_main` → its results under keys ``i_*``."""
    from nislam_torch.ops import all_reduce as ar
    from nislam_torch.scripts.captureprobe import order_payload, probe_all_reduce

    dev, out = group.device, {}
    x = order_payload(shape, dtype, group.rank, dev, seed=i)
    want = ar.all_reduce(x.clone(), group, force="reference")
    got = ar.all_reduce(x.clone(), group)
    bits = got.reshape(-1).view(torch.int32)
    out[f"{i}_equal"] = np.bool_(torch.equal(bits, want.reshape(-1).view(torch.int32)))
    out[f"{i}_bits"] = bits.cpu().numpy()
    out[f"{i}_protocol"] = np.int32(group.peers.plan(x.numel()).protocol)
    if dtype == torch.float32:
        res = probe_all_reduce(lambda t: ar.all_reduce(t, group), shape, dev, src=x)
        out[f"{i}_replay"] = np.bool_(res.get("bits", False) and res.get("nodes") == {"kernel": 1, "memcpy": 1})
    return out


# ---------------------------------------------------------------------------
# Launching the ranks (pytest side)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, workdir: str, mode: str = "sum") -> list:
    """``world`` ranks of this file on ``workdir`` (``mode``: ``"sum"``,
    :func:`rank_main`; ``"stall"``, :func:`stall_main`; ``"edges"``,
    :func:`edges_main`), waited for within the launch's timeout → each
    rank's arrays."""
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
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-2000:] for p in procs[len(logs):]]
        pytest.fail(f"{world} ranks did not finish in {LAUNCH_TIMEOUT_S} s; the unfinished ranks' logs:\n"
                    + "\n".join(tails))
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
# The kernel's launch plan (ops/all_reduce.py::launch_plan), on the host
# ---------------------------------------------------------------------------

PLAN_RANKS = (1, 2, 3, 4, 8)
PLAN_COUNTS = ("1", "3", "n*4+1", "crossover-1", "crossover+1", "32 MB delta")


def plan_count(kind: str, n: int) -> int:
    """Elements of a plan case at ``n`` ranks: 1, 3, n·4 + 1, each side of
    the one shot's largest payload, and the (2, 2048, 2048) canvas delta
    (32 MB: four rounds of a slot)."""
    from nislam_torch.ops.all_reduce import ONE_SHOT_BYTES

    edge = ONE_SHOT_BYTES // 4
    return {"1": 1, "3": 3, "n*4+1": 4 * n + 1, "crossover-1": edge - 1, "crossover+1": edge + 1,
            "32 MB delta": 2 * 2048 * 2048}[kind]


@pytest.mark.parametrize("kind", PLAN_COUNTS)
@pytest.mark.parametrize("n", PLAN_RANKS)
def test_launch_plan_covers_every_element_once(n, kind):
    """The plan's pieces cover every element exactly once, in the limits of
    the kernel's region: at one rank nothing is launched; the one shot's
    blocks within their windows; the two shot's owner ranges starting on
    16 bytes (but for empty ones at the tail), each within an inbox row,
    every piece inside its owner's range, its rounds a slot each.  Small
    counts also forced into the two shot (``one_shot_bytes=0``)."""
    from nislam_torch.ops import all_reduce as ar

    count = plan_count(kind, n)
    for one_shot in (ar.ONE_SHOT_BYTES, 0):
        plan = ar.launch_plan(count, 4, n, one_shot_bytes=one_shot)
        assert plan.count == count and len(plan.words()) == 6 + 2 * (ar.MAX_RANKS + 1)
        if n == 1:
            assert plan.protocol == ar.NONE and plan.blocks == 0 and not list(plan.pieces())
            continue
        want = ar.ONE_SHOT if count * 4 <= one_shot else ar.TWO_SHOT
        assert plan.protocol == want, (one_shot, plan)
        seen = np.zeros(count, np.int8)
        for owner, block, lo, hi in plan.pieces():
            assert 0 <= block < plan.blocks and 0 <= lo < hi <= count
            seen[lo:hi] += 1
        assert (seen == 1).all(), np.flatnonzero(seen != 1)[:8]
        if plan.protocol == ar.ONE_SHOT:
            window = ar.ONE_SHOT_CAPACITY // 4 // ar.ONE_SHOT_BLOCKS
            assert plan.blocks <= ar.ONE_SHOT_BLOCKS and plan.block_elems % 2 == 0
            assert plan.block_elems <= window and (plan.blocks - 1) * plan.block_elems < count
            continue
        row = -(-(ar.SLOT_BYTES // 4) // n)
        row += -row % 4
        assert 1 <= plan.blocks <= ar.TWO_SHOT_BLOCKS and plan.block_elems % 4 == 0
        assert plan.per_round % 4 == 0 and plan.per_round <= ar.SLOT_BYTES // 4
        assert (plan.rounds - 1) * plan.per_round < count <= plan.rounds * plan.per_round
        for bounds, length in ((plan.full, plan.per_round), (plan.last, count - (plan.rounds - 1) * plan.per_round)):
            assert len(bounds) == n + 1 and bounds[0] == 0 and bounds[-1] == length
            for j in range(n):
                assert bounds[j] <= bounds[j + 1] and bounds[j + 1] - bounds[j] <= row
                assert bounds[j] % 4 == 0 or bounds[j] == length
                assert plan.blocks * plan.block_elems >= bounds[j + 1] - bounds[j]
        if kind == "32 MB delta":
            assert plan.rounds == 4


def two_shot_model(rows: np.ndarray, plan) -> np.ndarray:
    """The two shot in numpy: each owner sums its pieces of each round in
    rank order from every rank's payload (``rows``, (n, count)), then every
    rank gathers the owners' sums → what every rank's ``out`` holds."""
    out = np.zeros_like(rows[0])
    for _, _, lo, hi in plan.pieces():
        acc = rows[0, lo:hi].copy()
        for q in range(1, rows.shape[0]):
            acc = acc + rows[q, lo:hi]
        out[lo:hi] = acc
    return out


@pytest.mark.parametrize("kind", ("float32", "int32"))
@pytest.mark.parametrize("n", (2, 3, 4, 8))
def test_two_shot_model_equals_the_reference(n, kind):
    """Each owner summing its range in rank order, then every rank
    gathering, gives ``all_reduce_reference``'s bits: on float32 whose sum
    depends on its order and on int32 that wraps, over rounds of a slot
    (a small slot here: 3 rounds, the last ragged); the one shot's blocks
    likewise."""
    from nislam_torch.ops import all_reduce as ar

    count = 3 * 1024 + 4 * n + 3
    rng = np.random.default_rng([11, n])
    if kind == "int32":
        rows = rng.integers(-2 ** 31, 2 ** 31, size=(n, count), dtype=np.int64).astype(np.int32)
    else:
        rows = (rng.standard_normal((n, count)) * np.exp2(rng.integers(-20, 21, size=(n, count)))).astype(np.float32)
    with np.errstate(over="ignore"):
        want = all_reduce_reference(torch.from_numpy(rows[0]), lambda x: torch.from_numpy(rows)).numpy()
        for plan in (ar.launch_plan(count, 4, n, slot_bytes=4096, one_shot_bytes=0),
                     ar.launch_plan(count, 4, n)):
            assert plan.protocol == (ar.TWO_SHOT if plan.rounds > 1 else ar.ONE_SHOT)
            assert _bits(two_shot_model(rows, plan)) == _bits(want), plan
    if kind == "float32" and n > 2:  # two addends commute
        back = rows[::-1].copy()
        assert _bits(two_shot_model(back, plan)) != _bits(want)  # the order is held


def test_one_rank_launches_nothing():
    """At one rank the all-reduce is the payload in place: the region
    launches nothing (its library's launch is never called; the error word
    is read), the kernel's count stays, and the group still counts the
    collective by its payload."""
    from nislam_torch.ops import all_reduce as ar

    class Library:
        def nislam_ar_error(self, ctx):
            return 0

        def nislam_ar_launch(self, *args):
            raise AssertionError("the kernel was launched at one rank")

    region = object.__new__(ar.PeerRegion)
    region._lib, region._ctx, region.device, region.size = Library(), None, torch.device("cpu"), 1
    group = RankGroup(rank=0, size=1, axis="bank", device=torch.device("cpu"), peers=region)
    before = ar.launches()
    x = torch.from_numpy(payload("float32", 0))
    want = x.clone()
    # The kernel's route itself (the region's devices match): no launch.
    assert ar.all_reduce(x, group, force="kernel") is x and _bits(x.numpy()) == _bits(want.numpy())
    assert region.launch(x) is False and ar.launches() == before
    assert group.all_reduce(x) is x and _bits(x.numpy()) == _bits(want.numpy())
    group.all_reduce(torch.zeros(4, dtype=torch.int32))
    assert ar.launches() == before
    assert dict(group.counts) == {("all_reduce", x.numel() * 4): 1, ("all_reduce", 16): 1}
    assert ar.launch_plan(x.numel(), 4, 1).protocol == ar.NONE


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
    """At one rank the call against its plain version, bit for bit, at a
    payload of several rounds' slots and at the small ones: the payload
    itself, in place, and no launch (none counted, none on the device)."""
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
    assert ar.device_launches(cuda) - ran == ar.launches() - counted == 0


@pytest.mark.gpu
def test_captured_call_equals_the_eager_call(nccl_group):
    """At one rank a capture of the call (after the copy of its payload in)
    holds that memcpy alone (a conditional body holds it), and its replay
    gives the eager call's bits.  At two ranks: the kernel is one kernel
    node, :func:`test_kernel_at_two_ranks_sharing_the_card`."""
    from nislam_torch.ops.all_reduce import all_reduce
    from nislam_torch.scripts.captureprobe import probe_all_reduce

    group = nccl_group
    for shape in ((272, 3), (2, 1024, 1024)):
        res = probe_all_reduce(lambda t: all_reduce(t, group), shape, group.device)
        assert res.get("nodes") == {"memcpy": 1} and res["body"] and res["bits"], (shape, res)


@pytest.mark.gpu
def test_kernel_at_two_ranks_sharing_the_card():
    """Two ranks sharing the card (gloo, CUDA IPC on one device): at every
    payload of the distributed engine and every protocol edge
    (``scripts/captureprobe.py``: the one shot and the two shot at 1, 3 and
    n·4 + 1 elements, each side of the crossover, three rounds with a
    ragged tail), the kernel's bits equal its plain version's and the other
    rank's; a captured call is one kernel node whose replay gives the eager
    bits; its launches equal its device count on each rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the all_reduce kernel runs only on a card")
    with tempfile.TemporaryDirectory(prefix="nislam_all_reduce_edges_") as workdir:
        first, second = launch(2, workdir, mode="edges")
    labels = list(first["labels"])
    assert labels == list(second["labels"]) and len(labels) > 10 and first["shared"] and second["shared"]
    assert {int(first[f"{i}_protocol"]) for i in range(len(labels))} == {1, 2}
    for i, label in enumerate(labels):
        for res in (first, second):
            assert res[f"{i}_equal"], label
            assert res.get(f"{i}_replay", True), label
        assert _bits(first[f"{i}_bits"]) == _bits(second[f"{i}_bits"]), label
    for res in (first, second):
        ran, counted = res["launches"]
        assert ran == counted > 0, res["launches"]


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
    main_of = {"sum": rank_main, "stall": stall_main, "edges": edges_main}[sys.argv[1]]
    sys.exit(main_of(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
