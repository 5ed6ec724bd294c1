"""What a CUDA-graph capture of each of the dense LM's operations leaves behind.

    python -m nislam_torch.scripts.captureprobe [--device cuda]

A conditional node's body (the solve graph's IF and WHILE bodies,
``core/solve_graph.py``) may hold only kernel, memcpy, memset, child graph,
empty and conditional nodes.  This captures each operation that the
solve graph's steps run, at the solver's shapes (one K = 272 factor, 8 of
them, and the E = 1024 information blocks), alone on a side stream
(``torch.cuda.CUDAGraph(keep_graph=True)``) and prints the node types
that ``csrc/cond_graph.cu``'s walk finds in it, or the capture's failure:
``cholesky_ex`` (cuSOLVER ``potrf``, ``potrfBatched``), ``cholesky_solve``
of one matrix (cuSOLVER's 64-bit ``potrs``) and of 8 (``potrsBatched``),
each with the linear-algebra library pinned to cuSOLVER and with
PyTorch's default choice (MAGMA for a batched ``cholesky_solve``), the
two triangular solves the LM takes in their place, the scatter plan's
stable sort and run table.  Prints the card's name and power limit
first.  Needs a card: captures exist only there.

    python -m nislam_torch.scripts.captureprobe --nccl [--k 272] [--canvas 1024]

captures instead NCCL's own ``dist.all_reduce`` on a one-rank NCCL group
(``init_distributed(..., "nccl", ...)`` over ``tcp://127.0.0.1:<free
port>``) of the GN-CG trigger's payloads: a (K, 3) f32 vector, the
(2, K, 3) gradient block, the (1,) cost and a (2, S, S) canvas delta,
each after one eager call, on a side stream with
``CUDAGraph(keep_graph=True)``; prints the node types of each capture,
whether a conditional body holds them, and whether a replay gives the
eager call's bits.  The port never takes that route: it is the record of
why the port has a kernel of its own.

    python -m nislam_torch.scripts.captureprobe --peer [--k 272] [--canvas 1024]

does the same for the port's all-reduce, ``RankGroup.all_reduce``: the
peer-memory kernel (``csrc/all_reduce.cu``) on a one-rank NCCL group (where
it launches nothing), at the distributed engine's payloads (those four, the
(n, 11) search record and an evicted 480x640 image's int32 bits) and at
the kernel's protocol edges (:func:`edge_payloads`): its plan, the kernel
against its plain version (``all_reduce_reference``) bit for bit on values
whose sum depends on its order, every rank's result the same, the
capture's node types and a replay's bits, µs per call in steady state
eager and captured (the ranks lined up before each run; the median of 3
paired differences between R and 10·R calls, a difference that is not
positive counted apart; the first call's time apart), the plain version's
(host clock), the library's eager ``all_reduce`` timed the same way
(NCCL's, or gloo's on a gloo group), and the bound (2·(n − 1)/n·P over
NVLink across cards).

    python -m nislam_torch.scripts.captureprobe --peer --ranks 4            # NCCL, a card per rank
    python -m nislam_torch.scripts.captureprobe --peer --ranks 4 --crossover  # and one shot vs two by size
    python -m nislam_torch.scripts.captureprobe --peer --ranks 4 --times    # the times alone, by payload
    python -m nislam_torch.scripts.captureprobe --peer --ranks 2 --shared   # gloo, two ranks on one card
    python -m nislam_torch.scripts.captureprobe --nccl --ranks 4 --device cpu   # gloo, no capture

starts that many ranks as processes of this module (NCCL on ``cuda:<rank>``;
``--shared``: gloo, every rank on ``--device``; with ``--device cpu`` gloo
on CPU tensors, which captures nothing), each printing its probe lines and
then ``stagebench --solve``'s distributed trigger row over the group
(``stagebench.trigger_row``: the host loop, the program with the host
making the collectives and, on a card, the one launch: bits against the
host loop, host syncs, ms per solving trigger).
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Optional, Sequence

import torch

from nislam_torch.scripts.common import asked_device, card_line


def operations(device: torch.device) -> dict:
    """``{label: (fn, linalg library)}`` at the solver's shapes."""
    from nislam_torch.core.pose_graph import _lm_solve
    from nislam_torch.ops.scatter_add import ScatterPlan

    gen = torch.Generator(device=device).manual_seed(0)

    def spd(*shape):
        a = torch.randn(*shape, generator=gen, device=device)
        return a @ a.mT + shape[-1] * torch.eye(shape[-1], device=device)

    a1, a8, a3 = spd(817, 817), spd(8, 817, 817), spd(1024, 3, 3)
    l1, l8 = torch.linalg.cholesky(a1), torch.linalg.cholesky(a8)
    b1, b8 = torch.randn(817, 1, generator=gen, device=device), torch.randn(8, 817, 1, generator=gen, device=device)
    keys = torch.randint(0, 50000, (32768,), generator=gen, device=device)
    ops = {}
    for lib in ("cusolver", "default"):
        ops[f"cholesky_ex (817, 817), {lib}"] = (lambda: torch.linalg.cholesky_ex(a1), lib)
        ops[f"cholesky_ex (8, 817, 817), {lib}"] = (lambda: torch.linalg.cholesky_ex(a8), lib)
        ops[f"cholesky_ex (1024, 3, 3), {lib}"] = (lambda: torch.linalg.cholesky_ex(a3), lib)
        ops[f"cholesky_solve (817, 1), {lib}"] = (lambda: torch.cholesky_solve(b1, l1), lib)
        ops[f"cholesky_solve (8, 817, 1), {lib}"] = (lambda: torch.cholesky_solve(b8, l8), lib)
    ops["the LM's two triangular solves, 1 lane"] = (lambda: _lm_solve(l1[None], b1.mT), "default")
    ops["the LM's two triangular solves, 8 lanes"] = (lambda: _lm_solve(l8, b8[..., 0]), "default")
    ops["ScatterPlan.of (stable sort + run table), 32768 keys"] = (lambda: ScatterPlan.of(keys), "default")
    return ops


def probe(fn, lib: str, device: torch.device) -> str:
    """The node types of ``fn``'s capture (run once first on the capture
    stream), or why the capture failed."""
    from nislam_torch.core.chunk_graph import node_types
    from nislam_torch.kernels.launch import cond_graph_library

    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(lib)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(stream):
            fn()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream):
            fn()
        return str(node_types(cond_graph_library(), graph.raw_cuda_graph()))
    except RuntimeError as e:  # a capture the library breaks
        return f"capture failed: {str(e).splitlines()[0][:160]}"
    finally:
        torch.cuda.synchronize(device)
        torch.backends.cuda.preferred_linalg_library(prev)


def nccl_payloads(k: int, canvas: int) -> dict:
    """``{label: shape}`` of the GN-CG trigger's all-reduces."""
    return {f"(K, 3) CG vector, K = {k}": (k, 3), f"(2, K, 3) gradient block, K = {k}": (2, k, 3),
            "(1,) cost": (1,), f"(2, S, S) canvas delta, S = {canvas}": (2, canvas, canvas)}


def library_all_reduce(group):
    """The process group's own all-reduce over ``group``, in place: NCCL's
    on an NCCL group, gloo's (card tensors through the host) on a gloo
    one."""
    import torch.distributed as dist

    return lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.process_group)


def probe_all_reduce(reduce, shape, device: torch.device, src: Optional[torch.Tensor] = None) -> dict:
    """One capture of ``reduce`` (an in-place all-reduce) of a ``shape`` f32
    buffer (``src``, else seeded normals, copied into it first, so a replay
    recomputes it from its source) after one eager call → its node types
    (``nodes``), whether a conditional body holds them (``body``) and
    whether the replay's bits are the eager call's (``bits``), or why the
    capture failed (``error``)."""
    from nislam_torch.core.chunk_graph import BODY_TYPES, node_types
    from nislam_torch.core.track_graph import no_collection
    from nislam_torch.kernels.launch import cond_graph_library

    if src is None:
        gen = torch.Generator(device=device).manual_seed(0)
        src = torch.randn(shape, generator=gen, device=device)
    buf = torch.zeros_like(src)

    def step() -> None:
        buf.copy_(src)
        reduce(buf)

    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream(device).wait_stream(stream)
        want = buf.clone()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with no_collection(), torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            step()
        graph.instantiate()
        nodes = node_types(cond_graph_library(), graph.raw_cuda_graph())
        buf.zero_()
        graph.replay()
        torch.cuda.synchronize(device)
        same = buf.view(torch.int32).equal(want.view(torch.int32))
        return {"nodes": nodes, "body": set(nodes) <= BODY_TYPES, "bits": same}
    except RuntimeError as e:  # a capture that the backend breaks
        return {"error": str(e).splitlines()[0][:200]}
    finally:
        torch.cuda.synchronize(device)


def peer_payloads(k: int, canvas: int, ranks: int, image=(480, 640)) -> dict:
    """``{label: (shape, dtype)}`` of the distributed engine's all-reduces:
    the GN-CG trigger's, the loop search's winner record and an evicted
    keyframe image's bits."""
    from nislam_torch.parallel.loop_search import RECORD

    f32 = {label: (shape, torch.float32) for label, shape in nccl_payloads(k, canvas).items()}
    return {**f32, f"({ranks}, {RECORD}) search record": ((ranks, RECORD), torch.float32),
            f"{image} image bits, int32": (image, torch.int32)}


def order_payload(shape, dtype, rank: int, device: torch.device, seed: int = 0) -> torch.Tensor:
    """Rank ``rank``'s values of a probe, made from ``seed`` with numpy: for
    float32 normals scaled by 2^-20 to 2^20, whose float sum changes with
    its order; for int32 the whole range, whose sum wraps."""
    import numpy as np

    rng = np.random.default_rng([seed, rank])
    if dtype == torch.int32:
        x = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64).astype(np.int32)
    else:
        x = (rng.standard_normal(shape) * np.exp2(rng.integers(-20, 21, size=shape))).astype(np.float32)
    return torch.from_numpy(x).to(device)


def edge_payloads(size: int) -> dict:
    """``{label: (shape, dtype, one_shot_bytes)}``: the kernel's protocol
    edges at ``size`` ranks (``ops/all_reduce.py::launch_plan``): counts of
    1, 3 and n·4 + 1 in the one shot and forced into the two shot (its
    owners' ranges empty, short, ragged), each side of the crossover, and a
    two shot of three rounds whose last is ragged."""
    from nislam_torch.ops.all_reduce import ONE_SHOT_BYTES, SLOT_BYTES

    out = {}
    for count in (1, 3, 4 * size + 1):
        out[f"({count},) one shot"] = ((count,), torch.float32, ONE_SHOT_BYTES)
        out[f"({count},) two shot"] = ((count,), torch.int32, 0)
    edge = ONE_SHOT_BYTES // 4
    out[f"({edge},) the one shot's largest"] = ((edge,), torch.float32, ONE_SHOT_BYTES)
    out[f"({edge + 1},) the two shot's smallest"] = ((edge + 1,), torch.float32, ONE_SHOT_BYTES)
    rounds = 2 * SLOT_BYTES // 4 + 4 * size + 3
    out[f"({rounds},) three rounds"] = ((rounds,), torch.int32, ONE_SHOT_BYTES)
    return out


def bound_us(nbytes: int, ranks: int, shared: bool) -> float:
    """The least time of one all-reduce of ``nbytes`` per rank, in place:
    at one rank none (the sum is the payload, already in place); on one
    card the n payloads read once and the sum written once over HBM
    ((n + 1)·P at 3.35 TB/s); across cards what any all-reduce must send
    and receive per rank over NVLink, 2·(n − 1)/n·P at 450 GB/s each way
    (a reduce-scatter and an all-gather)."""
    if ranks == 1:
        return 0.0
    if shared:
        return 1e6 * (ranks + 1) * nbytes / 3.35e12
    return 1e6 * 2 * (ranks - 1) / ranks * nbytes / 450e9


def _events_us(fn, reps: int, device: torch.device) -> float:
    """µs of ``reps`` back-to-back calls of ``fn`` in all (CUDA events)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return 1e3 * a.elapsed_time(b)


def line_up(group, fn, device: torch.device) -> None:
    """One call of ``fn`` (every rank's), a synchronize and the process
    group's barrier: every rank starts what follows together."""
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize(device)
    if group.size > 1:
        dist.barrier(group=group.process_group)


def _lined_up_us(group, fn, run, n: int, device: torch.device) -> float:
    """µs of ``n`` calls of ``run`` after the ranks were lined up by ``fn``."""
    line_up(group, fn, device)
    return _events_us(run, n, device)


def per_call_us(group, fn, device: torch.device, reps: int, graphs: bool, tries: int = 3) -> dict:
    """µs per call of ``fn`` in steady state: ``tries`` pairs of runs, one
    of ``reps`` calls and one of 10·``reps`` (eager back to back, or one
    captured graph of each length replayed), each run after the ranks were
    lined up; a pair's difference over 9·``reps`` calls.  A stall in the
    shorter run lowers a difference as one in the longer raises it, so
    ``us`` is the median of the pairs' positive differences; a difference
    that is not positive is no time and is counted (``nonpositive``; ``us``
    0.0 if no difference is positive).  ``first_us``: the least of the
    pairs' single calls after lining up, which hold the ranks' skew."""
    from nislam_torch.core.track_graph import no_collection

    lengths = (1, reps, 10 * reps)
    if graphs:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        made = {}
        for n in lengths:
            graph = torch.cuda.CUDAGraph()
            with no_collection(), torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                for _ in range(n):
                    fn()
            made[n] = graph
        run = lambda n: _lined_up_us(group, fn, made[n].replay, 1, device)
    else:
        run = lambda n: _lined_up_us(group, fn, fn, n, device)
    first, diffs = [], []
    for _ in range(tries):
        times = {n: run(n) for n in lengths}
        first.append(times[1])
        diffs.append((times[10 * reps] - times[reps]) / (9 * reps))
    torch.cuda.synchronize(device)
    positive = [d for d in diffs if d > 0]
    return {"us": statistics.median(positive) if positive else 0.0, "first_us": min(first), "nonpositive": len(diffs) - len(positive)}


def library_times(group, buf: torch.Tensor, device: torch.device, reps: int = 20) -> dict:
    """µs per call in steady state of the process group's own eager
    all-reduce of ``buf`` in place (:func:`library_all_reduce`, timed as
    :func:`per_call_us` times the port's) → ``library_us`` and
    ``library_nonpositive``.  Every rank calls it, in the same order."""
    library = library_all_reduce(group)
    t = per_call_us(group, lambda: library(buf), device, reps, graphs=False)
    return {"library_us": t["us"], "library_nonpositive": t["nonpositive"]}


def call_times(group, buf: torch.Tensor, device: torch.device, shared: bool, reps: int = 20,
               launches: bool = True, library: bool = True) -> dict:
    """µs per call in steady state of the port's all-reduce of ``buf`` in
    place over ``group`` (every rank calls it, in the same order), eager
    and captured (:func:`per_call_us`, ``reps``; 0 where nothing
    launches), the first call's time apart and each one's count of
    differences that were not positive; the library's eager all-reduce on
    the same buffer timed the same way (``library_us``: NCCL's, or gloo's
    on a gloo group; ``library``: whether to time it here, else
    :func:`library_times` does later); the bound (:func:`bound_us`)."""
    from nislam_torch.ops.all_reduce import all_reduce

    call = lambda: all_reduce(buf, group)
    res = {}
    for label, graphs in (("eager", False), ("captured", True)):
        t = per_call_us(group, call, device, reps, graphs) if launches else {"us": 0.0, "first_us": 0.0,
                                                                              "nonpositive": 0}
        res.update({f"{label}_us": t["us"], f"{label}_first_us": t["first_us"],
                    f"{label}_nonpositive": t["nonpositive"]})
    if library:
        res.update(library_times(group, buf, device, reps))
    res["bytes"] = buf.numel() * buf.element_size()
    res["bound_us"] = bound_us(res["bytes"], group.size, shared)
    return res


def probe_peer(group, shape, dtype, device: torch.device, shared: bool, reps: int = 20,
               one_shot_bytes: Optional[int] = None, library: bool = True) -> dict:
    """The port's all-reduce over ``group`` at one payload (every rank calls
    it, in the same order; ``one_shot_bytes`` moves the plan's threshold):
    its plan (``protocol``, ``blocks``, ``rounds``), the kernel eager
    against its plain version on the same values (``equal``), every rank's
    result the same (``ranks_equal``), the capture's node types, body and
    replay bits; its times, the library's (``library``) and the bound
    (:func:`call_times`); the plain version's time (host clock around a
    synchronized call)."""
    import time

    from nislam_torch.ops.all_reduce import NONE, all_reduce

    with group.peers.tuned(one_shot_bytes):
        x = order_payload(shape, dtype, group.rank, device)
        plan = group.peers.plan(x.numel())
        want = all_reduce(x.clone(), group, force="reference")
        got = all_reduce(x.clone(), group)
        bits = lambda t: t.reshape(-1).view(torch.int32)
        rows = group.gather_exact(bits(got))
        res = {"protocol": ("none", "one shot", "two shot")[plan.protocol], "blocks": plan.blocks,
               "rounds": plan.rounds,
               "equal": bool(torch.equal(bits(got), bits(want))),
               "ranks_equal": bool(all(torch.equal(r, rows[0]) for r in rows)),
               "max_abs_err": float((got.double() - want.double()).abs().nan_to_num(nan=float("inf")).max())}
        if dtype == torch.float32:
            res.update(probe_all_reduce(lambda t: all_reduce(t, group), shape, device, src=x))
        buf = x.clone()
        res.update(call_times(group, buf, device, shared, reps, launches=plan.protocol != NONE, library=library))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            all_reduce(buf, group, force="reference")
        torch.cuda.synchronize(device)
        res["plain_us"] = 1e6 * (time.perf_counter() - t0) / 3
        group.check()
    return res


def peer_ok(res: dict) -> bool:
    """Whether a :func:`probe_peer` row held: bits equal to the plain
    version and on every rank; a capture that a body holds, one kernel node
    at n ranks and none at one, whose replay gives the eager bits."""
    kernels = res.get("nodes", {}).get("kernel", 0)
    return bool(res["equal"] and res["ranks_equal"] and res.get("body", True) and res.get("bits", True)
                and ("nodes" not in res or kernels == (res["protocol"] != "none")))


def peer_lines(group, device: torch.device, k: int, canvas: int, shared: bool, log=print) -> dict:
    """:func:`probe_peer` at every payload of :func:`peer_payloads` and of
    :func:`edge_payloads`, one line each → {label: row}."""
    rows = {}
    cases = {label: (shape, dtype, None) for label, (shape, dtype) in peer_payloads(k, canvas, group.size).items()}
    cases.update(edge_payloads(group.size))
    for label, (shape, dtype, one_shot) in cases.items():
        rows[label] = res = probe_peer(group, shape, dtype, device, shared, one_shot_bytes=one_shot)
        log(f"peer all_reduce {label:40s} {'ok' if peer_ok(res) else 'FAILED'} {res}")
    return rows


def crossover_lines(group, device: torch.device, log=print, reps: int = 20) -> dict:
    """Captured µs per call of the one shot and of the two shot at payloads
    from 4 KB to 2 MB: where the plan's threshold belongs.  Every rank
    calls it."""
    from nislam_torch.ops.all_reduce import ONE_SHOT_CAPACITY, all_reduce

    out = {}
    for nbytes in (4 << 10, 16 << 10, 64 << 10, 128 << 10, 256 << 10, 512 << 10, 1 << 20, 2 << 20):
        buf = order_payload((nbytes // 4,), torch.float32, group.rank, device)
        row = {}
        for label, one_shot in (("one shot", ONE_SHOT_CAPACITY), ("two shot", 0)):
            with group.peers.tuned(one_shot):
                row[label] = per_call_us(group, lambda: all_reduce(buf, group), device, reps, graphs=True)["us"]
        out[nbytes] = row
        log(f"crossover {nbytes} B: " + ", ".join(f"{k} {v:.2f} us" for k, v in row.items())
            + f" | bound {bound_us(nbytes, group.size, False):.3f}")
    group.check()
    return out


def time_lines(group, device: torch.device, k: int, canvas: int, shared: bool, log=print) -> dict:
    """:func:`call_times` at every payload of :func:`peer_payloads`, one
    line each → {label: row}.  It uses nothing but the package's
    ``all_reduce(x, group)``, so this file copied into an earlier checkout
    times that checkout's kernel by the same method."""
    rows = {}
    for label, (shape, dtype) in peer_payloads(k, canvas, group.size).items():
        buf = order_payload(shape, dtype, group.rank, device)
        rows[label] = res = call_times(group, buf, device, shared)
        log(f"peer all_reduce times {label:40s} {res}")
    group.check()
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cuda:<n>")
    ap.add_argument("--nccl", action="store_true", help="capture a one-rank NCCL group's own all-reduces instead")
    ap.add_argument("--peer", action="store_true", help="probe the port's peer all-reduce kernel instead")
    ap.add_argument("--k", type=int, default=272, help="--nccl/--peer: the poses of the (K, 3) payloads")
    ap.add_argument("--canvas", type=int, default=1024, help="--nccl/--peer: the canvas side S of the delta")
    ap.add_argument("--ranks", type=int, default=1, help="--nccl/--peer: ranks, one process each")
    ap.add_argument("--shared", action="store_true", help="--ranks: every rank on --device, over gloo")
    ap.add_argument("--crossover", action="store_true",
                    help="--peer --ranks N on N cards: time the one shot against the two shot by payload")
    ap.add_argument("--times", action="store_true",
                    help="--peer --ranks N: only the times by payload (time_lines), then the trigger row")
    ap.add_argument("--rank", type=str, default=None, help=argparse.SUPPRESS)  # "RANK PORT" of a started rank
    args = ap.parse_args(argv)
    if (args.nccl or args.peer) and args.ranks > 1:
        return spawn_ranks(args) if args.rank is None else rank_nccl(args)
    device = asked_device(args.device, "captureprobe")
    if device.type != "cuda":
        print("captureprobe: captures exist only on a card (--device cuda)", file=sys.stderr)
        return 2
    print(f"device: {card_line(device)}", flush=True)
    if args.nccl or args.peer:
        return main_nccl(device, args.k, args.canvas, args.peer)
    for label, (fn, lib) in operations(device).items():
        print(f"{label:55s} {probe(fn, lib, device)}", flush=True)
    return 0


def main_nccl(device: torch.device, k: int, canvas: int, peer: bool) -> int:
    """The one-rank probe's lines (``peer``: the port's kernel, else NCCL's
    own all-reduce); exit code 1 unless every capture holds only body node
    types and replays the eager bits (and, ``peer``, every check held)."""
    import socket

    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "nccl", device)
    ok = True
    try:
        print(f"torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
              f"backend {group.backend}, capturable {group.capturable}", flush=True)
        if peer:
            rows = peer_lines(group, device, k, canvas, False, log=lambda line: print(line, flush=True))
            ok = all(map(peer_ok, rows.values()))
        else:
            for label, shape in nccl_payloads(k, canvas).items():
                res = probe_all_reduce(library_all_reduce(group), shape, device)
                ok &= res.get("body", False) and res.get("bits", False)
                print(f"nccl all_reduce {label:40s} {res}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def spawn_ranks(args) -> int:
    """``--ranks N``: N processes of this module, one rank each, on one
    rendezvous; their output in rank order; exit 1 unless all succeed."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "nislam_torch.scripts.captureprobe", "--peer" if args.peer else "--nccl",
           "--ranks", str(args.ranks), "--device", args.device, "--k", str(args.k), "--canvas", str(args.canvas),
           *(["--shared"] if args.shared else []), *(["--crossover"] if args.crossover else []),
           *(["--times"] if args.times else [])]
    procs = [subprocess.Popen([*cmd, "--rank", f"{r} {port}"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(args.ranks)]
    rc = 0
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=400)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + "\n(killed after 400 s)"
        print("\n".join(f"rank {r}: {line}" for line in out.splitlines()), flush=True)
        rc |= p.returncode != 0
    return int(rc)


def rank_nccl(args) -> int:
    """One rank of ``--ranks N``: NCCL on ``cuda:<rank>`` (``--shared``:
    gloo, every rank on ``--device``; gloo on CPU tensors with ``--device
    cpu``): with ``--peer`` the peer kernel's probe lines first, then the
    distributed trigger's row over the group; with ``--nccl`` NCCL's own
    capture after it."""
    import json

    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed
    from nislam_torch.scripts import stagebench

    rank, port = (int(x) for x in args.rank.split())
    cpu = torch.device(args.device).type == "cpu"
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    elif args.shared:
        device, backend = torch.device(args.device), "gloo"
        if device.index is None:
            device = torch.device("cuda", 0)
    else:
        device, backend = torch.device("cuda", rank), "nccl"
    group = init_distributed(f"tcp://127.0.0.1:{port}", args.ranks, rank, backend, device, timeout_s=300.0)
    log = lambda line: print(line, flush=True)
    ok = True
    try:
        if not cpu:
            log(f"device: {card_line(device)}, torch {torch.__version__}, NCCL "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}, backend {group.backend}, capturable "
                f"{group.capturable}")
            if args.peer and args.times:
                time_lines(group, device, args.k, args.canvas, args.shared, log)
            elif args.peer:
                rows = peer_lines(group, device, args.k, args.canvas, args.shared, log)
                ok &= all(map(peer_ok, rows.values()))
                if args.crossover and not args.shared:
                    crossover_lines(group, device, log)
        for label, case in stagebench.TRIGGER_CASES.items():
            rows = stagebench.trigger_row(case, group, 3, device, log=lambda route, row: log(f"{route}: {row}"))
            ok &= all(r["equal"] and r["ran"] for r in rows.values())
            log(f"{args.ranks} ranks, {stagebench.trigger_line(label, rows)}")
            log(json.dumps({"trigger": rows, "ranks": args.ranks, "backend": group.backend}))
        if not cpu and args.nccl and backend == "nccl":  # after the trigger: a probe's graphs leave nothing behind
            for label, shape in nccl_payloads(args.k, args.canvas).items():
                res = probe_all_reduce(library_all_reduce(group), shape, device)
                log(f"nccl all_reduce {label:40s} {res}")
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
