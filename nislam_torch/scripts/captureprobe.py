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

captures instead ``RankGroup.all_reduce`` on a one-rank NCCL group
(``init_distributed(..., "nccl", ...)`` over ``tcp://127.0.0.1:<free
port>``) of the GN-CG trigger's payloads: a (K, 3) f32 vector, the
(2, K, 3) gradient block, the (1,) cost and a (2, S, S) canvas delta,
each after one eager call, on a side stream with
``CUDAGraph(keep_graph=True)``; prints the node types of each capture,
whether a conditional body holds them, and whether a replay gives the
eager call's bits.

    python -m nislam_torch.scripts.captureprobe --nccl --ranks 4   # a card per rank
    python -m nislam_torch.scripts.captureprobe --nccl --ranks 4 --device cpu   # gloo, no capture

starts that many ranks as processes of this module (NCCL on ``cuda:<rank>``;
with ``--device cpu`` gloo on CPU tensors, which captures nothing), each
printing its probe lines and then ``stagebench --solve``'s distributed
trigger row over the group (``stagebench.trigger_row``: the host loop, the
program with the host making the collectives and, on one NCCL rank, the one
launch: bits against the host loop, host syncs, ms per solving trigger).
"""

from __future__ import annotations

import argparse
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


def probe_all_reduce(group, shape, device: torch.device) -> dict:
    """One capture of ``group.all_reduce`` of a ``shape`` f32 buffer (a copy
    into it first, so a replay recomputes it from its source) after one
    eager call → its node types (``nodes``), whether a conditional body
    holds them (``body``) and whether the replay's bits are the eager
    call's (``bits``), or why the capture failed (``error``)."""
    from nislam_torch.core.chunk_graph import BODY_TYPES, node_types
    from nislam_torch.kernels.launch import cond_graph_library

    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.randn(shape, generator=gen, device=device)
    buf = torch.zeros_like(src)

    def step() -> None:
        buf.copy_(src)
        group.all_reduce(buf, record=False)

    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(stream):
            step()
        want = buf.clone()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cuda:<n>")
    ap.add_argument("--nccl", action="store_true", help="capture a one-rank NCCL group's all-reduces instead")
    ap.add_argument("--k", type=int, default=272, help="--nccl: the poses of the (K, 3) payloads")
    ap.add_argument("--canvas", type=int, default=1024, help="--nccl: the canvas side S of the delta")
    ap.add_argument("--ranks", type=int, default=1, help="--nccl: ranks, one process each")
    ap.add_argument("--rank", type=str, default=None, help=argparse.SUPPRESS)  # "RANK PORT" of a started rank
    args = ap.parse_args(argv)
    if args.nccl and args.ranks > 1:
        return spawn_ranks(args) if args.rank is None else rank_nccl(args)
    device = asked_device(args.device, "captureprobe")
    if device.type != "cuda":
        print("captureprobe: captures exist only on a card (--device cuda)", file=sys.stderr)
        return 2
    print(f"device: {card_line(device)}", flush=True)
    if args.nccl:
        return main_nccl(device, args.k, args.canvas)
    for label, (fn, lib) in operations(device).items():
        print(f"{label:55s} {probe(fn, lib, device)}", flush=True)
    return 0


def main_nccl(device: torch.device, k: int, canvas: int) -> int:
    """The NCCL probe's lines; exit code 1 unless every capture holds only
    body node types and replays the eager bits."""
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
              f"backend {group.backend}", flush=True)
        for label, shape in nccl_payloads(k, canvas).items():
            res = probe_all_reduce(group, shape, device)
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
    cmd = [sys.executable, "-m", "nislam_torch.scripts.captureprobe", "--nccl", "--ranks", str(args.ranks),
           "--device", args.device, "--k", str(args.k), "--canvas", str(args.canvas)]
    procs = [subprocess.Popen([*cmd, "--rank", f"{r} {port}"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(args.ranks)]
    rc = 0
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=200)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + "\n(killed after 200 s)"
        print("\n".join(f"rank {r}: {line}" for line in out.splitlines()), flush=True)
        rc |= p.returncode != 0
    return int(rc)


def rank_nccl(args) -> int:
    """One rank of ``--ranks N``: NCCL on ``cuda:<rank>`` (gloo with
    ``--device cpu``): the probe's lines (on a card), then the distributed
    trigger's row over the group."""
    import json

    import torch.distributed as dist

    from nislam_torch.parallel.mesh import init_distributed
    from nislam_torch.scripts import stagebench

    rank, port = (int(x) for x in args.rank.split())
    cpu = torch.device(args.device).type == "cpu"
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    group = init_distributed(f"tcp://127.0.0.1:{port}", args.ranks, rank, "gloo" if cpu else "nccl", device,
                             timeout_s=300.0)
    ok = True
    try:
        if not cpu:
            print(f"device: {card_line(device)}, torch {torch.__version__}, NCCL "
                  f"{'.'.join(map(str, torch.cuda.nccl.version()))}, backend {group.backend}, capturable "
                  f"{group.capturable}", flush=True)
        for label, case in stagebench.TRIGGER_CASES.items():
            rows = stagebench.trigger_row(case, group, 3, device,
                                          log=lambda route, row: print(f"{route}: {row}", flush=True))
            ok &= all(r["equal"] and r["ran"] for r in rows.values())
            print(f"{args.ranks} ranks, {stagebench.trigger_line(label, rows)}", flush=True)
            print(json.dumps({"trigger": rows, "ranks": args.ranks, "backend": group.backend}), flush=True)
        if not cpu:  # after the trigger: a probe's graphs leave nothing behind it
            for label, shape in nccl_payloads(args.k, args.canvas).items():
                res = probe_all_reduce(group, shape, device)
                print(f"nccl all_reduce {label:40s} {res}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
