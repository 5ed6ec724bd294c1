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


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cuda:<n>")
    args = ap.parse_args(argv)
    device = asked_device(args.device, "captureprobe")
    if device.type != "cuda":
        print("captureprobe: captures exist only on a card (--device cuda)", file=sys.stderr)
        return 2
    print(f"device: {card_line(device)}", flush=True)
    for label, (fn, lib) in operations(device).items():
        print(f"{label:55s} {probe(fn, lib, device)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
