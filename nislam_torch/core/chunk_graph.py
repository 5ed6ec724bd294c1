"""A chunk of tracked frames as ONE CUDA graph launch, the keyframe branch inside it.

The port's own module.  JAX's ``SlamEngine.run_chunk``
(``nislam_tpu/core/slam.py:235-258``) is one jitted ``lax.scan`` whose
step runs the keyframe branch as ``lax.cond``: a chunk makes no host read
between its frames.  :class:`ChunkGraph` is its counterpart over a
:class:`~nislam_torch.core.frame_graph.FrameGraph` (or the batch engine's
:class:`~nislam_torch.core.frame_graph.BatchFrameGraph`): one graph whose
outer body is a WHILE loop over the chunk's frames,

1. ``copy_in``: frame i's features (``img_u``, ``fft``, ``polar``) into
   the track graph's inputs;
2. ``track``: the track graph, nested whole;
3. ``flags``: the ``[insert, stored]`` flags of each lane set the IF
   handles; a lane that needs a branch kind the graph does not hold yet
   sets ``stop``;
4. ``branch``: one IF node per branch graph the frame graph holds (lane,
   kind: stored or dropped), its body that branch graph and a count of
   its runs;
5. ``advance``: unless ``stop``, the packed output into row i of the
   chunk's output, i += 1, and the WHILE condition ``i < n``.

:func:`outer_body` is that description, once.  On a card the steps are the
nodes of the graph that ``csrc/cond_graph.cu`` builds (its kernels:
``copy_in``, ``flags``, ``advance``, the run counts) over the graphs that
PyTorch captured (:meth:`CapturedStep.raw_graph`); on the CPU they are
the steps of a Python loop over the same buffers (:func:`_flags` and
:func:`_advance` are the kernels' plain versions), which is the plain
program.  Both keep their state in the same int32 control block
(:data:`CTL_WORDS` words: the frame index, the end, ``stop``, the frames
done, the runs per slot; on a card the chunk's table after them), which
the host reads once after the chunk.

A branch kind is captured at its first use, after an eager run
(:meth:`FrameGraph.branch_step`), so a graph built before the kind exists
cannot hold it.  The graph does not guess: a frame that needs it stops the
chunk after its track graph.  The host reads where it stopped, finishes
that frame through :meth:`FrameGraph.finish` (the flag read, the branches,
the missing one captured), rebuilds the graph with the new kind and
resumes at the next frame.  The data decide this path (``early_exits``
counts it), never a failure: a build, instantiation or launch that fails
raises, and nothing falls back to the flag-read path.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch

from nislam_torch.core.frame_graph import branch_slot, flag_rows
from nislam_torch.core.track_graph import CapturedStep
from nislam_torch.kernels.launch import cond_graph_library, cuda_check

# The control block, in int32 words (csrc/cond_graph.cu's kI ... kTable).
I, N, STOP, DONE, RUNS = 0, 1, 2, 3, 4
MAX_LANES = 32
CTL_WORDS = RUNS + 2 * MAX_LANES + 16  # the runs of every slot, then the card's table (8 int64)
WIDTH = 17  # StepOutput.pack's fields

# cudaGraphNodeType names, by value; the last entry any later type.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
              "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "other")
# What a conditional body may hold (CUDA's conditional-node rules).
BODY_TYPES = frozenset(("kernel", "memcpy", "memset", "graph", "empty", "conditional"))


def outer_body(slots: Sequence[int]) -> tuple:
    """One WHILE iteration, in order: the card's body nodes and the CPU's
    loop steps.  ``slots``: the branch graphs the body holds."""
    return (("copy_in",), ("track",), ("flags",), *(("branch", s) for s in slots), ("advance",))


def _flags(ctl: torch.Tensor, flags: torch.Tensor, slots: Sequence[int]) -> set:
    """The ``flags`` kernel's plain version: sets ``stop`` when a lane
    inserts a keyframe of a kind that ``slots`` lacks → the IF slots taken."""
    need = {branch_slot(lane, stored) for lane, (insert, stored) in enumerate(flag_rows(flags.tolist())) if insert}
    stop = not need <= set(slots)
    ctl[STOP] = int(stop)
    return set() if stop else need


def _advance(ctl: torch.Tensor, packed: torch.Tensor, out: torch.Tensor) -> bool:
    """The ``advance`` kernel's plain version → the WHILE condition."""
    i, stop = int(ctl[I]), int(ctl[STOP])
    if not stop:
        row(out, i).copy_(packed)
        ctl[I] = i + 1
        ctl[DONE] += 1
    return not stop and i + 1 < int(ctl[N])


def row(out: torch.Tensor, i: int) -> torch.Tensor:
    """Frame i of a chunk's packed output: (n, 17), or (B, n, 17) lanes first."""
    return out[i] if out.dim() == 2 else out[:, i]


class ChunkGraph:
    """Frames of a chunk through one graph launch over ``frame_graph``'s
    buffers (its loaded state).  :meth:`run` is the entry point."""

    # Graph launches on a card, by every instance: the wrapper's count.
    launches = 0

    def __init__(self, frame_graph):
        self.frame_graph = frame_graph
        self.device = frame_graph.device
        self.lanes = frame_graph.lanes
        if self.lanes > MAX_LANES:
            raise ValueError(f"a chunk graph holds at most {MAX_LANES} lanes, got {self.lanes}")
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=self.device)
        self.early_exits = 0  # frames that stopped a chunk for a branch kind not captured yet
        self.node_types: Dict[str, int] = {}  # of the graphs the card's build nested
        self._slots: Optional[Tuple[int, ...]] = None  # what the built program holds
        self._graph: Optional[_CardGraph] = None

    @property
    def built(self) -> bool:
        return self._slots is not None

    def run(self, feats: Tuple[torch.Tensor, ...], out: torch.Tensor, start: int) -> None:
        """Frames ``[start, n)`` of the chunk's features ``(img_u, fft,
        polar)``, each (n, ...) frame-major (a frame's lanes contiguous),
        into the rows of ``out`` ((n, 17), or (B, n, 17)); the loaded state
        is updated in place.  One host read per launch (where the chunk
        ended), and the first use's and an early exit's frame through the
        frame graph."""
        fg = self.frame_graph
        n = feats[1].shape[0]
        i = start
        if i < n and fg.track.outputs is None:  # the first use: the track graph's capture
            row(out, i).copy_(fg.run(*(x[i] for x in feats)))
            i += 1
        feats = tuple(x.contiguous() for x in feats)
        while i < n:
            self.launch(feats, out, i, n)
            i, stop = self._read()
            if not stop:
                break
            # Frame i ran its track graph and needs a branch kind the
            # graph lacks: finish it on the host, which captures the kind.
            self.early_exits += 1
            fg.finish()
            row(out, i).copy_(fg.track.outputs.packed)
            i += 1

    def _build(self) -> None:
        """The program for the branch graphs the frame graph holds now: on
        a card the graph (built again when a kind was added), on the CPU
        the list of slots."""
        slots = tuple(sorted(self.frame_graph.branch_slots()))
        if slots == self._slots:
            return
        if self.device.type == "cuda":
            self._graph = None  # the old one is destroyed first
            self._graph = _CardGraph(self, slots)
            self.node_types = self._graph.node_types
            CapturedStep.captures += 1
        self._slots = slots

    def launch(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        """Frames ``[i0, n)`` as one launch (the graph built first when the
        frame graph holds other branch kinds), with no read after it: the
        caller reads the control block, as :meth:`run` does.  Back-to-back
        launches time the chunk (``stagebench``)."""
        self._build()
        self._launch(feats, out, i0, n)

    def _launch(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        if self.device.type == "cuda":
            self._graph.launch(feats, out, i0, n)
            ChunkGraph.launches += 1
        else:
            self._plain(feats, out, i0, n)

    def _read(self) -> Tuple[int, bool]:
        """The one host read after a launch → (the frame it ended at,
        stopped); on a card each nested graph's counted launches are added:
        the track graph's per frame it ran, each branch graph's per run."""
        ctl = self.ctl[:RUNS + 2 * self.lanes].tolist()
        i, stop, done = ctl[I], bool(ctl[STOP]), ctl[DONE]
        if self.device.type == "cuda":
            fg = self.frame_graph
            fg.track.step.count_replays(done + int(stop))
            for s, step in fg.branch_slots().items():
                step.count_replays(ctl[RUNS + s])
        return i, stop

    def _plain(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        """The plain program: :func:`outer_body` as a loop on the host over
        the same buffers and control block."""
        fg, ctl = self.frame_graph, self.ctl
        ctl[:RUNS + 2 * self.lanes] = 0
        ctl[I], ctl[N] = i0, n
        steps = fg.branch_slots()
        dst = _copy_targets(fg)
        body = outer_body(self._slots)
        more = True
        while more:
            i = int(ctl[I])
            for op, *args in body:
                if op == "copy_in":
                    for d, x in zip(dst, feats):
                        d.copy_(x[i])
                elif op == "track":
                    fg.track.step.run()
                elif op == "flags":
                    taken = _flags(ctl, fg.track.outputs.flags, self._slots)
                elif op == "branch":
                    if args[0] in taken:
                        steps[args[0]].run()
                        ctl[RUNS + args[0]] += 1
                else:
                    more = _advance(ctl, fg.track.outputs.packed, out)


def _copy_targets(fg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where ``copy_in`` writes a frame's ``(img_u, fft, polar)``."""
    return fg.track.inputs.img_u, fg.fft, fg.track.inputs.polar


def _check_raw(x: torch.Tensor, what: str) -> int:
    if not x.is_contiguous():
        raise ValueError(f"the chunk graph needs a contiguous {what}")
    return x.data_ptr()


def node_types(lib, graph: int) -> Dict[str, int]:
    """The node types of a captured graph (child graphs walked) by name."""
    counts = (ctypes.c_int * len(NODE_TYPES))()
    cuda_check(lib.nislam_graph_node_types(graph, counts, len(NODE_TYPES)), "reading a captured graph's nodes")
    return {name: counts[k] for k, name in enumerate(NODE_TYPES) if counts[k]}


def build_graph(lib, ctl: torch.Tensor, lanes: int, slots: Sequence[int], copies, track: int, flags: int,
                branches: Dict[int, int], packed: int) -> ctypes.c_void_p:
    """The card's graph of :func:`outer_body`, through ``cond_graph.cu``'s
    entry points: ``copies`` the three (destination address, bytes), ``track``
    and ``branches`` (slot → graph) the cudaGraph_t handles to nest,
    ``flags`` and ``packed`` the addresses of the track graph's flags and
    packed output.  Raises at the first step the runtime refuses."""
    h = ctypes.c_void_p()
    cuda_check(lib.nislam_cg_create(ctypes.byref(h), ctl.data_ptr(), lanes), "creating the chunk graph")
    try:
        for op, *args in outer_body(slots):
            if op == "copy_in":
                err = lib.nislam_cg_add_copy_in(h, *(v for c in copies for v in c))
            elif op == "track":
                err = lib.nislam_cg_add_child(h, track)
            elif op == "flags":
                err = lib.nislam_cg_add_flags(h, flags, sum(1 << s for s in slots))
            elif op == "branch":
                err = lib.nislam_cg_add_branch(h, args[0], branches[args[0]])
            else:
                err = lib.nislam_cg_add_advance(h, packed, WIDTH)
            cuda_check(err, f"adding the chunk graph's {op} node")
        cuda_check(lib.nislam_cg_instantiate(h), "instantiating the chunk graph")
    except BaseException:
        lib.nislam_cg_destroy(h)
        raise
    return h


def launch_graph(lib, h, device: torch.device, feats, out: torch.Tensor, i0: int, n: int) -> None:
    """Frames [i0, n) of ``feats`` (three (n, ...) tensors; None for a
    segment the graph does not copy) into ``out``, on the current stream."""
    srcs = []
    for x in feats:
        srcs += [None, 0] if x is None else [x.data_ptr(), x[0].numel() * x.element_size()]
    lane_stride = out.stride(0) if out.dim() == 3 else 0
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_check(lib.nislam_cg_launch(h, i0, n, *srcs, out.data_ptr(), lane_stride, stream),
               "launching the chunk graph")


class _CardGraph:
    """The built graph on a card: holds the nested steps (their memory
    pools and workspaces) for as long as it lives, and is destroyed with
    it."""

    def __init__(self, chunk: ChunkGraph, slots: Tuple[int, ...]):
        fg = chunk.frame_graph
        self._lib = lib = cond_graph_library()
        outs = fg.track.outputs
        steps = fg.branch_slots()
        self.nested = (fg.track.step, *(steps[s] for s in slots))
        graphs = {"track": fg.track.step.raw_graph(), **{s: steps[s].raw_graph() for s in slots}}
        self.node_types: Dict[str, int] = {}
        for g in graphs.values():
            for name, k in node_types(lib, g).items():
                self.node_types[name] = self.node_types.get(name, 0) + k
        bad = set(self.node_types) - BODY_TYPES
        if bad:
            raise RuntimeError(f"a captured graph holds nodes that a conditional body cannot: {sorted(bad)}")
        copies = [(_check_raw(d, "copy target"), d.numel() * d.element_size()) for d in _copy_targets(fg)]
        self._copy_shapes = [tuple(d.shape) for d in _copy_targets(fg)]
        self._copy_dtypes = [d.dtype for d in _copy_targets(fg)]
        h = build_graph(lib, chunk.ctl, chunk.lanes, slots, copies, graphs["track"],
                        _check_raw(outs.flags, "flags output"), {s: graphs[s] for s in slots},
                        _check_raw(outs.packed, "packed output"))
        self._h = h
        self._finalizer = weakref.finalize(self, lib.nislam_cg_destroy, h)
        self._device = chunk.device

    def launch(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        for x, shape, dtype in zip(feats, self._copy_shapes, self._copy_dtypes):
            if tuple(x.shape[1:]) != shape or x.dtype != dtype or not x.is_contiguous() or x.device != self._device:
                raise ValueError(f"chunk features {tuple(x.shape)} {x.dtype} do not fit the graph's {shape} {dtype}")
        if not out.is_contiguous() or out.dtype != torch.float32 or out.shape[-1] != WIDTH:
            raise ValueError(f"the chunk graph writes a contiguous float32 (..., {WIDTH}) output")
        launch_graph(self._lib, self._h, self._device, feats, out, i0, n)


class EmptyBodies:
    """A chunk graph whose nested graphs (the track graph, both branches of
    one lane) are one empty kernel each, over the copies of ``feats``'
    frames (three (n, ...) tensors; None for none) and a (2,) flag that
    takes the stored IF (``taken``) or none: what the outer body costs the
    card per frame by itself (``stagebench``, ``chip_smoke.py``)."""

    def __init__(self, device: torch.device, frames: int, feats=None, taken: bool = False):
        self._lib = lib = cond_graph_library()
        self.frames = frames
        self.feats = feats if feats is not None else (None, None, None)
        self.targets = tuple(None if x is None else torch.empty_like(x[0]) for x in self.feats)
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)
        self.flags = torch.tensor([taken, True], device=device)
        self.packed = torch.zeros(WIDTH, device=device)
        self.out = torch.zeros((frames, WIDTH), device=device)
        empty = ctypes.c_void_p()
        cuda_check(lib.nislam_cg_empty_graph(ctypes.byref(empty)), "making an empty graph")
        try:
            copies = [(0, 0) if t is None else (t.data_ptr(), t.numel() * t.element_size()) for t in self.targets]
            self._h = build_graph(lib, self.ctl, 1, (0, 1), copies, empty.value, self.flags.data_ptr(),
                                  {0: empty.value, 1: empty.value}, self.packed.data_ptr())
        finally:
            lib.nislam_graph_destroy(empty)  # the graph holds clones
        self._finalizer = weakref.finalize(self, lib.nislam_cg_destroy, self._h)
        self._device = device

    def launch(self) -> None:
        """One launch over every frame, on the current stream."""
        launch_graph(self._lib, self._h, self._device, self.feats, self.out, 0, self.frames)
