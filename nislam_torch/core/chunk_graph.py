"""A chunk of tracked frames as ONE CUDA graph launch, the keyframe branch inside it.

The port's own module.  JAX's ``SlamEngine.run_chunk``
(``nislam_tpu/core/slam.py:235-258``) is one jitted ``lax.scan`` whose
step runs the keyframe branch as ``lax.cond``: a chunk makes no host read
between its frames.  :class:`ChunkGraph` is its counterpart over a
:class:`~nislam_torch.core.frame_graph.FrameGraph` (or the batch engine's
:class:`~nislam_torch.core.frame_graph.BatchFrameGraph`): one graph whose
outer body is a WHILE loop over the chunk's frames, after a copy of
frame i0's ``img_u`` and ``polar`` into the track graph's inputs:

1. ``track``: the track graph, nested whole;
2. ``flags``: the ``[insert, stored]`` flags choose the body the frame
   needs (its slot), or none, and add one to that body's run count, and
   ``NEXT = i + 1``; a frame that needs a body the graph does not hold
   yet sets ``stop`` instead.  The single engine's bodies are the kinds
   of its keyframe (slot 0 stored, 1 dropped); the batch engine's (over
   a :class:`~nislam_torch.core.frame_graph.BatchFrameGraph`, whose
   ``by_count`` is set) are keyed by the number k of lanes that insert
   (slot k − 1), as JAX's vmapped insert and loop search are one program
   over the lanes;
3. ``switch``: one step when the graph holds a body (one SWITCH node on a
   card): for the body taken, the frame-i spectra (``fft``: the one
   lane's, or every lane's) copied into the frame graph's buffer, then
   that body's graph (body k: the branch over the k lanes gathered on the
   device); with the inline solve, the single engine's stored body then
   runs the inline trigger (``core/solve_graph.py``): the trigger kernel
   gated by the frame's ``loop_found``, and under an IF node the setup, a
   WHILE over the LM iteration and ``lm_step``, and the inline finish;
4. ``advance_copy``: unless ``stop``, the packed output into row i of the
   chunk's output, i = ``NEXT``, the WHILE condition ``i < n``, and, when
   the loop goes on, frame i's ``img_u`` and ``polar`` copied in.

A frame that inserts nothing moves no spectrum.  :func:`outer_body` is
that description, once.  On a card the steps are the nodes of the graph
that ``csrc/cond_graph.cu`` builds (its kernels: the copy, ``flags``,
``advance_copy``) over the graphs that PyTorch captured
(:meth:`CapturedStep.raw_graph`); on the CPU they are the steps of a
Python loop over the same buffers (:func:`_flags` and :func:`_advance` are
the kernels' plain versions), which is the plain program.  Both keep
their state in the same int32 control block (:data:`CTL_WORDS` words:
the frame index, the end, ``stop``, the frames done, the runs per slot,
``NEXT``; on a card the chunk's table after them), which the host reads
once after the chunk.

A branch kind is captured at its first use, after an eager run
(:meth:`FrameGraph.branch_step`), so a graph built before the kind exists
cannot hold it.  The graph does not guess: a frame that needs it stops the
chunk after its track graph.  The host reads where it stopped, finishes
that frame through :meth:`FrameGraph.finish` (the flag read, the branches,
the missing one captured; the graph copies a spectrum only inside a
branch, so the host copies that frame's in first), rebuilds the graph
with the new kind and resumes at the next frame.  The data decide this
path (``early_exits`` counts it), never a failure: a build,
instantiation or launch that fails raises, and nothing falls back to the
flag-read path.  Over a
:class:`~nislam_torch.core.frame_graph.HostBranchFrameGraph` (the
distributed engine's on gloo with CPU tensors) the graph holds no body
at all: every frame that inserts stops the chunk after its track graph,
and the host finishes it with the branch as captured steps between its
collectives (``host_exits`` counts these, which are expected: nothing is
rebuilt for them); the read after the launch takes the frame's flags and
the staged loop search's frame-id check with the control block, so a
chunk costs one read per launch, one launch more than its inserting
frames (and, when its last frame inserts, one read of the check after
it).  Over a :class:`~nislam_torch.core.frame_graph.CollectiveFrameGraph`
(the distributed engine's on a card) the SWITCH holds its branches, the
peer all-reduces inside them, as for the single engine, and the one read
after a launch takes the frame-id check with the control block.  The inline
trigger's steps need no such exit: they are captured (primed, with no
lane running) before the first build that holds a stored kind, and the
host's one read after a launch takes the solve graph's growing counts
with the control block.
"""

from __future__ import annotations

import collections
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
NEXT = RUNS + MAX_LANES  # the frame the advance moves to: the flags kernel writes it
CTL_WORDS = NEXT + 2 + 16  # then the card's table (8 int64)
WIDTH = 17  # StepOutput.pack's fields

# cudaGraphNodeType names, by value; the last entry any later type.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
              "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "other")
# What a conditional body may hold (CUDA's conditional-node rules).
BODY_TYPES = frozenset(("kernel", "memcpy", "memset", "graph", "empty", "conditional"))
# nislam_cg_describe's fields: a built graph's nodes.
STRUCTURE = ("outer_nodes", "iteration_nodes", "iteration_conditionals", "iteration_kernels", "iteration_copies",
             "iteration_children", "branch_bodies", "empty_branch_bodies", "branch_nodes", "branch_conditionals",
             "branch_kernels", "branch_copies", "branch_children", "inline_ifs", "inline_if_nodes",
             "inline_if_conditionals", "inline_if_children", "inline_while_nodes", "depth")


def outer_body(slots: Sequence[int], inline: Optional[tuple] = None) -> tuple:
    """One WHILE iteration, in order: the card's body nodes and the CPU's
    loop steps.  ``slots``: the bodies the graph holds; with any, one
    ``("switch",)`` step over them.  ``inline``: the inline trigger's
    program (``core/solve_graph.py``'s ``solve_body(loops,
    inline=True)``), which the single engine's stored body (slot 0) runs
    after its branch: ``("switch", inline)``."""
    if not slots:
        switch = ()
    elif inline is not None and 0 in slots:
        switch = (("switch", inline),)
    else:
        switch = (("switch",),)
    return (("track",), ("flags",), *switch, ("advance_copy",))


def _flags(ctl: torch.Tensor, flags: torch.Tensor, slots: Sequence[int], by_count: bool = False) -> set:
    """The ``flags`` kernel's plain version: the slot the frame needs when
    k > 0 lanes insert, the one lane's kind (:func:`branch_slot`) or, with
    ``by_count``, k − 1; ``stop`` when ``slots`` lacks it, else ``NEXT =
    i + 1`` and one run on it → the slots taken (none or that one)."""
    rows = flag_rows(flags.tolist())
    k = sum(insert for insert, _ in rows)
    need = {(k - 1) if by_count else branch_slot(rows[0][1])} if k else set()
    stop = not need <= set(slots)
    i = int(ctl[I])
    ctl[STOP], ctl[NEXT] = int(stop), i if stop else i + 1
    taken = set() if stop else need
    for s in taken:
        ctl[RUNS + s] += 1
    return taken


def _advance(ctl: torch.Tensor, packed: torch.Tensor, out: torch.Tensor) -> bool:
    """The ``advance_copy`` kernel's plain version, but for its copy: unless
    ``stop``, the packed output into row ``NEXT`` − 1 and i = ``NEXT`` → the
    WHILE condition, which is also whether frame i is copied in."""
    nxt, stop = int(ctl[NEXT]), int(ctl[STOP])
    if not stop:
        row(out, nxt - 1).copy_(packed)
        ctl[I] = nxt
        ctl[DONE] += 1
    return not stop and nxt < int(ctl[N])


def row(out: torch.Tensor, i: int) -> torch.Tensor:
    """Frame i of a chunk's packed output: (n, 17), or (B, n, 17) lanes first."""
    return out[i] if out.dim() == 2 else out[:, i]


def _spectrum_in(fft: torch.Tensor, spectra: torch.Tensor) -> None:
    """A taken body's first step: frame i's spectrum (every lane's, in a
    batch) into the frame graph's buffer."""
    fft.copy_(spectra)


class ChunkGraph:
    """Frames of a chunk through one graph launch over ``frame_graph``'s
    buffers (its loaded state).  :meth:`run` is the entry point."""

    # Graph launches on a card, by every instance: the wrapper's count.
    launches = 0

    def __init__(self, frame_graph):
        self.frame_graph = frame_graph
        self.device = frame_graph.device
        self.lanes = frame_graph.lanes
        self.by_count = frame_graph.by_count
        if self.lanes > MAX_LANES:
            raise ValueError(f"a chunk graph holds at most {MAX_LANES} lanes, got {self.lanes}")
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=self.device)
        self.early_exits = 0  # frames that stopped a chunk for a body not captured yet
        self.host_exits = 0  # frames that stopped a chunk for the branch on the host
        self._flags_read: Optional[list] = None  # a host-branch frame's flags, from the last read
        self.runs = collections.Counter()  # branch runs by slot, as the control block counted them
        self.node_types: Dict[str, int] = {}  # of the graphs the card's build nested
        self.structure: Dict[str, int] = {}  # of the card's build (nislam_cg_describe)
        self._slots: Optional[Tuple[int, ...]] = None  # what the built program holds
        self._inline = None if frame_graph.inline is None else frame_graph.inline.inline_body
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
        frame graph; over a host-branch frame graph, one read more when
        the chunk ends with a branch (its loop search's check)."""
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
            # graph lacks (finished on the host, which captures the kind),
            # or the branch on the host.
            fg.fft.copy_(feats[1][i])
            if fg.host_branch:
                self.host_exits += 1
                fg.finish(self._flags_read)
            else:
                self.early_exits += 1
                fg.finish()
            row(out, i).copy_(fg.track.outputs.packed)
            i += 1
        if fg.diverged is not None and fg.unchecked:  # the chunk ended with a branch run here: its check
            fg.check(int(fg.diverged))

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
            self.structure = self._graph.structure
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
        the track graph's per frame it ran, each branch graph's per run,
        and, with the inline trigger, what its nodes ran (the solve graph's
        growing counts, read in the same read)."""
        fg = self.frame_graph
        words = self.ctl[:RUNS + MAX_LANES]
        if fg.inline is not None and self.device.type == "cuda":
            words = torch.cat((words, fg.inline.counts))
        if fg.host_branch:  # the flags of the frame that stopped, if one did
            words = torch.cat((words, fg.track.outputs.flags.reshape(-1).to(words.dtype)))
        if fg.diverged is not None:  # the loop search's check
            words = torch.cat((words, fg.diverged))
        ctl = words.tolist()
        if fg.diverged is not None:
            fg.check(ctl[-1])
        if fg.host_branch:
            self._flags_read = [bool(v) for v in ctl[-3:-1]]
        i, stop, done = ctl[I], bool(ctl[STOP]), ctl[DONE]
        for s in fg.branch_slots():
            self.runs[s] += ctl[RUNS + s]
        if self.device.type == "cuda":
            fg.track.step.count_replays(done + int(stop))
            for s, step in fg.branch_slots().items():
                step.count_replays(ctl[RUNS + s])
            if fg.inline is not None:
                fg.inline.account(ctl[RUNS + MAX_LANES:])
        return i, stop

    def _plain(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        """The plain program: the copy of frame i0, then :func:`outer_body`
        as a loop on the host over the same buffers and control block."""
        fg, ctl = self.frame_graph, self.ctl
        ctl[:RUNS + MAX_LANES] = 0
        ctl[I], ctl[N], ctl[NEXT] = i0, n, i0
        steps = fg.branch_slots()
        img_u, fft, polar = _copy_targets(fg)

        def copy_in(i: int) -> None:  # the copy ahead of the WHILE, and the advance's
            img_u.copy_(feats[0][i])
            polar.copy_(feats[2][i])

        copy_in(i0)
        body = outer_body(self._slots, self._inline)
        more = True
        while more:
            for op, *args in body:
                if op == "track":
                    fg.track.step.run()
                elif op == "flags":
                    taken = _flags(ctl, fg.track.outputs.flags, self._slots, self.by_count)
                elif op == "switch":
                    for s in taken:
                        _spectrum_in(fft, feats[1][int(ctl[I])])
                        steps[s].run()
                        if s == 0 and args:  # the stored body's inline trigger
                            fg.inline.run_inline()
                else:
                    more = _advance(ctl, fg.track.outputs.packed, out)
                    if more:
                        copy_in(int(ctl[I]))


def _copy_targets(fg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a frame's ``(img_u, fft, polar)`` are copied: the track
    graph's inputs (every frame) and the branch's spectrum (a frame that
    inserts)."""
    return fg.track.inputs.img_u, fg.fft, fg.track.inputs.polar


def _check_raw(x: torch.Tensor, what: str) -> int:
    if not x.is_contiguous():
        raise ValueError(f"the chunk graph needs a contiguous {what}")
    return x.data_ptr()


def _raw(x: Optional[torch.Tensor], what: str) -> Tuple[int, int]:
    """(address, bytes) of a copy target; (0, 0) for none."""
    return (0, 0) if x is None else (_check_raw(x, what), x.numel() * x.element_size())


def node_types(lib, graph: int) -> Dict[str, int]:
    """The node types of a captured graph (child graphs walked) by name."""
    counts = (ctypes.c_int * len(NODE_TYPES))()
    cuda_check(lib.nislam_graph_node_types(graph, counts, len(NODE_TYPES)), "reading a captured graph's nodes")
    return {name: counts[k] for k, name in enumerate(NODE_TYPES) if counts[k]}


def body_node_types(lib, graphs) -> Dict[str, int]:
    """The node types of captured graphs that a conditional body will nest
    (child graphs walked), summed; raises on a type that a body cannot
    hold."""
    found: Dict[str, int] = {}
    for g in graphs:
        for name, k in node_types(lib, g).items():
            found[name] = found.get(name, 0) + k
    bad = set(found) - BODY_TYPES
    if bad:
        raise RuntimeError(f"a captured graph holds nodes that a conditional body cannot: {sorted(bad)}")
    return found


def describe(lib, h) -> Dict[str, int]:
    """A built chunk graph's nodes (:data:`STRUCTURE`): one WHILE
    iteration's and its branch bodies'."""
    counts = (ctypes.c_int * len(STRUCTURE))()
    cuda_check(lib.nislam_cg_describe(h, counts, len(STRUCTURE)), "walking the chunk graph")
    return dict(zip(STRUCTURE, counts))


def build_graph(lib, ctl: torch.Tensor, lanes: int, slots: Sequence[int], copies, track: int, flags: int,
                branches: Dict[int, int], packed: int, spectrum, inline=None, by_count: bool = False
                ) -> ctypes.c_void_p:
    """The card's graph of :func:`outer_body`, through ``cond_graph.cu``'s
    entry points: ``copies`` the (address, bytes) of the track graph's
    ``img_u`` and ``polar`` inputs (the copy ahead of the WHILE and the
    advance's), ``spectrum`` the (address, bytes) of the branch's spectrum
    buffer (every lane's), ``track`` and ``branches`` (slot → graph) the
    cudaGraph_t handles to nest, ``flags`` and ``packed`` the addresses of
    the track graph's flags and packed output; ``inline`` the inline
    trigger's parts (``SolveGraph.inline_parts``: its kernels' arguments
    and its steps' graphs), which the stored body gets after its branch;
    ``by_count``: the bodies are keyed by the number of lanes that insert
    (``lanes`` of them), else by the one lane's kind (two).  Raises at the
    first step the runtime refuses."""
    h = ctypes.c_void_p()
    (img, img_bytes), (polar, polar_bytes) = copies
    cuda_check(lib.nislam_cg_create(ctypes.byref(h), ctl.data_ptr(), lanes, img, img_bytes, polar, polar_bytes),
               "creating the chunk graph")
    try:
        for op, *args in outer_body(slots, None if inline is None else inline.body):
            if op == "track":
                err = lib.nislam_cg_add_child(h, track)
            elif op == "flags":
                err = lib.nislam_cg_add_flags(h, flags, sum(1 << s for s in slots), int(by_count))
            elif op == "switch":
                n = lanes if by_count else 2
                err = lib.nislam_cg_add_switch(h, (ctypes.c_void_p * n)(*(branches.get(s) for s in range(n))),
                                               *spectrum)
                if err == 0 and args:
                    g = inline.graphs
                    op, err = "inline trigger", lib.nislam_cg_add_inline(
                        h, *inline.trigger, g["setup"], g.get("iteration"), g["inline_finish"], *inline.lm_step)
            else:
                err = lib.nislam_cg_add_advance(h, packed, WIDTH)
            cuda_check(err, f"adding the chunk graph's {op} node")
        cuda_check(lib.nislam_cg_instantiate(h), "instantiating the chunk graph")
    except BaseException:
        lib.nislam_cg_destroy(h)
        raise
    return h


def table_args(feats, out: torch.Tensor) -> list:
    """The chunk's table for ``nislam_cg_begin`` and ``nislam_cg_launch``:
    each feature's frame 0 and bytes per frame (None, 0 for none), the
    output and its floats between lanes."""
    srcs = []
    for x in feats:
        srcs += [None, 0] if x is None else [x.data_ptr(), x[0].numel() * x.element_size()]
    return [*srcs, out.data_ptr(), out.stride(0) if out.dim() == 3 else 0]


def launch_graph(lib, h, device: torch.device, feats, out: torch.Tensor, i0: int, n: int) -> None:
    """Frames [i0, n) of ``feats`` (three (n, ...) tensors; None for a
    segment the graph does not copy) into ``out``, on the current stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_check(lib.nislam_cg_launch(h, i0, n, *table_args(feats, out), stream), "launching the chunk graph")


class _CardGraph:
    """The built graph on a card: holds the nested steps (their memory
    pools and workspaces) for as long as it lives, and is destroyed with
    it."""

    def __init__(self, chunk: ChunkGraph, slots: Tuple[int, ...]):
        fg = chunk.frame_graph
        self._lib = lib = cond_graph_library()
        outs = fg.track.outputs
        steps = fg.branch_slots()
        # The inline trigger's parts, its steps primed, for a graph that
        # holds a stored kind.
        inline = fg.inline.inline_parts() if chunk._inline is not None and 0 in slots else None
        self.nested = (fg.track.step, *(steps[s] for s in slots), *(inline.steps if inline else ()))
        graphs = {"track": fg.track.step.raw_graph(), **{s: steps[s].raw_graph() for s in slots}}
        self.node_types = body_node_types(lib, [*graphs.values(), *(inline.graphs.values() if inline else ())])
        img_u, fft, polar = targets = _copy_targets(fg)
        self._copy_shapes = [tuple(d.shape) for d in targets]
        self._copy_dtypes = [d.dtype for d in targets]
        h = build_graph(lib, chunk.ctl, chunk.lanes, slots, [_raw(d, "copy target") for d in (img_u, polar)],
                        graphs["track"], _check_raw(outs.flags, "flags output"), {s: graphs[s] for s in slots},
                        _check_raw(outs.packed, "packed output"), _raw(fft, "spectrum"), inline, chunk.by_count)
        self._h = h
        self._finalizer = weakref.finalize(self, lib.nislam_cg_destroy, h)
        self._device = chunk.device
        self.structure = describe(lib, h)

    def launch(self, feats, out: torch.Tensor, i0: int, n: int) -> None:
        for x, shape, dtype in zip(feats, self._copy_shapes, self._copy_dtypes):
            if tuple(x.shape[1:]) != shape or x.dtype != dtype or not x.is_contiguous() or x.device != self._device:
                raise ValueError(f"chunk features {tuple(x.shape)} {x.dtype} do not fit the graph's {shape} {dtype}")
        if not out.is_contiguous() or out.dtype != torch.float32 or out.shape[-1] != WIDTH:
            raise ValueError(f"the chunk graph writes a contiguous float32 (..., {WIDTH}) output")
        launch_graph(self._lib, self._h, self._device, feats, out, i0, n)


class EmptyBodies:
    """A chunk graph over ``lanes`` lanes whose nested graphs (the track
    graph, the branches) are empty kernels (the track graph
    ``track_kernels`` of them in a chain, each branch one), over
    ``feats``' frames (three (n, ...) tensors, a frame's lanes contiguous;
    None for none: its copies move no byte) and a (lanes, 2) flag that
    takes every lane's stored branch (``taken``) or none.  Its WHILE
    iteration is the engines': the track node, the flags kernel, the
    SWITCH (one lane: its stored and dropped bodies; more lanes: the batch
    engine's bodies keyed by k, all held) whose taken body copies the
    spectra (``targets[1]``) and runs the empty branch, the advance that
    writes the output row and copies the next frame's ``img_u`` and
    ``polar`` (``targets[0]``, ``targets[2]``): what the outer body costs
    the card per frame by itself, and over ``track_kernels`` what one
    empty node adds to an iteration (``stagebench``, ``chip_smoke.py``)."""

    def __init__(self, device: torch.device, frames: int, feats=None, taken: bool = False, lanes: int = 1,
                 track_kernels: int = 1):
        self._lib = lib = cond_graph_library()
        self.frames = frames
        self.feats = feats if feats is not None else (None, None, None)
        self.targets = tuple(None if x is None else torch.zeros_like(x[0]) for x in self.feats)
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)
        self.flags = torch.tensor([[taken, True]] * lanes, device=device)
        self.packed = torch.zeros((lanes, WIDTH), device=device)
        self.out = torch.zeros((lanes, frames, WIDTH) if lanes > 1 else (frames, WIDTH), device=device)
        img_u, fft, polar = self.targets
        spectrum = (0, 0) if fft is None else _raw(fft, "spectrum")
        by_count = lanes > 1
        slots = tuple(range(lanes if by_count else 2))
        empty, track = ctypes.c_void_p(), ctypes.c_void_p()
        cuda_check(lib.nislam_cg_empty_graph(ctypes.byref(empty), 1), "making an empty graph")
        try:
            cuda_check(lib.nislam_cg_empty_graph(ctypes.byref(track), track_kernels), "making an empty track graph")
            self._h = build_graph(lib, self.ctl, lanes, slots, [_raw(img_u, "img_u"), _raw(polar, "polar")],
                                  track.value, self.flags.data_ptr(), {s: empty.value for s in slots},
                                  self.packed.data_ptr(), spectrum, by_count=by_count)
        finally:
            lib.nislam_graph_destroy(empty)  # the graph holds clones
            lib.nislam_graph_destroy(track)
        self._finalizer = weakref.finalize(self, lib.nislam_cg_destroy, self._h)
        self._device = device
        self.structure = describe(lib, self._h)

    def launch(self) -> None:
        """One launch over every frame, on the current stream."""
        launch_graph(self._lib, self._h, self._device, self.feats, self.out, 0, self.frames)
