"""The deferred pose-graph trigger and its dense LM solve as ONE CUDA graph launch.

The port's own module.  JAX's ``maybe_optimize`` (``nislam_tpu/core/
slam.py:755-787``) is one compiled ``lax.cond`` whose branch adds the
pending loop edges (a masked ``fori_loop`` over the whole pending
buffer), solves (``nislam_tpu/core/pose_graph.py``: a ``lax.while_loop``
whose μ, count and stop live on the device), clears the pending buffer
and re-derives the tracking chain; the batch engine vmaps it, so every
lane pays the batched solve under a select.  :class:`SolveGraph` is its
counterpart over a :class:`~nislam_torch.core.frame_graph.FrameGraph`'s
buffers (the single engine's, one lane) or a
:class:`~nislam_torch.core.frame_graph.BatchFrameGraph`'s (B lanes, all
solved under the lane mask):

1. ``trigger``: each lane's live pending count against 2 → its run flag;
   the LM control set up (μ_init, count 0, ``active = run``); the IF
   condition ``any(run)``;
2. under the IF:

   - ``setup``: the masked pending-edge loop, the problem, its scatter
     plans, x0 and cost0 (``core/slam.py``'s ``_solve_setup``, then
     :func:`~nislam_torch.core.pose_graph.lm_setup`);
   - a WHILE over ``iteration`` (:func:`~nislam_torch.core.pose_graph.
     lm_iterate`) and ``lm_step`` (μ, the lane mask, the count and the
     WHILE condition);
   - ``finish``: the poses, the pending count and the chain of the lanes
     that ran, and each lane's final cost (``_solve_finish``).

:func:`solve_body` is that description, once.  On a card ``trigger`` and
``lm_step`` are kernels of ``csrc/cond_graph.cu`` and the other steps
graphs that PyTorch captured, nested by that library under an IF and a
WHILE node: a trigger is one graph launch and one host read after it
(the run flags and the iteration count).  On the CPU the same steps run
as a Python loop over the same buffers (:func:`trigger_reference` and
``lm_step_reference`` are the kernels' plain versions), which is the
plain program.  The steps are captured at the first trigger that runs,
which goes through the plain program on the card (its steps each run
once on the capture stream and are captured; one read per iteration);
the graph is built right after it.  A failed capture, build or
launch raises: nothing falls back to the host loop.

The inline trigger (``optimizer.inline``, the single engine) is the same
program with its own gate and finish: JAX's scan step runs
``_flush_pending_loops`` under ``lax.cond(stored & ~loop_found)``
(``nislam_tpu/core/slam.py:736-752``, ``:1096``).  The trigger kernel
reads the frame's ``loop_found`` from the track graph's packed output
(which the stored branch wrote), runs a lane where it is 0 and ≥ 2
matches are live, and clears the pending count of a gated lane that does
not run; the IF body is the setup, the LM loop and the inline finish
(``core/slam.py``'s ``_inline_finish``).  It shares the control words,
the setup and iteration steps and the LM carry with the deferred
trigger; the two never run at once.  Its steps are captured before its
first use (:meth:`SolveGraph.prime`, with no lane running: every state
leaf keeps its bits), so a chunk graph nests them in each stored body
from its first build (``core/chunk_graph.py``) and never stops for
them; the flag-read frame graph launches the same program as a graph of
its own after each stored branch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from nislam_torch.core.chunk_graph import BODY_TYPES, body_node_types  # noqa: F401 (BODY_TYPES: what a body holds)
from nislam_torch.core.pose_graph import (
    LOOP, LMControl, SolverConfig, lm_begin, lm_control, lm_iterate, lm_result, lm_setup, lm_step,
)
from nislam_torch.core.track_graph import CapturedStep
from nislam_torch.kernels.launch import cond_graph_library, cuda_check, launch_trigger, lm_step_args, trigger_args

# The control block (int32 words; csrc/cond_graph.cu's kIt, kLoop, kAny,
# kRun, kTriggers ...): the LM count and condition, any lane runs, one run
# flag per lane, then counts that only grow, which the kernels write inside
# a graph: the triggers, the IF bodies taken by a deferred and by an inline
# trigger, the LM iterations (read with the chunk graph's control block).
ANY, RUN = 2, 3
MAX_LANES = 32
TRIGGERS = RUN + MAX_LANES
COUNTS = 4
CTL_WORDS = TRIGGERS + COUNTS
STRUCTURE = ("outer_nodes", "if_body_nodes", "while_body_nodes")  # nislam_sg_describe's fields

# setup(state, run) → the stacked problem; finish(state, run, (poses,
# scale, cost)): over the lanes-first state of the frame graph's buffers;
# the inline finish also takes the frame's packed output.
Setup = Callable[[object, torch.Tensor], object]
Finish = Callable[[object, torch.Tensor, tuple], None]
InlineFinish = Callable[[object, torch.Tensor, tuple, torch.Tensor], None]

def solve_body(loops: bool, inline: bool = False) -> tuple:
    """The trigger's program, in order: the card's nodes and the CPU's
    steps.  ``loops``: whether the configuration lets the LM loop make
    its first iteration (without it the IF body has no WHILE).
    ``inline``: the inline trigger's, whose trigger is gated by the
    frame's ``loop_found`` and whose IF body ends in the inline finish.
    On the card the WHILE node follows a ``loop_begin`` kernel, which
    sets its handle (the plain WHILE reads the loop condition itself)."""
    inner = (("iteration",), ("lm_step",))
    finish = "inline_finish" if inline else "finish"
    return (("trigger",), ("if", (("setup",), *((("while", inner),) if loops else ()), (finish,))))


def solve_steps(loops: bool, inline: bool = False) -> Tuple[str, ...]:
    """The captured steps that :func:`solve_body` nests, in order."""
    return ("setup", *(("iteration",) if loops else ()), "inline_finish" if inline else "finish")


def loops(cfg: SolverConfig) -> bool:
    """JAX's ``cond`` at the start for a lane that runs:
    ``max_iterations > 0`` and μ_init below μ_max."""
    return cfg.max_iterations > 0 and cfg.mu_init < cfg.mu_max


def trigger_reference(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor,
                      control: LMControl, cfg: SolverConfig, gate: Optional[torch.Tensor] = None) -> None:
    """The trigger kernel's plain version: each lane's live pending matches
    (slot i below its count, loop slot not voided) → ``run`` where ≥ 2;
    the run flags and ``any(run)`` into the control words; the LM loop's
    start (:func:`~nislam_torch.core.pose_graph.lm_begin`).  ``gate``
    (each lane's ``loop_found`` field, float32 (R,); None: none) makes it
    the inline trigger, JAX's ``stored & ~loop_found``: a lane runs only
    where it found no loop, and a gated lane that does not run has its
    pending count cleared, since the reference discards a single
    unconfirmed match (``nislam_tpu/core/slam.py:736-752``)."""
    p = loop_slot.shape[-1]
    live = ((torch.arange(p, device=count.device) < count[:, None]) & (loop_slot >= 0)).to(torch.int32).sum(-1)
    ok = live >= 2
    if gate is not None:
        open_ = ~(gate.reshape(-1) > 0.5)
        ok = ok & open_
        count.copy_(torch.where(open_ & ~ok, 0, count))
    run.copy_(ok)
    ctl[RUN:RUN + run.shape[0]] = run.to(torch.int32)
    ctl[ANY] = run.any().to(torch.int32)
    lm_begin(control, run, cfg)


def trigger(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor,
            control: LMControl, cfg: SolverConfig, gate: Optional[torch.Tensor] = None,
            force: Optional[str] = None) -> None:
    """The trigger step (``gate``: see :func:`trigger_reference`): the
    kernel on a card (outside a graph: no IF handle),
    :func:`trigger_reference` for CPU tensors.  ``force`` ∈ {"kernel",
    "reference"} pins the choice; ``trigger.launches`` counts kernel
    launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and ctl.is_cuda):
        launch_trigger(ctl, count, loop_slot, run, control, cfg, gate)
        trigger.launches += 1
    else:
        trigger_reference(ctl, count, loop_slot, run, control, cfg, gate)


trigger.launches = 0


def lanes_first(state):
    """A state whose leaves carry a leading lane axis: a batch's as it is,
    a single engine's as views with a lane axis of one."""
    if state.bank.count.dim() == 1:
        return state
    return type(state)(**{f.name: dataclasses.replace(part, **{
        g.name: getattr(part, g.name)[None] for g in dataclasses.fields(part)
        if isinstance(getattr(part, g.name), torch.Tensor)})
        for f in dataclasses.fields(state) for part in (getattr(state, f.name),)})


class SolveGraph:
    """The deferred trigger of every lane of ``frame_graph``'s loaded state
    as one launch (on the CPU its plain program).  ``setup`` and
    ``finish`` are ``core/slam.py``'s bodies over the lanes-first state;
    ``cfg`` the solver's configuration, ``scale_free`` whether the scale
    is a free variable.  :meth:`run` is the entry point.

    With ``inline_finish`` it is also the inline trigger of the frame whose
    stored keyframe the branch just inserted (:meth:`run_inline`): the
    same control words, setup and LM iteration steps and LM carry, its own
    gate (the frame's ``loop_found``, in the track graph's packed output)
    and finish (``inline_finish(state, run, result, packed)``).  The two
    never run at once.  Its steps are captured before its first use on a
    card (:meth:`prime`), with no lane running, which leaves every state
    leaf's bits; a chunk graph nests them in its stored bodies
    (:meth:`inline_parts`)."""

    # Graph launches on a card, by every instance: the wrapper's count
    # (the deferred trigger's, and the inline trigger's own graph's).
    launches = 0
    inline_launches = 0

    def __init__(self, frame_graph, cfg: SolverConfig, setup: Setup, finish: Finish, scale_free: bool,
                 inline_finish: Optional[InlineFinish] = None):
        self.device = dev = frame_graph.device
        self.cfg = cfg
        state = lanes_first(frame_graph.state)
        self.lanes = lanes = state.bank.count.shape[0]
        if lanes > MAX_LANES:
            raise ValueError(f"a solve graph holds at most {MAX_LANES} lanes, got {lanes}")
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=dev)
        self.run_flags = torch.zeros(lanes, dtype=torch.bool, device=dev)
        self.control = lm_control(lanes, dev, self.ctl)
        self.final_cost = torch.zeros(lanes, dtype=torch.float32, device=dev)
        self.loops = loops(cfg)
        self.counts = self.ctl[TRIGGERS:]  # the growing counts
        self.node_types: Dict[str, int] = {}  # of the graphs the card's build nested
        self.structure: Dict[str, int] = {}  # of the card's build (nislam_sg_describe)
        self._state = state
        # The frame's packed output, which the inline trigger's gate reads
        # and its finish writes: the track graph's (no reference to the
        # frame graph, which holds this object as its inline trigger).
        self._track = frame_graph.track if inline_finish is not None else None
        self._seen = [0] * COUNTS  # the growing counts already added to the wrappers'
        # The carry, made at the first setup (the steps hold no reference
        # to self: see TrackGraph).
        self._holder = holder = SimpleNamespace(carry=None)
        stream = frame_graph._stream
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None  # the steps run one at a time
        self.steps = {
            "setup": CapturedStep(dev, functools.partial(_setup, setup, state, self.run_flags, holder, cfg,
                                                         scale_free), stream, pool),
            "iteration": CapturedStep(dev, functools.partial(_iteration, holder, self.control), stream, pool),
            "finish": CapturedStep(dev, functools.partial(_finish, finish, state, self.run_flags, holder,
                                                          self.final_cost), stream, pool),
        }
        if inline_finish is not None:
            self.steps["inline_finish"] = CapturedStep(dev, functools.partial(
                _inline_finish, inline_finish, state, self.run_flags, holder, self.final_cost, self._track),
                stream, pool)
        self._graph: Optional[_CardSolveGraph] = None
        self._inline_graph: Optional[_CardSolveGraph] = None
        # What the inline trigger runs (a chunk graph's stored body nests it).
        self.inline_body = solve_body(self.loops, inline=True) if inline_finish is not None else None

    @property
    def built(self) -> bool:
        return self._graph is not None

    @property
    def inline(self) -> bool:
        """Whether it holds the inline trigger."""
        return "inline_finish" in self.steps

    @property
    def carry(self):
        """The LM carry of the last setup (its problem, scatter plans, x and
        cost), None before the first trigger that solves."""
        return self._holder.carry

    def run(self) -> List[bool]:
        """One trigger of the loaded state → each lane's run flag.  On a
        card one graph launch and one host read once the steps are
        captured; before that, and on the CPU, the plain program (on a
        card the graph is built right after the trigger that captured
        the last of its steps)."""
        if self._graph is None:
            ran = self._plain()
            if self.device.type == "cuda" and self._captured():
                self._graph = _CardSolveGraph(self)
                self.node_types, self.structure = self._graph.node_types, self._graph.structure
                CapturedStep.captures += 1
            return ran
        self._graph.launch()
        SolveGraph.launches += 1
        return self._read()

    def run_inline(self) -> None:
        """The inline trigger of the frame whose stored keyframe the branch
        just inserted, with no host read: on a card one launch of its own
        graph (its steps primed first; :meth:`collect` adds what it ran to
        the counts), on the CPU its plain program."""
        if self.device.type != "cuda":
            self._plain(inline=True)
            return
        if self._inline_graph is None:
            self.prime()
            self._inline_graph = _CardSolveGraph(self, inline=True)
            CapturedStep.captures += 1
        self._inline_graph.launch()
        SolveGraph.inline_launches += 1

    def prime(self) -> None:
        """The inline trigger's steps, each captured on a card at its first
        run (here, with no lane running: the setup adds no edge, the LM
        iteration takes no step and the finish writes each leaf's own
        value back, so every state leaf keeps its bits); on the CPU the
        same steps run once eagerly."""
        names = solve_steps(self.loops, inline=True)
        if all(self.steps[n].captured for n in names):
            return
        self.run_flags.zero_()
        lm_begin(self.control, self.run_flags, self.cfg)
        for name in names:
            if not self.steps[name].captured:
                self.steps[name].run()

    def inline_parts(self) -> SimpleNamespace:
        """What a chunk graph nests in a lane's stored body (steps primed on
        a card first): the program, the trigger's arguments with its gate,
        the captured setup, iteration (absent without a WHILE) and inline
        finish graphs, ``lm_step``'s arguments, the steps."""
        self.prime()
        names = solve_steps(self.loops, inline=True)
        return SimpleNamespace(body=self.inline_body, trigger=trigger_args(*self._trigger_args(), self._gate()),
                               graphs={n: self.steps[n].raw_graph() for n in names},
                               lm_step=lm_step_args(self.control, self.cfg),
                               steps=tuple(self.steps[n] for n in names))

    def collect(self) -> None:
        """On a card, one host read of the growing counts, whose growth
        since the last read is added to the wrappers' counts (what the
        inline graphs ran: :meth:`account`)."""
        if self.device.type == "cuda":
            self.account(self.counts.tolist())

    def account(self, counts: List[int]) -> None:
        """Add the growth of the growing counts (``counts``: triggers, IF
        bodies taken by a deferred and by an inline trigger, LM iterations,
        as read from the control words) since the last call: the trigger's
        and ``lm_step``'s launches, and the nested steps' counted launches
        per replay."""
        d = [a - b for a, b in zip(counts, self._seen)]
        self._seen = list(counts)
        trigger.launches += d[0]
        self.steps["setup"].count_replays(d[1] + d[2])
        self.steps["finish"].count_replays(d[1])
        if self.inline:
            self.steps["inline_finish"].count_replays(d[2])
        self.steps["iteration"].count_replays(d[3])
        lm_step.launches += d[3]

    def _captured(self) -> bool:
        return all(self.steps[name].captured for name in solve_steps(self.loops))

    def _read(self) -> List[bool]:
        """The one host read after a launch → the run flags; the growing
        counts added (:meth:`account`): the trigger once, setup and finish
        once if a lane ran, the iteration and ``lm_step`` once per LM
        iteration."""
        ctl = self.ctl.tolist()
        self.account(ctl[TRIGGERS:])
        return [bool(x) for x in ctl[RUN:RUN + self.lanes]]

    def _trigger_args(self) -> tuple:
        pending = self._state.pending
        return self.ctl, pending.count, pending.loop_slot, self.run_flags, self.control, self.cfg

    def _gate(self) -> torch.Tensor:
        """Each lane's ``loop_found`` field of the frame's packed output."""
        return self._track.outputs.packed[..., 2]

    def _plain(self, inline: bool = False) -> List[bool]:
        """The plain program: :func:`solve_body` as a loop on the host over
        the same buffers and control words (the IF's condition read once,
        the WHILE's once per iteration)."""
        ran = [False] * self.lanes

        def walk(ops) -> None:
            nonlocal ran
            for op, *args in ops:
                if op == "trigger":
                    trigger(*self._trigger_args(), self._gate() if inline else None)
                elif op == "if":
                    ctl = self.ctl[:RUN + self.lanes].tolist()
                    ran = [bool(x) for x in ctl[RUN:]]
                    if ctl[ANY]:
                        walk(args[0])
                elif op == "while":
                    while int(self.ctl[LOOP]):
                        walk(args[0])
                elif op == "lm_step":
                    lm_step(self.control, self.cfg)
                else:
                    self.steps[op].run()

        walk(solve_body(self.loops, inline))
        return ran


def _setup(setup: Setup, state, run: torch.Tensor, holder: SimpleNamespace, cfg: SolverConfig,
           scale_free: bool) -> None:
    """The ``setup`` step: the body's problem made into the LM carry (the
    carry's buffers made at the first run, written in place after)."""
    holder.carry = lm_setup(setup(state, run), cfg, init_scale=1.0, scale_free=scale_free, into=holder.carry)


def _iteration(holder: SimpleNamespace, control: LMControl) -> None:
    lm_iterate(holder.carry, control)


def _finish(finish: Finish, state, run: torch.Tensor, holder: SimpleNamespace, final_cost: torch.Tensor) -> None:
    result = lm_result(holder.carry)
    finish(state, run, result)
    final_cost.copy_(result[2])


def _inline_finish(finish: InlineFinish, state, run: torch.Tensor, holder: SimpleNamespace,
                   final_cost: torch.Tensor, track) -> None:
    result = lm_result(holder.carry)
    finish(state, run, result, track.outputs.packed)
    final_cost.copy_(result[2])


def describe(lib, h) -> Dict[str, int]:
    """A built solve graph's nodes (:data:`STRUCTURE`)."""
    counts = (ctypes.c_int * len(STRUCTURE))()
    cuda_check(lib.nislam_sg_describe(h, counts, len(STRUCTURE)), "walking the solve graph")
    return dict(zip(STRUCTURE, counts))


def build_graph(lib, with_loop: bool, trigger: list, graphs: Dict[str, int], lm_step: list,
                inline: bool = False) -> ctypes.c_void_p:
    """The card's graph of :func:`solve_body` (``inline``: the inline
    trigger's, ``trigger`` holding its gate) through ``cond_graph.cu``'s
    entry points: ``trigger`` and ``lm_step`` the two kernels' arguments
    (``trigger_args``, ``lm_step_args``), ``graphs`` the cudaGraph_t of
    each captured step by name.  Raises at the first step the runtime
    refuses."""
    h = ctypes.c_void_p()
    finish = "inline_finish" if inline else "finish"
    cuda_check(lib.nislam_sg_create(ctypes.byref(h), *trigger, graphs["setup"],
                                    graphs["iteration"] if with_loop else None, graphs[finish], *lm_step),
               "building the solve graph")
    try:
        cuda_check(lib.nislam_sg_instantiate(h), "instantiating the solve graph")
    except BaseException:
        lib.nislam_sg_destroy(h)
        raise
    return h


def launch_graph(lib, h, device: torch.device) -> None:
    """One launch of a built solve graph on the current stream."""
    cuda_check(lib.nislam_sg_launch(h, torch.cuda.current_stream(device).cuda_stream), "launching the solve graph")


class _CardSolveGraph:
    """The built graph on a card (``inline``: the inline trigger's): holds
    the nested steps (their memory pool and workspaces) for as long as it
    lives, and is destroyed with it."""

    def __init__(self, sg: SolveGraph, inline: bool = False):
        self._lib = lib = cond_graph_library()
        self._device = sg.device
        names = solve_steps(sg.loops, inline)
        graphs = {name: sg.steps[name].raw_graph() for name in names}
        self.nested = tuple(sg.steps[name] for name in names)
        self.node_types = body_node_types(lib, graphs.values())
        gate = sg._gate() if inline else None
        self._h = h = build_graph(lib, sg.loops, trigger_args(*sg._trigger_args(), gate), graphs,
                                  lm_step_args(sg.control, sg.cfg), inline)
        self._finalizer = weakref.finalize(self, lib.nislam_sg_destroy, h)
        self.structure = describe(lib, h)

    def launch(self) -> None:
        launch_graph(self._lib, self._h, self._device)


class EmptySolveBodies:
    """A solve graph over ``lanes`` lanes whose three captured steps are each
    one empty kernel (``nislam_cg_empty_graph``) and whose WHILE runs
    ``iterations`` times (μ_factor 1: μ never reaches its cap), every lane
    running: what the trigger, the IF and each WHILE iteration (an empty
    child graph and ``lm_step``) cost the card by themselves
    (``chip_smoke.py``)."""

    def __init__(self, device: torch.device, iterations: int, lanes: int = 1):
        self._lib = lib = cond_graph_library()
        self._device = device
        cfg = SolverConfig(max_iterations=iterations, mu_factor=1.0)
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)
        self.run_flags = torch.zeros(lanes, dtype=torch.bool, device=device)
        self.control = lm_control(lanes, device, self.ctl)
        self.count = torch.full((lanes,), 2, dtype=torch.int32, device=device)
        self.slots = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
        empty = ctypes.c_void_p()
        cuda_check(lib.nislam_cg_empty_graph(ctypes.byref(empty), 1), "making an empty graph")
        try:
            self._h = h = build_graph(
                lib, True, trigger_args(self.ctl, self.count, self.slots, self.run_flags, self.control, cfg),
                dict.fromkeys(("setup", "iteration", "finish"), empty.value), lm_step_args(self.control, cfg))
        finally:
            lib.nislam_graph_destroy(empty)  # the graph holds clones
        self._finalizer = weakref.finalize(self, lib.nislam_sg_destroy, h)
        self.structure = describe(lib, h)

    def launch(self) -> None:
        """One launch on the current stream."""
        launch_graph(self._lib, self._h, self._device)
