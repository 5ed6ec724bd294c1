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
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from nislam_torch.core.chunk_graph import BODY_TYPES, node_types
from nislam_torch.core.pose_graph import (
    IT, LOOP, LMControl, SolverConfig, lm_begin, lm_control, lm_iterate, lm_result, lm_setup, lm_step,
)
from nislam_torch.core.track_graph import CapturedStep
from nislam_torch.kernels.launch import cond_graph_library, cuda_check, launch_trigger, lm_step_args, trigger_args

# The control block (int32 words; csrc/cond_graph.cu's kIt, kLoop, kAny,
# kRun): the LM count and condition, any lane runs, one run flag per lane.
ANY, RUN = 2, 3
MAX_LANES = 32
CTL_WORDS = RUN + MAX_LANES
STRUCTURE = ("outer_nodes", "if_body_nodes", "while_body_nodes")  # nislam_sg_describe's fields

# setup(state, run) → the stacked problem; finish(state, run, (poses,
# scale, cost)): over the lanes-first state of the frame graph's buffers.
Setup = Callable[[object, torch.Tensor], object]
Finish = Callable[[object, torch.Tensor, tuple], None]


def solve_body(loops: bool) -> tuple:
    """The trigger's program, in order: the card's nodes and the CPU's
    steps.  ``loops``: whether the configuration lets the LM loop make
    its first iteration (without it the IF body has no WHILE)."""
    inner = (("iteration",), ("lm_step",))
    return (("trigger",), ("if", (("setup",), *((("while", inner),) if loops else ()), ("finish",))))


def loops(cfg: SolverConfig) -> bool:
    """JAX's ``cond`` at the start for a lane that runs:
    ``max_iterations > 0`` and μ_init below μ_max."""
    return cfg.max_iterations > 0 and cfg.mu_init < cfg.mu_max


def trigger_reference(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor,
                      control: LMControl, cfg: SolverConfig) -> None:
    """The trigger kernel's plain version: each lane's live pending matches
    (slot i below its count, loop slot not voided) → ``run`` where ≥ 2;
    the run flags and ``any(run)`` into the control words; the LM loop's
    start (:func:`~nislam_torch.core.pose_graph.lm_begin`)."""
    p = loop_slot.shape[-1]
    live = ((torch.arange(p, device=count.device) < count[:, None]) & (loop_slot >= 0)).to(torch.int32).sum(-1)
    run.copy_(live >= 2)
    ctl[RUN:RUN + run.shape[0]] = run.to(torch.int32)
    ctl[ANY] = run.any().to(torch.int32)
    lm_begin(control, run, cfg)


def trigger(ctl: torch.Tensor, count: torch.Tensor, loop_slot: torch.Tensor, run: torch.Tensor,
            control: LMControl, cfg: SolverConfig, force: Optional[str] = None) -> None:
    """The trigger step: the kernel on a card (outside a graph: no IF
    handle), :func:`trigger_reference` for CPU tensors.  ``force`` ∈
    {"kernel", "reference"} pins the choice; ``trigger.launches`` counts
    kernel launches."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"invalid force {force!r}")
    if force == "kernel" or (force is None and ctl.is_cuda):
        launch_trigger(ctl, count, loop_slot, run, control, cfg)
        trigger.launches += 1
    else:
        trigger_reference(ctl, count, loop_slot, run, control, cfg)


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
    is a free variable.  :meth:`run` is the entry point."""

    # Graph launches on a card, by every instance: the wrapper's count.
    launches = 0

    def __init__(self, frame_graph, cfg: SolverConfig, setup: Setup, finish: Finish, scale_free: bool):
        self.frame_graph = frame_graph
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
        self.node_types: Dict[str, int] = {}  # of the graphs the card's build nested
        self.structure: Dict[str, int] = {}  # of the card's build (nislam_sg_describe)
        self._state = state
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
        self._graph: Optional[_CardSolveGraph] = None

    @property
    def built(self) -> bool:
        return self._graph is not None

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

    def _captured(self) -> bool:
        return all(step.captured for name, step in self.steps.items() if name != "iteration" or self.loops)

    def _read(self) -> List[bool]:
        """The one host read after a launch → the run flags; the nested
        graphs' counted launches and the two kernels' are added: setup and
        finish once if a lane ran, the iteration and ``lm_step`` once per
        LM iteration, the trigger once."""
        ctl = self.ctl[:RUN + self.lanes].tolist()
        ran = [bool(x) for x in ctl[RUN:]]
        trigger.launches += 1
        if ctl[ANY]:
            self.steps["setup"].count_replays(1)
            self.steps["finish"].count_replays(1)
            self.steps["iteration"].count_replays(ctl[IT])
            lm_step.launches += ctl[IT]
        return ran

    def _trigger_args(self) -> tuple:
        pending = self._state.pending
        return self.ctl, pending.count, pending.loop_slot, self.run_flags, self.control, self.cfg

    def _plain(self) -> List[bool]:
        """The plain program: :func:`solve_body` as a loop on the host over
        the same buffers and control words (the IF's condition read once,
        the WHILE's once per iteration)."""
        ran = [False] * self.lanes

        def walk(ops) -> None:
            nonlocal ran
            for op, *args in ops:
                if op == "trigger":
                    trigger(*self._trigger_args())
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

        walk(solve_body(self.loops))
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


def describe(lib, h) -> Dict[str, int]:
    """A built solve graph's nodes (:data:`STRUCTURE`)."""
    counts = (ctypes.c_int * len(STRUCTURE))()
    cuda_check(lib.nislam_sg_describe(h, counts, len(STRUCTURE)), "walking the solve graph")
    return dict(zip(STRUCTURE, counts))


def build_graph(lib, with_loop: bool, trigger: list, graphs: Dict[str, int], lm_step: list) -> ctypes.c_void_p:
    """The card's graph of :func:`solve_body` through ``cond_graph.cu``'s
    entry points: ``trigger`` and ``lm_step`` the two kernels' arguments
    (``trigger_args``, ``lm_step_args``), ``graphs`` the cudaGraph_t of
    each captured step by name.  Raises at the first step the runtime
    refuses."""
    h = ctypes.c_void_p()
    cuda_check(lib.nislam_sg_create(ctypes.byref(h), *trigger), "creating the solve graph")
    try:
        _, (_, inner) = solve_body(with_loop)
        for (op, *_) in inner:
            if op == "while":
                err = lib.nislam_sg_add_loop(h, graphs["iteration"], *lm_step)
            else:
                err = lib.nislam_sg_add_child(h, graphs[op])
            cuda_check(err, f"adding the solve graph's {op} node")
        cuda_check(lib.nislam_sg_instantiate(h), "instantiating the solve graph")
    except BaseException:
        lib.nislam_sg_destroy(h)
        raise
    return h


def launch_graph(lib, h, device: torch.device) -> None:
    """One launch of a built solve graph on the current stream."""
    cuda_check(lib.nislam_sg_launch(h, torch.cuda.current_stream(device).cuda_stream), "launching the solve graph")


class _CardSolveGraph:
    """The built graph on a card: holds the nested steps (their memory
    pool and workspaces) for as long as it lives, and is destroyed with
    it."""

    def __init__(self, sg: SolveGraph):
        self._lib = lib = cond_graph_library()
        self._device = sg.device
        graphs = {name: step.raw_graph() for name, step in sg.steps.items() if step.captured}
        self.nested = tuple(sg.steps.values())
        self.node_types: Dict[str, int] = {}
        for g in graphs.values():
            for name, k in node_types(lib, g).items():
                self.node_types[name] = self.node_types.get(name, 0) + k
        bad = set(self.node_types) - BODY_TYPES
        if bad:
            raise RuntimeError(f"a captured graph holds nodes that a conditional body cannot: {sorted(bad)}")
        self._h = h = build_graph(lib, sg.loops, trigger_args(*sg._trigger_args()), graphs,
                                  lm_step_args(sg.control, sg.cfg))
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
