"""A whole tracked frame, its keyframe branch included, as captured CUDA graphs.

The port's own module.  JAX's ``SlamEngine.run_chunk``
(``nislam_tpu/core/slam.py:235-258``) is one jitted ``lax.scan`` whose
step runs the keyframe branch on the device as ``lax.cond``s (the
filters, the masked insert, edge and pending invalidation, the online
canvas, the loop search), so a chunk makes no host round trip.  PyTorch
2.11, which the port is deployed with, cannot capture into a CUDA graph's
conditional node (``CUDAGraph.begin_capture_to_if_node`` came later), so
the pieces are captured here as graphs of their own:

1. the track graph (:class:`~nislam_torch.core.track_graph.TrackGraph`
   over this object's buffers): tracking, the keyframe decision, the
   frame's output when it inserts nothing, the distance and frame id;
2. for a keyframe, the branch graph of its kind (one for a keyframe that
   the bank stores, one for a keyframe that a full bank drops), captured
   at its first use: ``core/slam.py``'s ``_branch_body``, which is the
   eager branch itself on this object's buffers, its output rewritten;
3. with the inline solve, after a stored branch, the inline trigger
   (``FrameGraph.inline``, a ``core/solve_graph.py`` ``SolveGraph``): on
   a card one launch of its graph, with no read.

:class:`~nislam_torch.core.chunk_graph.ChunkGraph` nests them in one
graph of the runtime's own conditional nodes (a WHILE over a chunk's
frames, a SWITCH over the branch graphs), which the engines run.  :meth:`FrameGraph.
run` is a frame on its own: the track graph's replay, the read of the
packed ``[insert, stored]`` flags (:meth:`FrameGraph.decide`), the branch
graph's replay; the chunk graph's first use and its early exit take it,
and it is the reference that the chunk graph is held against.

Every leaf of the SLAM state lives at a fixed address that this object
owns (``state``, a private :class:`~nislam_torch.core.slam.SlamState`),
since the branch writes the bank, the edges, the pending buffer, the
canvas and the chain in place.  The caller's state stays the truth:

- :meth:`FrameGraph.load` copies in every leaf that is not this object's
  own tensor (after a solve replaced the poses and the chain, for a state
  from ``init_state``, ``state_from_numpy`` or a checkpoint, or another
  state);
- :meth:`FrameGraph.lend` returns the state with this object's tensors as
  its leaves, and nothing is copied out.  Passing that state back
  consumes it, as JAX's ``donate_argnums=0`` does: the same object comes
  back, updated.  Loading any other state first moves the lent one's
  leaves to copies of their own (one copy of the state), so a state
  returned earlier never changes under a later call.  A leaf tensor taken
  out of a lent state is this object's buffer until then.

On the CPU the two bodies run eagerly on the same buffers, the flag read
included: that is the plain version.

:class:`CollectiveFrameGraph` is the distributed engine's on a group
whose all-reduce a graph holds (a card: the peer kernel): its branch, the
collectives included, is one captured step per kind, nested in the chunk
graph as the single engine's, with a frame-id check word read at every
flag read.  :class:`HostBranchFrameGraph` (gloo on CPU tensors) holds the
track graph alone: at every frame that inserts, its keyframe branch runs
between launches as a :class:`StagedBranch`, captured steps on the
buffers with the host making the collectives between them.

:class:`BatchFrameGraph` is the same over a batch of lanes (the batch
engine's, JAX's vmapped step in one ``lax.scan``): one track graph over
every lane, one (B, 2) flag read, and, when k lanes insert, the replay of
body k: ONE branch over those k lanes, gathered on the device
(``core/slam.py``'s ``_branch_body_lanes``), as JAX runs one vmapped
insert and one vmapped loop search.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import weakref
from types import SimpleNamespace
from typing import Callable, Iterator, Optional, Tuple

import torch

from nislam_torch.core.track_graph import CHAIN, Body, CapturedStep, TrackGraph

# ``branch(state, inputs, kind)``: the keyframe branch over the graph's
# buffers (for a HostBranchFrameGraph: its parts, see StagedBranch);
# ``kind`` a host value: for one lane whether the bank stores the
# keyframe, for a batch the number of lanes that insert.
Branch = Callable[[object, SimpleNamespace, object], None]


def flag_rows(flags: list) -> list:
    """:meth:`FrameGraph.decide`'s read as one ``[insert, stored]`` per
    lane (the single engine's: one lane)."""
    return flags if isinstance(flags[0], list) else [flags]


def branch_slot(stored: bool) -> int:
    """The single engine's branch kind as a chunk-graph slot (its SWITCH
    body): 0 for a keyframe that the bank stores, 1 for one it drops."""
    return 0 if stored else 1


def _describe(leaf) -> str:
    return f"{tuple(leaf.shape)} {leaf.dtype}" if isinstance(leaf, torch.Tensor) else repr(leaf)


def _tensor_fields(part) -> Iterator[Tuple[str, torch.Tensor]]:
    for f in dataclasses.fields(part):
        value = getattr(part, f.name)
        if isinstance(value, torch.Tensor):
            yield f.name, value


class FrameGraph:
    """One tracked frame over fixed buffers: the track graph, one flag
    read, the keyframe branch's graph when the frame inserts (or, nested in
    a :class:`~nislam_torch.core.chunk_graph.ChunkGraph`, no read).  ``state``
    is the private state whose tensors the graphs read and write (made by
    the caller, e.g. ``init_state``); ``track_body`` is
    :class:`TrackGraph`'s body, ``branch`` the keyframe branch."""

    def __init__(self, config, state, track_body: Body, branch: Branch):
        self.state = state
        dev = state.bank.count.device
        self.device = dev
        chain = SimpleNamespace(bank_count=state.bank.count, **{n: getattr(state.track, n) for n in CHAIN})
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.track = TrackGraph(config, dev, track_body, chain=chain, stream=stream)
        # (..., H, W//2+1): the chain's lane axes and the spectrum's shape
        self.fft = torch.zeros(state.track.last_fft.shape[:-1], dtype=torch.complex64, device=dev)
        self._branch = branch
        self._stream = stream
        self._branches = {}  # kind (stored, a host bool; a batch's k) → CapturedStep
        self._lent = None  # weakref of the state that lend() returned last
        self.lanes = 1
        # The inline trigger after a stored branch (a SolveGraph with one:
        # the single engine's with the inline solve), or None.
        self.inline = None

    @property
    def captured(self) -> bool:
        return self.track.captured

    @staticmethod
    def decide(flags: torch.Tensor) -> list:
        """The host read of a tracked frame: ``[insert, stored]`` (for each
        lane of a batch)."""
        return flags.tolist()

    def run(self, img_u: torch.Tensor, fft: torch.Tensor, polar: torch.Tensor) -> torch.Tensor:
        """One tracked frame of the loaded state from its features (every
        lane's, lanes first) → the packed (17,) output ((B, 17) for a
        batch), a buffer that the next run overwrites."""
        self.fft.copy_(fft)
        outs = self.track.run(img_u, polar)
        self.finish()
        return outs.packed

    # Whether the branches are bodies keyed by the number of lanes that
    # insert (the batch's) rather than kinds of one lane's keyframe.
    by_count = False
    # Whether the keyframe branch runs on the host (HostBranchFrameGraph).
    host_branch = False
    # A (1,) int32 word that the branch's loop search sets when the ranks
    # diverged (CollectiveFrameGraph's), or None: no such check.
    diverged = None

    def finish(self) -> None:
        """The rest of the frame whose track graph ran last: the flag read,
        then, when the frame inserts, the branch of its kind (captured at
        its first use), and after a stored branch the inline trigger, if
        any (on a card one graph launch, with no read)."""
        insert, stored = self.decide(self.track.outputs.flags)
        if insert:
            self.branch_step(stored).run()
            if stored and self.inline is not None:
                self.inline.run_inline()

    def branch_slots(self) -> dict:
        """The branch steps made so far by chunk-graph slot
        (:func:`branch_slot`)."""
        return {branch_slot(stored): step for stored, step in self._branches.items()}

    def branch_step(self, stored: bool) -> CapturedStep:
        """The keyframe branch's step for a keyframe that the bank stores
        (``stored``) or drops, made at its first use (after a track run)."""
        step = self._branches.get(stored)
        if step is None:
            x = SimpleNamespace(img_u=self.track.inputs.img_u, polar=self.track.inputs.polar, fft=self.fft,
                                tracked=self.track.outputs.tracked, packed=self.track.outputs.packed)
            # No reference to self (see TrackGraph).
            step = CapturedStep(self.device, functools.partial(self._branch, self.state, x, stored), self._stream)
            self._branches[stored] = step
        return step

    def _lent_state(self):
        return self._lent() if self._lent is not None else None

    def load(self, state) -> None:
        """Make the buffers hold ``state``: copy in each leaf that is not
        already the buffer itself, after checking that every leaf fits.  A
        lent state that is still alive and is not ``state`` gets copies of
        its leaves first."""
        copies = []
        for f in dataclasses.fields(self.state):
            own, part = getattr(self.state, f.name), getattr(state, f.name)
            for name in _set_attributes(own):  # a sharded bank's shard_base
                if getattr(part, name) != getattr(own, name):
                    raise ValueError(f"state.{f.name}.{name} does not fit the engine's: "
                                     f"{getattr(part, name)!r} against {getattr(own, name)!r}")
            for g in dataclasses.fields(own):
                mine, theirs = getattr(own, g.name), getattr(part, g.name)
                if not isinstance(mine, torch.Tensor):
                    fits = theirs == mine
                elif theirs is mine:
                    continue
                else:
                    fits = theirs.shape == mine.shape and theirs.dtype == mine.dtype
                    copies.append((mine, theirs))
                if not fits:
                    raise ValueError(f"state.{f.name}.{g.name} does not fit the engine's: "
                                     f"{_describe(theirs)} against {_describe(mine)}")
        lent = self._lent_state()
        if lent is not None and lent is not state:
            self._detach(lent)
        for buf, value in copies:
            buf.copy_(value)

    def lend(self, state):
        """The loaded state with this object's tensors as its leaves: new
        part objects set into ``state`` when it is the state lent last
        (consumed), else a new state object."""
        parts = _parts(self.state)
        if state is self._lent_state():
            for name, part in parts.items():
                setattr(state, name, part)
            out = state
        else:
            out = type(self.state)(**parts)
        self._lent = weakref.ref(out)
        return out

    def _detach(self, lent) -> None:
        """Give ``lent`` copies of the leaves it shares with the buffers."""
        for f in dataclasses.fields(self.state):
            own, part = getattr(self.state, f.name), getattr(lent, f.name)
            for name, buf in _tensor_fields(own):
                if getattr(part, name) is buf:
                    setattr(part, name, buf.clone())
        self._lent = None


def _set_attributes(part) -> set:
    """The attributes set on ``part`` beyond its fields (a sharded bank's
    ``shard_base``)."""
    return set(vars(part)) - {f.name for f in dataclasses.fields(part)}


def _parts(state) -> dict:
    """New part objects over ``state``'s leaves (its set attributes kept)."""
    return {f.name: copy.copy(getattr(state, f.name)) for f in dataclasses.fields(state)}


def write_back(state, view) -> None:
    """Copy into ``state``'s buffers every leaf that a branch run on
    ``view`` (a state over the same leaves) replaced; the leaves it wrote
    in place are the buffers already."""
    for f in dataclasses.fields(state):
        own, part = getattr(state, f.name), getattr(view, f.name)
        for g in dataclasses.fields(own):
            old, new = getattr(own, g.name), getattr(part, g.name)
            if not isinstance(old, torch.Tensor):
                if new != old:
                    raise ValueError(f"the branch changed state.{f.name}.{g.name}: {new!r} from {old!r}")
            elif new is not old:
                old.copy_(new)


class StagedBranch:
    """One keyframe branch kind as captured steps with host work between
    them: ``parts`` (``core/slam.py``'s ``staged_branch_parts``), a list of
    ``("device", fn)``, a function over fixed buffers that reads nothing
    back, and ``("host", fn)``, a collective and the read that decides it.
    The device parts between two host parts make one
    :class:`CapturedStep` (on ``stream``, in the memory pool ``pool``
    that the steps share: they run one at a time), captured at its first
    run on a card and replayed on the current stream, so that each
    collective is ordered between the replays around it.  A capture or
    replay that fails raises; nothing runs the parts eagerly on a card."""

    def __init__(self, device: torch.device, parts, stream=None, pool=None):
        self.steps = []
        self._plan = []  # the steps' run and the host parts, in order
        run = []
        for kind, fn in [*parts, ("host", None)]:
            if kind == "device":
                run.append(fn)
                continue
            if run:
                step = CapturedStep(device, functools.partial(_in_turn, tuple(run)), stream, pool)
                self.steps.append(step)
                self._plan.append(step.run)
                run = []
            if fn is not None:
                self._plan.append(fn)
        self.runs = 0

    def run(self) -> None:
        for action in self._plan:
            action()
        self.runs += 1


def _in_turn(fns) -> None:
    for fn in fns:
        fn()


class CollectiveFrameGraph(FrameGraph):
    """A :class:`FrameGraph` whose keyframe branch makes collectives that a
    graph holds (the distributed engine's on a capturable group: its loop
    search's and canvas's all-reduces are the peer kernel,
    ``ops/all_reduce.py``): each kind's branch is ``branch(state, x,
    stored)``'s parts (``core/slam.py``'s ``staged_branch_parts``, every
    one a device part, the all-reduces among them) in turn as ONE captured
    step, which the chunk graph nests in its SWITCH as it nests the single
    engine's branch.  ``x`` holds the frame's features (``img_u``, ``fft``,
    ``polar``), the track graph's packed :class:`_Tracked` (``tracked``)
    and packed output (``packed``), which the branch rewrites, and
    :attr:`diverged`.

    :attr:`diverged` is a (1,) int32 word on the device that the loop
    search's merge sets (to its frame id + 1) when the ranks' record holds
    another frame's search: every read of the flags (this object's and the
    chunk graph's one read per launch) takes it too, and :meth:`check`
    raises.  ``check_peers`` (the group's ``check``: the all-reduce
    kernel's error word, a read of mapped memory) runs at each of those
    reads."""

    def __init__(self, config, state, track_body: Body, branch: Branch,
                 check_peers: Optional[Callable[[], None]] = None):
        super().__init__(config, state, track_body, branch)
        self.diverged = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.unchecked = False  # a branch ran since the last read of diverged
        self._check_peers = check_peers

    def finish(self, flags: Optional[list] = None) -> None:
        """The rest of the frame whose track graph ran last: the read of its
        flags with :attr:`diverged` (``flags``: its ``[insert, stored]``,
        read already with the word), then, when the frame inserts, the
        branch of its kind."""
        if flags is None:
            words = torch.cat((self.track.outputs.flags.reshape(-1).to(torch.int32), self.diverged)).tolist()
            self.check(words[-1])
            flags = words[:2]
        insert, stored = flags
        if insert:
            self._run_branch(bool(stored))
            self.unchecked = True

    def _run_branch(self, stored: bool) -> None:
        self.branch_step(stored).run()

    def check(self, diverged: int) -> None:
        """Raise if the read word :attr:`diverged` is set, or a collective
        of the group failed."""
        self.unchecked = False
        if self._check_peers is not None:
            self._check_peers()
        if diverged:
            raise RuntimeError(f"ranks diverged: the ranks' loop searches at frame {diverged - 1} of this rank "
                               "were for different frames")

    def _inputs(self) -> SimpleNamespace:
        outs = self.track.outputs
        return SimpleNamespace(img_u=self.track.inputs.img_u, polar=self.track.inputs.polar, fft=self.fft,
                               tracked=outs.tracked, packed=outs.packed, diverged=self.diverged)

    def branch_step(self, stored: bool) -> CapturedStep:
        """The branch of a keyframe that the bank stores (``stored``) or
        drops as one step, made at its first use (after a track run)."""
        step = self._branches.get(stored)
        if step is None:
            parts = self._branch(self.state, self._inputs(), stored)
            host = [fn for kind, fn in parts if kind != "device"]
            if host:
                raise ValueError(f"a branch that a graph holds has no host part, got {host}")
            step = CapturedStep(self.device, functools.partial(_in_turn, tuple(fn for _, fn in parts)), self._stream)
            self._branches[stored] = step
        return step


class HostBranchFrameGraph(CollectiveFrameGraph):
    """A :class:`CollectiveFrameGraph` whose keyframe branch's collectives
    a graph cannot hold (the distributed engine's on gloo with CPU
    tensors, or a group that keeps the host route): the track graph is its
    only whole-frame graph, and a frame that inserts runs the
    :class:`StagedBranch` of its kind (a stored or a dropped keyframe),
    made at its first use from ``branch(state, x, stored)``
    (``core/slam.py``'s ``staged_branch_parts``), on the buffers.  A chunk
    graph over it holds no SWITCH: an inserting frame stops the chunk
    after its track graph, the host finishes it here and the chunk resumes
    at the next frame (``ChunkGraph.host_exits``).  :attr:`diverged` as
    the base class's, read before the host makes any later collective."""

    host_branch = True

    def __init__(self, config, state, track_body: Body, branch: Branch,
                 check_peers: Optional[Callable[[], None]] = None):
        super().__init__(config, state, track_body, branch, check_peers)
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.programs = {}  # the branch kinds made so far: stored (a host bool) → StagedBranch

    def _run_branch(self, stored: bool) -> None:
        self.program(stored).run()

    def program(self, stored: bool) -> StagedBranch:
        """The branch of a keyframe that the bank stores (``stored``) or
        drops, made at its first use (after a track run)."""
        prog = self.programs.get(stored)
        if prog is None:
            prog = StagedBranch(self.device, self._branch(self.state, self._inputs(), stored), self._stream,
                                self._pool)
            self.programs[stored] = prog
        return prog

    def branch_step(self, stored: bool) -> CapturedStep:
        raise RuntimeError("this frame graph's keyframe branch makes collectives on the host: it is never "
                           "captured whole")


def lane_view(state, lane: int):
    """Lane ``lane`` of a batched state: the same dataclasses with every
    tensor leaf indexed (views of the batch's tensors)."""
    return type(state)(**{f.name: dataclasses.replace(part, **{n: x[lane] for n, x in _tensor_fields(part)})
                          for f in dataclasses.fields(state) for part in (getattr(state, f.name),)})


class BatchFrameGraph(FrameGraph):
    """:class:`FrameGraph` over a batch of lanes (the batch engine's): the
    private state's leaves carry a leading lane axis, the track graph runs
    every lane at once, the flag read is one (B, 2) read, and a frame in
    which k lanes insert replays body k, ``branch`` over every lane's
    buffers and track outputs with ``k`` (the branch finds and gathers the
    k lanes on the device, so its shapes are static).  A body per k that
    has occurred, at most B, each captured at its first use into one memory
    pool that they share: they run one at a time, and every result they
    keep lands in the buffers, not in the pool."""

    by_count = True

    def __init__(self, config, state, track_body: Body, branch: Branch):
        super().__init__(config, state, track_body, branch)
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.lanes = int(state.bank.count.shape[0])
        self.body_runs = collections.Counter()  # body k's runs through finish, by k

    def finish(self) -> None:
        """The rest of the frame whose track graph ran last: the (B, 2) flag
        read, then, when k lanes insert, body k's replay."""
        k = sum(insert for insert, _ in self.decide(self.track.outputs.flags))
        if k:
            self.body_step(k).run()
            self.body_runs[k] += 1

    def branch_slots(self) -> dict:
        """The bodies made so far by chunk-graph slot: body k at k − 1."""
        return {k - 1: step for k, step in self._branches.items()}

    def body_step(self, k: int) -> CapturedStep:
        """Body k, the keyframe branch over the k lanes that insert in a
        frame, made at its first use (after a track run)."""
        step = self._branches.get(k)
        if step is None:
            ins, outs = self.track.inputs, self.track.outputs
            x = SimpleNamespace(img_u=ins.img_u, polar=ins.polar, fft=self.fft, tracked=outs.tracked,
                                packed=outs.packed)
            step = CapturedStep(self.device, functools.partial(self._branch, self.state, x, k), self._stream,
                                self._pool)
            self._branches[k] = step
        return step
