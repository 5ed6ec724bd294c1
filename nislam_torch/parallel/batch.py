"""Multi-sequence SLAM: B robots' sequences tracked as one batch per rank.

Counterpart of ``nislam_tpu.parallel.batch``, whose chunk is one jitted
``lax.scan`` over a vmapped step and whose solves are one vmapped dense
LM.  Every state leaf carries a leading lane axis.  With a
:class:`~nislam_torch.parallel.mesh.RankGroup` on its ``data`` axis
(JAX's mesh), rank r runs lanes [r·B/n, (r+1)·B/n) and
:meth:`BatchSlamEngine.run_sequences` gathers every lane's outputs on
every rank with one all-reduce at the end; a frame makes no collective.

Per chunk the front end runs once over its (B·N) frames.  Then the
tracked frames run as ONE launch of the engine's
:class:`~nislam_torch.core.chunk_graph.ChunkGraph` over its
:class:`~nislam_torch.core.frame_graph.BatchFrameGraph`, which owns a
batch of states at fixed addresses (one more copy of B states).  Per
frame, with no host read:

- the track graph: tracking and the keyframe decision of all B lanes as
  one batched ``compute_pose`` (:func:`nislam_torch.core.slam.
  _track_body`), the outputs of lanes that insert nothing, the distance
  and the frame id;
- the packed (B, 2) flags ``[insert, stored]`` set ONE SWITCH node on
  the device to the number k of lanes that insert (a ballot and its
  popcount; none for k = 0);
- body k: ONE batched branch over those k lanes, gathered on the device
  in ascending order, as JAX's batch step runs one vmapped insert and one
  vmapped loop search: :func:`~nislam_torch.core.slam._branch_body_lanes`
  (the filters, the bank insert, the edges, pending invalidation and, for
  the lanes that stored, the loop search with its pending append).

:func:`run_chunk_frame_graph` runs the same graphs frame by frame with
one (B, 2) flag read each (and body k's replay), the reference the chunk
graph is timed against.

A frame whose lanes are not all initialized (the first frame of fresh
states) runs eagerly (:meth:`BatchSlamEngine._step`); the graphs start
at the next frame, as the single engine's do.  :func:`run_chunk_eager`
keeps the per-frame loop with every operation launched eagerly and each
lane's branch on the host, its loop search deferred behind one
any-lane-stored check as JAX's batch step has it: the reference that the
graphs are held against (:func:`eager_engine` runs an engine's chunks
through it).  Lanes share no state, so one branch over the gathered
lanes, its search inside it, gives each lane what its own branch and the
deferred search give.

As in JAX, batch mode defers both the loop search (above) and the solve:
pending loop matches are kept and solved by :meth:`BatchSlamEngine.
optimize` after every chunk and by :meth:`BatchSlamEngine.finalize`,
whatever ``optimizer.inline`` says.  A trigger is one launch of the
engine's :class:`~nislam_torch.core.solve_graph.SolveGraph` over the
frame graph's B states and one read of its run flags: every lane's
pending edges by a masked loop, ONE batched LM over all B lanes under the
lane mask (JAX's vmapped ``cond`` is a select: every lane pays the
batched Cholesky), the LM loop a WHILE node, then the poses, the pending
clear and the chain of the lanes that ran.  :func:`optimize_host_loop`
keeps the trigger as a host loop (one read of every lane's pending
buffer, the loop edges added lane by lane, the same batched solve with
one read per iteration), the reference.  Each lane's result is JAX's
batch engine's, which equals the single engine's deferred sequence loop
at the same chunking.
"""

from __future__ import annotations

import copy
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.camera import CameraOps
from nislam_torch.core.chunk_graph import ChunkGraph
from nislam_torch.core.frame_graph import BatchFrameGraph, lane_view
from nislam_torch.core.solve_graph import SolveGraph
from nislam_torch.core.pose_graph import PoseGraphProblem, solve_pose_graph_lanes
from nislam_torch.core.slam import (
    SlamState,
    StepOutput,
    _add_pending_edges,
    _branch_body_lanes,
    _init_step,
    _insert_keyframe,
    _live_pending_count,
    _map_problem,
    _rederive_chain,
    _solver_config,
    _step_output,
    _take_solution,
    _track,
    _track_body,
    dead_step_output,
    deferred_loop_search,
    frontend,
    init_state,
    make_engine,
    make_solve_graph,
    map_state,
    outputs_to_numpy,
    solve_lanes,
    state_leaves,
    unpack_step_output,
)
from nislam_torch.ops.registration import CFOps
from nislam_torch.parallel.fleet import gather_lanes
from nislam_torch.parallel.mesh import RankGroup


def _lane(states: SlamState, b: int) -> Tuple[SlamState, List[torch.Tensor]]:
    """Lane ``b`` as a state of views, and its leaves as they were."""
    view = lane_view(states, b)
    return view, state_leaves(view)


def _store_lane(states: SlamState, b: int, before: List[torch.Tensor], lane: SlamState) -> None:
    """Copy into lane ``b`` every leaf that ``lane``'s branch replaced
    (leaves it updated in place are views of the batch already)."""
    for dst, old, new in zip(state_leaves(states), before, state_leaves(lane)):
        if new is not old:
            dst[b].copy_(new)


def _at(x, b: int):
    """Lane ``b`` of every field of a named tuple."""
    return type(x)(*(f[b] for f in x))


class BatchSlamEngine:
    """``batch`` sequences in lockstep on one device: all B lanes, or with
    a ``group`` this rank's share of them (its states and chunks hold
    ``batch`` lanes)."""

    def __init__(self, config, batch: int, cf_ops: CFOps, camera: CameraOps, device: torch.device,
                 group: Optional[RankGroup] = None):
        self.config = config
        self.batch = batch
        self.cf_ops = cf_ops
        self.camera = camera
        self.device = device
        self.group = group
        self._kw = dict(config=config, cf_ops=cf_ops, camera=camera)
        self._frame_graph: Optional[BatchFrameGraph] = None
        self._chunk_graph: Optional[ChunkGraph] = None
        self._solve_graph: Optional[SolveGraph] = None

    @property
    def lanes(self) -> range:
        """The global indices of the lanes this engine runs."""
        first = self.group.rank * self.batch if self.group is not None else 0
        return range(first, first + self.batch)

    def init_states(self) -> SlamState:
        one = init_state(self.config, self.device)
        return map_state(one, lambda x: x[None].repeat((self.batch,) + (1,) * x.dim()))

    @property
    def frame_graph(self) -> BatchFrameGraph:
        """The lanes' tracked frame as graphs over a batch of states of its
        own, made at its first use (one more copy of B states) and each
        graph captured at its first run on a card."""
        if self._frame_graph is None:
            self._frame_graph = BatchFrameGraph(self.config, self.init_states(),
                                                functools.partial(_track_body, **self._kw),
                                                functools.partial(_branch_body_lanes, **self._kw))
        return self._frame_graph

    @property
    def chunk_graph(self) -> ChunkGraph:
        """A chunk's tracked frames of every lane as one graph launch over
        :attr:`frame_graph`'s buffers (one SWITCH node, a body per number of
        inserting lanes), built at its first launch and again when a body
        was added."""
        if self._chunk_graph is None:
            self._chunk_graph = ChunkGraph(self.frame_graph)
        return self._chunk_graph

    @property
    def solve_graph(self) -> SolveGraph:
        """Every lane's deferred trigger as one graph launch over
        :attr:`frame_graph`'s buffers, its steps captured at the first
        trigger that solves."""
        if self._solve_graph is None:
            self._solve_graph = make_solve_graph(self.frame_graph, self.config, self.camera)
        return self._solve_graph

    def _live(self, states: SlamState) -> List[bool]:
        """Which lanes have had their first frame: all, without a read, for
        the states that the frame graph lent last; else one host read."""
        if self._frame_graph is not None and states is self._frame_graph._lent_state():
            return [True] * self.batch
        return states.track.initialized.tolist()

    def _step(self, states: SlamState, feats, live: List[bool]) -> StepOutput:
        """One frame of every lane (features (B, ...)); ``live[b]``: lane b
        is initialized.  Updates ``states`` in place; returns the (B,) outputs."""
        kw = self._kw
        img_u, fft, polar = feats
        dev = fft.device
        nb = self.batch
        frame_id = states.track.next_frame_id.clone()
        if any(live):
            t = _track(states.track, states.bank.count, feats, **kw)
            # The one host read of a frame: (B, 2) [insert, stored].
            flags = torch.stack([t.insert, t.will_store], dim=-1).tolist()
            out = _step_output(
                t, frame_id, self.camera, pose=t.cur_pose, cf_pose=t.cur_cf_pose,
                keyframe_slot=torch.full((nb,), -1, dtype=torch.int32, device=dev),
                loop_found=torch.zeros(nb, dtype=torch.bool, device=dev),
                loop_slot=torch.full((nb,), -1, dtype=torch.int32, device=dev),
                loop_eligible=torch.zeros(nb, dtype=torch.int32, device=dev),
                optimized=torch.zeros(nb, dtype=torch.bool, device=dev),
            )
        else:
            flags = [(False, False)] * nb
            out = StepOutput(*(x.clone() for x in dead_step_output((nb,), dev)))

        stored = []
        for b in range(nb):
            if live[b] and not flags[b][0]:
                continue
            lane, before = _lane(states, b)
            f = (img_u[b], fft[b], polar[b])
            if not live[b]:
                lane, o = _init_step(lane, f, **kw)
                for field, x in zip(out, o):
                    field[b] = x
            else:
                lane, _, _, slot, _, _ = _insert_keyframe(
                    lane, f, _at(t, b), flags[b][1], frame_id[b], search=False, inline=False, **kw,
                )
                out.keyframe_slot[b] = slot
                if flags[b][1]:
                    stored.append(b)
            _store_lane(states, b, before, lane)

        track = states.track
        if all(live):
            track.distance.copy_(t.new_distance)
            track.next_frame_id += 1
            track.initialized.fill_(True)
        else:
            for b in (b for b in range(nb) if live[b]):
                track.distance[b] = t.new_distance[b]
                track.next_frame_id[b] += 1
                track.initialized[b] = True

        if self.config.loop_closure.to_find_loop and stored:
            for b in stored:
                lane, before = _lane(states, b)
                lane, o = deferred_loop_search(lane, (img_u[b], fft[b], polar[b]), _at(out, b), **kw)
                out.loop_found[b] = o.loop_found
                out.loop_slot[b] = o.loop_slot
                out.loop_eligible[b] = o.loop_eligible
                _store_lane(states, b, before, lane)
        return out

    def _features(self, images):
        """(B, N, H, W) frames → the front end over the chunk's B·N frames,
        frame-major (each frame's (B, ...) features contiguous); None for
        a chunk of no frame."""
        images = torch.as_tensor(images).to(self.device)
        nb = images.shape[0]
        if nb != self.batch:
            raise ValueError(f"images have {nb} lanes, the engine {self.batch}")
        if images.shape[1] == 0:
            return None
        return frontend(images.transpose(0, 1).contiguous(), cf_ops=self.cf_ops, camera=self.camera)

    def run_chunk(self, states: SlamState, images) -> Tuple[SlamState, StepOutput]:
        """(B, N, H, W) frames (u8, or f32 in [0, 1]): the front end once
        over the chunk's B·N frames, then N frames of every lane: the
        tracked frames as one launch of :attr:`chunk_graph` (no host read
        between them; one after the chunk).  Returns the state that the
        graph lends (see :class:`~nislam_torch.core.frame_graph.FrameGraph`)
        and (B, N) outputs on the device."""
        return _run_chunk(self, states, images, lambda feats, packed, start: self.chunk_graph.run(
            feats, packed, start))

    def optimize(self, states: SlamState) -> Tuple[SlamState, List[bool]]:
        """The deferred trigger of every lane → (states, ran per lane): one
        launch of :attr:`solve_graph` (lanes with ≥ 2 live matches add
        their loop edges, solve in one batched LM over every lane under
        the lane mask and re-derive their chains) and one read; for states
        whose lanes have not all had their first frame, the host loop
        (:func:`optimize_host_loop`)."""
        if not all(self._live(states)):
            return optimize_host_loop(self, states)
        return solve_lanes(self, states)

    def finalize(self, states: SlamState) -> Tuple[SlamState, List[bool]]:
        """End-of-sequence trigger of every lane; clears the pending buffers."""
        states, ran = self.optimize(states)
        states.pending.count.zero_()
        return states, ran

    def run_sequences(
        self, states: SlamState, images, *, chunk_frames: int = 64,
        solve_tally: Optional[List[List[bool]]] = None,
    ) -> Tuple[SlamState, StepOutput]:
        """Whole (B, N, H, W) sequences in chunks of ``chunk_frames`` (the
        tail chunk shorter), :meth:`optimize` after each; ``solve_tally``
        collects its per-lane flags.  Returns ``(states, StepOutput[B, N])``
        as numpy arrays, read once at the end.  With a group, ``images``
        holds all B lanes or this rank's, and the outputs are every lane's."""
        nb = self.batch * (self.group.size if self.group is not None else 1)
        if images.shape[0] == nb:
            images = images[self.lanes.start:self.lanes.stop]
        n = images.shape[1]
        c = max(1, min(chunk_frames, n))
        outs = []
        for start in range(0, n, c):
            states, o = self.run_chunk(states, images[:, start:start + c])
            outs.append(o)
            states, ran = self.optimize(states)
            if solve_tally is not None:
                solve_tally.append(ran)
        if not outs:
            return states, unpack_step_output(np.zeros((nb, 0, 17), np.float32))
        if self.group is not None:
            return states, gather_lanes(self.group, torch.cat([o.pack() for o in outs], dim=1))
        return states, outputs_to_numpy(outs, dim=1)


def _run_chunk(engine: BatchSlamEngine, states: SlamState, images, tracked) -> Tuple[SlamState, StepOutput]:
    """A chunk whose tracked frames ``[start, n)`` run as ``tracked(feats,
    packed, start)`` over the loaded frame graph."""
    feats = engine._features(images)
    if feats is None:
        return states, dead_step_output((engine.batch, 0), engine.device)
    img_u, fft, polar = feats
    n = fft.shape[0]
    packed = torch.empty((engine.batch, n, 17), dtype=torch.float32, device=engine.device)
    start = 0
    live = engine._live(states)
    if not all(live):
        packed[:, 0].copy_(engine._step(states, (img_u[0], fft[0], polar[0]), live).pack())
        start = 1
    if start < n:
        graph = engine.frame_graph
        graph.load(states)
        tracked(feats, packed, start)
        states = graph.lend(states)
    return states, unpack_step_output(packed)


def run_chunk_frame_graph(engine: BatchSlamEngine, states: SlamState, images) -> Tuple[SlamState, StepOutput]:
    """:meth:`BatchSlamEngine.run_chunk` through the frame graph frame by
    frame, with its (B, 2) flag read: per frame three feature copies, the
    track graph's replay, the flag read, body k's replay when k lanes
    insert, one copy of the packed (B, 17) outputs.  The reference that the
    chunk graph is held and timed against."""
    def frames(feats, packed, start):
        graph = engine.frame_graph
        for i in range(start, feats[1].shape[0]):
            packed[:, i].copy_(graph.run(*(x[i] for x in feats)))

    return _run_chunk(engine, states, images, frames)


def optimize_host_loop(engine: BatchSlamEngine, states: SlamState) -> Tuple[SlamState, List[bool]]:
    """:meth:`BatchSlamEngine.optimize` as a host loop: one read of every
    lane's live pending count and pending buffer, the loop edges of the
    lanes with ≥ 2 live matches added one by one, the same batched LM over
    every lane under the lane mask (:func:`~nislam_torch.core.pose_graph.
    solve_pose_graph_lanes`, one read per iteration) and the chains of the
    lanes that ran re-derived.  The reference that the solve graph is
    held against."""
    pending = states.pending
    host = torch.cat([_live_pending_count(pending)[:, None], pending.count[:, None], pending.loop_slot],
                     dim=1).tolist()
    ran = [row[0] >= 2 for row in host]
    if not any(ran):
        return states, ran
    views = [_lane(states, b) for b in range(engine.batch)]
    for (view, _), row, r in zip(views, host, ran):
        if r:
            _add_pending_edges(view, engine.camera, row[2:2 + row[1]])
    probs = [_map_problem(view.bank, view.edges, engine.camera) for view, _ in views]
    run = torch.tensor(ran, device=engine.device)
    poses, _, _ = solve_pose_graph_lanes(
        PoseGraphProblem(*(torch.stack(leaf) for leaf in zip(*probs))), _solver_config(engine.config),
        init_scale=1.0, scale_free=not engine.config.camera.accurate_height, run=run)
    for (view, before), b, p in zip(views, range(engine.batch), poses):
        if ran[b]:
            _take_solution(view, p, engine.config, engine.camera)
            _store_lane(states, b, before, _rederive_chain(view, engine.camera))
    return states, ran


def finalize_host_loop(engine: BatchSlamEngine, states: SlamState) -> Tuple[SlamState, List[bool]]:
    """:meth:`BatchSlamEngine.finalize` as a host loop (see :func:`optimize_host_loop`)."""
    states, ran = optimize_host_loop(engine, states)
    states.pending.count.zero_()
    return states, ran


def run_chunk_eager(engine: BatchSlamEngine, states: SlamState, images) -> Tuple[SlamState, StepOutput]:
    """:meth:`BatchSlamEngine.run_chunk` with every operation of every frame
    launched eagerly (:meth:`BatchSlamEngine._step`): the batched tracking,
    the flag read, each inserting lane's branch on the host and the
    deferred loop search of each lane that stored.  The reference that the
    graphs are held against, on the card and on the CPU."""
    feats = engine._features(images)
    if feats is None:
        return states, dead_step_output((engine.batch, 0), engine.device)
    live = states.track.initialized.tolist()  # one read per chunk
    packed = []
    for i in range(feats[1].shape[0]):
        out = engine._step(states, tuple(x[i] for x in feats), live)
        live = [True] * engine.batch
        packed.append(out.pack())
    return states, unpack_step_output(torch.stack(packed, dim=1))


def eager_engine(engine: BatchSlamEngine, run_chunk=run_chunk_eager) -> BatchSlamEngine:
    """A copy of ``engine`` (its set-up and graphs shared) whose chunks run
    through ``run_chunk``: :func:`run_chunk_eager`, the reference that the
    graphs are held against, whose triggers run as the host loop too
    (:func:`optimize_host_loop`), or :func:`run_chunk_frame_graph`, whose
    triggers are the engine's solve graph."""
    if run_chunk is not run_chunk_eager:
        engine.solve_graph  # made before the copy (the frame graph with it), which shares them
    other = copy.copy(engine)
    other.run_chunk = functools.partial(run_chunk, other)
    if run_chunk is run_chunk_eager:
        other.optimize = functools.partial(optimize_host_loop, other)
        other.finalize = functools.partial(finalize_host_loop, other)
    return other


def make_batch_engine(config, batch: int, device="cuda", group: Optional[RankGroup] = None) -> BatchSlamEngine:
    """Batch engine of ``batch`` lanes for ``config`` on ``device`` (the
    card unless the caller asks for another).  With a ``group`` on its
    ``data`` axis, this rank's engine of ``batch / n`` lanes."""
    if batch < 1:
        raise ValueError(f"batch must be positive, got {batch}")
    if group is not None:
        if group.axis != "data":
            raise ValueError(f"the batch engine splits its lanes over a 'data' group, not {group.axis!r}")
        if batch % group.size:
            raise ValueError(f"batch {batch} not divisible by {group.size} 'data' ranks")
        batch //= group.size
    single = make_engine(config, torch.device(device))
    return BatchSlamEngine(config, batch, single.cf_ops, single.camera, single.device, group)

