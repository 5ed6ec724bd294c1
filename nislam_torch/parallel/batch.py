"""Multi-sequence SLAM: B robots' sequences tracked as one batch per rank.

Counterpart of ``nislam_tpu.parallel.batch``.  Every state leaf carries a
leading lane axis.  With a :class:`~nislam_torch.parallel.mesh.RankGroup`
on its ``data`` axis (JAX's mesh), rank r runs lanes
[r·B/n, (r+1)·B/n) and :meth:`BatchSlamEngine.run_sequences` gathers every
lane's outputs on every rank with one all-reduce at the end.  Per frame:

- the front end has already run once over the chunk's (B·N) frames;
- tracking and the keyframe decision of all B lanes run as one batched
  ``compute_pose`` (:func:`nislam_torch.core.slam._track`), launched
  eagerly (the single engine replays a captured graph here);
- ONE packed (B, 2) flag tensor ``[insert, stored]`` is read;
- only then do the per-lane host branches run, for lanes that insert:
  filters, bank insert, edge; and, behind one any-lane-stored check,
  :func:`~nislam_torch.core.slam.deferred_loop_search` for each lane that
  stored a keyframe.

A lane's branch runs the single engine's code on views of the lane's
slice of each leaf (``x[b]``): in-place writes land in the batch, and a
leaf the branch replaces (the compacted pending buffer, the new tracking
target, solved poses) is copied back into its lane.

As in JAX, batch mode defers both the loop search (above) and the solve:
pending loop matches are kept and solved per lane by :meth:`optimize`
after every chunk and by :meth:`finalize`, whatever ``optimizer.inline``
says.  Each lane's result is JAX's batch engine's, which equals the
single engine's deferred sequence loop at the same chunking.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from nislam_torch.core.camera import CameraOps
from nislam_torch.core.slam import (
    SlamState,
    StepOutput,
    _init_step,
    _insert_keyframe,
    _live_pending_count,
    _step_output,
    _track,
    dead_step_output,
    deferred_loop_search,
    frontend,
    init_state,
    make_engine,
    map_state,
    outputs_to_numpy,
    solve_and_rederive,
    state_leaves,
    unpack_step_output,
)
from nislam_torch.ops.registration import CFOps
from nislam_torch.parallel.fleet import gather_lanes
from nislam_torch.parallel.mesh import RankGroup


def _lane(states: SlamState, b: int) -> Tuple[SlamState, List[torch.Tensor]]:
    """Lane ``b`` as a state of views, and its leaves as they were."""
    view = map_state(states, lambda x: x[b])
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

    @property
    def lanes(self) -> range:
        """The global indices of the lanes this engine runs."""
        first = self.group.rank * self.batch if self.group is not None else 0
        return range(first, first + self.batch)

    def init_states(self) -> SlamState:
        one = init_state(self.config, self.device)
        return map_state(one, lambda x: x[None].repeat((self.batch,) + (1,) * x.dim()))

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

    def run_chunk(self, states: SlamState, images) -> Tuple[SlamState, StepOutput]:
        """(B, N, H, W) frames (u8, or f32 in [0, 1]): the front end once
        over the chunk's B·N frames, then N batched steps.  Returns (B, N)
        outputs on the device."""
        images = torch.as_tensor(images).to(self.device)
        nb, n = images.shape[:2]
        if nb != self.batch:
            raise ValueError(f"images have {nb} lanes, the engine {self.batch}")
        if n == 0:
            return states, dead_step_output((nb, 0), self.device)
        # Frame-major, so each frame's (B, ...) features are contiguous.
        feats = frontend(images.transpose(0, 1).contiguous(), cf_ops=self.cf_ops, camera=self.camera)
        live = states.track.initialized.tolist()  # one read per chunk
        packed = []
        for i in range(n):
            out = self._step(states, tuple(x[i] for x in feats), live)
            live = [True] * nb
            packed.append(out.pack())
        return states, unpack_step_output(torch.stack(packed, dim=1))

    def optimize(self, states: SlamState) -> Tuple[SlamState, List[bool]]:
        """The deferred trigger of every lane: one read of the (B,) live
        pending counts, then a solve for each lane with ≥ 2 → (states, ran
        per lane)."""
        ran = [c >= 2 for c in _live_pending_count(states.pending).tolist()]
        for b in (b for b in range(self.batch) if ran[b]):
            lane, before = _lane(states, b)
            lane = solve_and_rederive(lane, config=self.config, camera=self.camera)
            _store_lane(states, b, before, lane)
        return states, ran

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

