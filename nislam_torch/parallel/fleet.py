"""Fleet data parallelism: one SLAM sequence per rank.

Counterpart of ``nislam_tpu.parallel.fleet``.  Rank r runs the plain
single engine (``nislam_torch.core.slam``) on lane r's sequence on its own
device, with its own control flow: the lane body makes no collective, so
frames/s grows with the ranks.  The per-frame outputs of every lane reach
every rank through one all-reduce at the end of
:meth:`FleetSlamEngine.run_sequences`.  The engine honours
``optimizer.inline`` as the single engine does.

Each rank holds only its own lane's state: :meth:`init_states` and
:meth:`place_states` return it, and :meth:`optimize` and :meth:`finalize`
act on it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from nislam_torch.core.slam import SlamState, StepOutput, make_engine, map_state, pack_outputs, unpack_step_output
from nislam_torch.parallel.mesh import RankGroup


def gather_lanes(group: RankGroup, packed: torch.Tensor) -> StepOutput:
    """Every rank's packed (L, N, 17) or (N, 17) lane outputs, lanes in rank
    order → numpy :class:`StepOutput` of (n·L, N) or (n, N), the same on
    every rank (one all-reduce)."""
    rows = group.gather_rows(packed.to(group.device))
    if packed.dim() == 3:
        rows = rows.flatten(0, 1)
    return unpack_step_output(rows.cpu().numpy())


class FleetSlamEngine:
    """This rank's lane of a fleet of ``group.size`` sequences."""

    def __init__(self, config, group: RankGroup):
        self.config = config
        self.group = group
        self.engine = make_engine(config, group.device)

    @property
    def n_lanes(self) -> int:
        return self.group.size

    def init_states(self) -> SlamState:
        return self.engine.init_state()

    def place_states(self, states_list: List[SlamState]) -> SlamState:
        """This rank's lane from one full state per lane (e.g. each loaded
        with ``io.checkpoint.load_state``), on this rank's device."""
        if len(states_list) != self.n_lanes:
            raise ValueError(f"{len(states_list)} states for {self.n_lanes} lanes")
        return map_state(states_list[self.group.rank], lambda x: x.to(self.engine.device, copy=True))

    def _lane(self, images):
        """This rank's (N, H, W) sequence of an (n, N, H, W) fleet array, or
        the (N, H, W) sequence it was given."""
        if images.ndim == 4:
            if images.shape[0] != self.n_lanes:
                raise ValueError(f"images lane axis {images.shape[0]} != n_lanes {self.n_lanes} "
                                 "(one sequence per 'data' rank)")
            return images[self.group.rank]
        return images

    def run_chunk(self, state: SlamState, images) -> Tuple[SlamState, StepOutput]:
        """One chunk of this rank's lane → its (N,) outputs on the device;
        no collective."""
        return self.engine.run_chunk(state, self._lane(images))

    def optimize(self, state: SlamState) -> Tuple[SlamState, bool]:
        return self.engine.optimize(state)

    def finalize(self, state: SlamState) -> Tuple[SlamState, bool]:
        return self.engine.finalize(state)

    def run_sequences(
        self, state: SlamState, images, *, chunk_frames: int = 64,
        solve_tally: Optional[List[bool]] = None,
    ) -> Tuple[SlamState, StepOutput]:
        """This rank's sequence through the single engine's chunked driver
        (between-chunk solves unless ``optimizer.inline``) → ``(state, outs)``
        with ``outs`` every lane's (n, N) outputs as numpy arrays.  Every
        lane must have the same N."""
        state, outs = self.engine.run_sequence(state, self._lane(images), chunk_frames=chunk_frames,
                                               solve_tally=solve_tally)
        return state, gather_lanes(self.group, torch.from_numpy(pack_outputs(outs)))


def make_fleet_engine(config, group: RankGroup) -> FleetSlamEngine:
    """The fleet over ``group`` (its ``data`` axis), lane ``group.rank`` on
    ``group.device``."""
    if group.axis != "data":
        raise ValueError(f"the fleet engine needs a 'data' group, not {group.axis!r}")
    return FleetSlamEngine(config, group)
