"""Parallel and multi-rank engines, counterparts of ``nislam_tpu.parallel``:

- :mod:`~nislam_torch.parallel.mesh` — ranks (``init_distributed``,
  ``RankGroup``) and their counted collectives;
- :mod:`~nislam_torch.parallel.batch` — B lanes as one batch on one card,
  or split over the ranks of a ``data`` group;
- :mod:`~nislam_torch.parallel.fleet` — one sequence per rank;
- :mod:`~nislam_torch.parallel.loop_search` and
  :mod:`~nislam_torch.parallel.solver` — the bank sharded over ranks and the
  edge-sharded GN-CG solve, wired into one engine by
  :mod:`~nislam_torch.parallel.engine`.
"""

from nislam_torch.parallel.mesh import init_distributed  # noqa: F401
from nislam_torch.parallel.batch import BatchSlamEngine, make_batch_engine  # noqa: F401
from nislam_torch.parallel.fleet import FleetSlamEngine, make_fleet_engine  # noqa: F401
from nislam_torch.parallel.engine import (  # noqa: F401
    DistributedSlamEngine,
    make_distributed_engine,
)
