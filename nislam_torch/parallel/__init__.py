"""Multi-sequence engines: :class:`~nislam_torch.parallel.batch.BatchSlamEngine`
(B lanes as one batch on one card)."""

from nislam_torch.parallel.batch import BatchSlamEngine, make_batch_engine  # noqa: F401
