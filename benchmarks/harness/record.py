"""What a metric's reader is given: one run's window and its readings."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Record:
    cell: object  # catalog.Cell
    device: object  # torch.device
    setup_s: float
    window: object  # window.Window
    trace: bool
    engine: object = None  # the system under test, for readers that time one of its layers
    sequences: object = None  # traffic.Sequences
    spans: Optional[dict] = None  # devtrace.call_spans of the window (--trace 1)
    counters: Optional[dict] = None  # the program's counters over the window (--trace 1)
    profile: Optional[dict] = None  # devtrace.profiled of one more sequence (--trace 1)

    @property
    def slam(self) -> dict:
        return self.cell.config["slam"]
