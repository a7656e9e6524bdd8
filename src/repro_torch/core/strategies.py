"""Resource allocation strategies (paper Table 4).

ST1 — always use non-accelerator instances.
ST2 — always use accelerator instances.
ST3 — THIS PAPER: consider both to minimize overall cost.

All strategies share the manager's estimation + formulation + solver stack
(paper §4.4: "All the strategies benefit from the ability of the manager
to estimate ... formulate ... and solve it").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .binpack.problem import BinType

__all__ = ["Strategy", "ST1", "ST2", "ST3", "ALL_STRATEGIES"]

#: Index of the first accelerator dim in the canonical 4-dim space.
_ACC_DIM = 2


def _has_accelerator(bt: BinType) -> bool:
    return any(c > 0 for c in bt.capacity[_ACC_DIM:])


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    description: str

    def filter_bins(self, catalog: Sequence[BinType]) -> tuple[BinType, ...]:
        if self.name == "ST1":
            return tuple(b for b in catalog if not _has_accelerator(b))
        if self.name == "ST2":
            return tuple(b for b in catalog if _has_accelerator(b))
        return tuple(catalog)

    def filter_choice_labels(self) -> tuple[str, ...] | None:
        """Choice labels allowed, or None for all (paper §4.4: single choice
        exists for each program under ST1/ST2)."""
        if self.name == "ST1":
            return ("cpu",)
        if self.name == "ST2":
            return ("accel",)
        return None


ST1 = Strategy("ST1", "Always use non-GPU instances")
ST2 = Strategy("ST2", "Always use GPU instances")
ST3 = Strategy("ST3", "This paper: use non-GPU and GPU instances to reduce cost")
ALL_STRATEGIES = (ST1, ST2, ST3)
