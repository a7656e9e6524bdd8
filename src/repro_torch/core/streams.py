"""Stream and analysis-program abstractions (paper §3.1 factors 2 & 3).

`StreamSpec` is the static fleet model the manager formulates from: an
analysis program, a desired frame rate, a frame size and an SLA tier.
`fleet_key` is the canonical order-insensitive fingerprint of a fleet.

QoS is first-class: every stream carries an `SLATier` — a service
contract naming its protection rank, its legal frame-rate ladder
(descending fractions of the nominal rate the allocator may degrade it
to, paper-style 30→15→5 FPS), its blackout budget (SLA-violation
threshold on service-interruption seconds), and the dollar penalties a
churn simulation accrues per degraded rung-hour and blackout-hour.  The
default tier (`DEFAULT_TIER`) is inert — no ladder, no budgets, no
penalties.

The live-loop vocabulary of the reference module (fleet events, timed
traces, storms, forecasts) is not part of this module yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = [
    "FrameSize",
    "StreamSpec",
    "AnalysisProgram",
    "COMMON_FRAME_SIZES",
    "SLATier",
    "DEFAULT_TIER",
    "GOLD",
    "SILVER",
    "BRONZE",
    "fleet_key",
]

@dataclasses.dataclass(frozen=True)
class FrameSize:
    width: int
    height: int

    @property
    def pixels(self) -> int:
        return self.width * self.height

    def __str__(self) -> str:
        return f"{self.width}x{self.height}"


#: Paper §3.1.3: "there are only a few common frame sizes among network cameras".
COMMON_FRAME_SIZES = (
    FrameSize(640, 480),
    FrameSize(1280, 720),
    FrameSize(1920, 1080),
)


@dataclasses.dataclass(frozen=True)
class AnalysisProgram:
    """An analysis program (VGG-16, ZF, or any model from the zoo).

    Allocation works from previously profiled requirement tables keyed by
    ``program_id``.
    """

    name: str
    #: identifies the profile-table entry; e.g. "vgg16", "zf", "gemma2-2b".
    program_id: str


@dataclasses.dataclass(frozen=True)
class SLATier:
    """A stream's service contract: protection rank, rate ladder, budgets.

    ``rank`` orders tiers by protection: 0 is the most protected; under
    pressure the allocator sheds the *highest* rank first.  The
    ``rate_ladder`` lists the legal service levels as descending fractions
    of the stream's nominal frame rate — rung 0 is always full rate
    (``1.0``); e.g. ``(1.0, 0.5, 1/6)`` is the paper-style 30→15→5 FPS
    ladder for a 30 FPS stream.  A one-rung ladder means the stream may
    never be degraded.

    ``blackout_budget_s`` is the SLA: the cumulative *blackout* (service
    fully interrupted — preemption gaps, uncovered notice tails, parked
    time) a stream may suffer over a trace before it counts as an SLA
    violation.  ``rung_penalty`` and ``blackout_penalty`` are the utility
    penalties (`$`/stream-hour per rung below full, and `$`/stream-hour
    dark) a churn simulation accrues, making its output a
    cost-vs-QoS pair rather than a single billed number.  ``parkable``
    tiers may be taken off the fleet entirely (parked) as a last resort.
    """

    name: str
    rank: int
    rate_ladder: tuple[float, ...] = (1.0,)
    blackout_budget_s: float = float("inf")
    rung_penalty: float = 0.0
    blackout_penalty: float = 0.0
    parkable: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "rate_ladder", tuple(self.rate_ladder))
        if self.rank < 0:
            raise ValueError(f"tier {self.name}: rank must be >= 0")
        if not self.rate_ladder or self.rate_ladder[0] != 1.0:
            raise ValueError(
                f"tier {self.name}: rate ladder must start at full rate (1.0)"
            )
        for lo, hi in zip(self.rate_ladder[1:], self.rate_ladder):
            if not 0.0 < lo < hi:
                raise ValueError(
                    f"tier {self.name}: ladder must be strictly decreasing "
                    f"and positive, got {self.rate_ladder}"
                )
        if self.blackout_budget_s < 0 or self.blackout_budget_s != self.blackout_budget_s:
            raise ValueError(f"tier {self.name}: blackout budget must be >= 0")
        if self.rung_penalty < 0 or self.blackout_penalty < 0:
            raise ValueError(f"tier {self.name}: penalties must be >= 0")


#: Inert contract: no ladder, no budget, no penalties.
DEFAULT_TIER = SLATier("STANDARD", rank=1)

#: Never degraded; tight blackout budget (one cold boot fits, two do not).
GOLD = SLATier(
    "GOLD", rank=0, blackout_budget_s=150.0, blackout_penalty=60.0
)
#: May halve its rate; generous blackout budget.
SILVER = SLATier(
    "SILVER",
    rank=1,
    rate_ladder=(1.0, 0.5),
    blackout_budget_s=600.0,
    rung_penalty=2.0,
    blackout_penalty=25.0,
)
#: Full 30→15→5-style ladder, unbounded budget, parkable as a last resort.
BRONZE = SLATier(
    "BRONZE",
    rank=2,
    rate_ladder=(1.0, 0.5, 1.0 / 6.0),
    rung_penalty=0.5,
    blackout_penalty=8.0,
    parkable=True,
)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A network-camera stream to be analyzed (paper Fig. 2 inputs)."""

    name: str
    program: AnalysisProgram
    desired_fps: float
    frame_size: FrameSize = COMMON_FRAME_SIZES[0]
    tier: SLATier = DEFAULT_TIER

    def __post_init__(self) -> None:
        if self.desired_fps <= 0:
            raise ValueError(f"stream {self.name}: fps must be > 0")



def fleet_key(streams: Sequence[StreamSpec]) -> tuple[StreamSpec, ...]:
    """Canonical (order-insensitive) fingerprint of a fleet.

    Two fleets with the same streams in different orders map to the same
    key; `StreamSpec` is frozen/hashable, so the key is directly usable in
    dicts and sets.
    """
    return tuple(sorted(streams, key=lambda s: (s.name, s.desired_fps)))
