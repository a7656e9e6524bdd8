"""Cloud instance catalogs.

Two catalogs ship:

* ``paper_ec2_catalog`` — the exact Amazon EC2 types of paper Table 1
  (Oregon pricing, 2018), dimensions [CPU cores, mem GB, GPU cores, GPU GB].
* ``tpu_cloud_catalog`` — the TPU-cloud adaptation:
  dimensions [host CPU cores, host mem GB, TPU TFLOP/s, TPU HBM GB], with
  v5e-derived capabilities (197 bf16 TFLOP/s and 16 GB HBM per chip) and
  on-demand-style hourly prices.

The multi-GPU expansion of paper §3.2 (dimension ``2 + 2N``) is provided by
:func:`expand_multi_accelerator`.
"""
from __future__ import annotations

import hashlib
import json

from .binpack.problem import BinType

__all__ = [
    "paper_ec2_catalog",
    "tpu_cloud_catalog",
    "expand_multi_accelerator",
    "spot_variant",
    "with_spot_variants",
    "catalog_signature",
    "PAPER_DIMS",
    "TPU_DIMS",
    "SPOT_SUFFIX",
]

#: Dimension labels for the paper catalog (single-accelerator form).
PAPER_DIMS = ("cpu_cores", "mem_gb", "gpu_cores", "gpu_mem_gb")
TPU_DIMS = ("cpu_cores", "mem_gb", "tpu_tflops", "tpu_hbm_gb")


def paper_ec2_catalog(include_multi_gpu: bool = False) -> tuple[BinType, ...]:
    """Paper Table 1. g2.2xlarge GPU = 1536 CUDA cores / 4 GB (paper §3.2)."""
    base = (
        BinType("c4.2xlarge", capacity=(8, 15, 0, 0), cost=0.419),
        BinType("c4.8xlarge", capacity=(36, 60, 0, 0), cost=1.675),
        BinType("g2.2xlarge", capacity=(8, 15, 1536, 4), cost=0.650),
    )
    if not include_multi_gpu:
        return base
    # g2.8xlarge: 32 cores, 60 GB, 4 GPUs -> dimension 2 + 2*4 = 10.
    n_gpus = 4
    expanded = tuple(
        expand_multi_accelerator(bt, n_accelerators=n_gpus) for bt in base
    )
    g28 = BinType(
        "g2.8xlarge",
        capacity=(32, 60) + (1536, 4) * n_gpus,
        cost=2.600,
    )
    return expanded + (g28,)


def tpu_cloud_catalog() -> tuple[BinType, ...]:
    """TPU-cloud adaptation: [host cores, host GB, TPU TFLOP/s, HBM GB].

    Prices follow the real on-demand gradient (bigger slices are nearly
    linear with a small premium for the host; the CPU-only host matches a
    c-family box). One v5e chip: 197 bf16 TFLOP/s, 16 GB HBM.
    """
    chip_tf, chip_hbm = 197.0, 16.0
    return (
        BinType("cpu-host-16", capacity=(16, 64, 0, 0), cost=0.680),
        BinType("v5e-1", capacity=(24, 48, 1 * chip_tf, 1 * chip_hbm), cost=1.200),
        BinType("v5e-4", capacity=(112, 192, 4 * chip_tf, 4 * chip_hbm), cost=4.400),
        BinType("v5e-8", capacity=(224, 384, 8 * chip_tf, 8 * chip_hbm), cost=8.470),
    )


def catalog_signature(catalog: "tuple[BinType, ...]") -> str:
    """Stable fingerprint of a catalog's *shapes* (names + capacity vectors).

    Calibration artifacts are keyed by this signature: requirement vectors
    are only valid against the capacity geometry they were clamped to.
    Prices, hazards, and rent overlays are deliberately excluded — re-pricing
    a catalog (spot drift, `refresh_prices`) does not stale the calibration,
    while adding/removing a type or resizing a capacity does.
    """
    payload = json.dumps(
        sorted((bt.name, [float(c) for c in bt.capacity]) for bt in catalog),
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]


#: Naming convention for spot variants: "<on-demand name>-spot".
SPOT_SUFFIX = "-spot"


def spot_variant(
    bin_type: BinType,
    *,
    price_ratio: float = 0.35,
    hazard: float = 0.05,
    suffix: str = SPOT_SUFFIX,
) -> BinType:
    """The spot/preemptible variant of an on-demand instance type.

    Same capacity vector, rent discounted to ``price_ratio`` of the
    on-demand price (clouds sell spot at a deep discount — 2018-era EC2
    spot cleared around 30-40% of on-demand), and an interruption
    ``hazard`` (expected preemptions per instance-hour) — the risk the
    discount pays for.  The variant is a *separate* catalog entry, so a
    fleet can mix spot and on-demand copies of the same shape and the
    solver prices each on its own contract.  ``suffix`` names the spot
    pool: real markets sell the same shape from several pools at
    different (price, interruption-frequency) points, and a catalog may
    carry one entry per pool.
    """
    if not 0.0 < price_ratio <= 1.0:
        raise ValueError(f"price_ratio must be in (0, 1], got {price_ratio}")
    if hazard <= 0.0:
        raise ValueError(f"spot variant needs hazard > 0, got {hazard}")
    if bin_type.is_spot or bin_type.rent is not None:
        # Discounting an already-spot (or risk-adjusted) entry would
        # compound the discount off a decision cost and bill a figure
        # that was never rent.
        raise ValueError(
            f"bin {bin_type.name}: spot variants derive from on-demand "
            f"entries only"
        )
    return BinType(
        name=bin_type.name + suffix,
        capacity=bin_type.capacity,
        cost=bin_type.cost * price_ratio,
        hazard=hazard,
    )


def with_spot_variants(
    catalog: "tuple[BinType, ...]",
    *,
    price_ratio: float = 0.35,
    hazard: float = 0.05,
    hazards: "dict[str, float] | None" = None,
    suffix: str = SPOT_SUFFIX,
) -> tuple[BinType, ...]:
    """A two-tier market: every on-demand type plus its spot variant.

    ``hazards`` overrides the interruption rate per on-demand type name
    (scarce shapes — GPU boxes — get reclaimed more often than plentiful
    CPU ones).  Types already carrying a hazard pass through unchanged.
    Apply repeatedly with distinct ``suffix``es to model several spot
    pools per shape (cheap-but-flaky next to dearer-but-stable).
    """
    out = list(catalog)
    taken = {bt.name for bt in catalog}
    unknown = set(hazards or {}) - {bt.name for bt in catalog if not bt.is_spot}
    if unknown:
        # A typo'd override would silently mint the pool at the default
        # hazard — under-pricing its eviction risk everywhere downstream.
        raise KeyError(
            f"hazards= names no on-demand catalog type: {sorted(unknown)}"
        )
    for bt in catalog:
        if bt.is_spot:
            continue
        sv = spot_variant(
            bt,
            price_ratio=price_ratio,
            hazard=(hazards or {}).get(bt.name, hazard),
            suffix=suffix,
        )
        if sv.name in taken:
            # Same suffix applied twice: two same-named BinTypes would
            # resolve ambiguously everywhere the catalog is name-keyed
            # (re-pricing, billing_by_type, spare matching).
            raise ValueError(
                f"spot variant {sv.name!r} already in catalog — use a "
                f"distinct suffix per pool"
            )
        taken.add(sv.name)
        out.append(sv)
    return tuple(out)


def expand_multi_accelerator(bin_type: BinType, n_accelerators: int) -> BinType:
    """Lift a single-accelerator-form bin into the 2 + 2N dimension space.

    Paper §3.2: a non-GPU instance in the 4-GPU problem becomes
    [cores, mem, 0,0, 0,0, 0,0, 0,0]; a 1-GPU instance puts its GPU in the
    first accelerator slot.
    """
    cores, mem, acc, acc_mem = bin_type.capacity
    slots: list[float] = []
    if acc > 0:
        slots += [acc, acc_mem]
        slots += [0.0, 0.0] * (n_accelerators - 1)
    else:
        slots += [0.0, 0.0] * n_accelerators
    return BinType(
        bin_type.name,
        capacity=(cores, mem, *slots),
        cost=bin_type.cost,
        hazard=bin_type.hazard,
        rent=bin_type.rent,
    )
