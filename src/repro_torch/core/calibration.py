"""Profile-calibrated requirement vectors (paper §3.1: test runs → MC-VBP).

The source paper's pipeline starts with *test runs*: before formulating the
multiple-choice vector bin packing problem, the manager estimates each
analysis program's per-resource requirements on every candidate device.
This module closes that loop for the fleet layer: it turns
``(program/model config, BinType)`` pairs into requirement vectors and
packages them as a JSON-persistable :class:`CalibrationArtifact` that the
manager, trace generators, and benchmarks consume instead of hand-written
numbers.

Two measurement modes:

* ``cpu_mode="analytic"`` (default) — seconds-per-frame is derived from the
  program's analytic FLOPs and a sustained per-core throughput recorded in
  the :class:`CpuSpec`.  Fully deterministic: the same workloads + catalog
  signature always yield bit-identical vectors (test-gated), which is what
  lets benchmarks pin scenarios to an artifact.
* ``cpu_mode="measured"`` — real wall-clock test runs through
  :func:`repro_torch.core.profiler.measure_cpu_profile` for programs with a
  runnable ``run_fn`` (the paper's actual procedure), on the machine's CPU
  whatever device the programs default to.  Nondeterministic by nature;
  the mode is recorded in provenance so consumers can tell.

Accelerator requirements are always derived
(:func:`derive_accelerator_profile` roofline occupancy over analytic
FLOPs/bytes — ``roofline.analysis.model_flops`` / ``model_hbm_bytes`` for
model-zoo programs, ``models.analysis_programs.program_flops`` for the
vision nets).

The arithmetic runs either as per-entry float64 scalars (``impl="numpy"``)
or as one vectorized float64 torch computation on a device (``impl="torch"``,
the card by default).  Both paths evaluate the same IEEE expression tree,
so the vectors are bit-identical before and after quantization —
test-gated.  The torch path keeps every operand a float64 tensor on the
device and divides with ``torch.div(tensor, tensor)``: ``scalar / tensor``
is a reciprocal times the scalar, and on CUDA ``tensor / python_float``
multiplies by the divisor's reciprocal, both one rounding more than the
scalar path's division.

Vectors are clamped to the catalog geometry: ``max_fps`` is the rate at
which the fastest-saturating *scaled* dimension exhausts the largest
capacity any catalog type offers, and a device entry is dropped entirely
when its rate-invariant memory floor fits no type.  The catalog's
:func:`repro_torch.core.catalog.catalog_signature` is recorded and
re-verified on load — a stale artifact (catalog reshaped since
calibration) is rejected with :class:`StaleCalibrationError`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import pathlib
from typing import Callable, Iterable, Sequence

import torch

from ..device import resolve_device
from .binpack.problem import BinType, Item
from .catalog import catalog_signature, paper_ec2_catalog, tpu_cloud_catalog
from .profiler import (
    DIM_ACC,
    DIM_ACC_MEM,
    DIM_CPU,
    DIM_MEM,
    GRID_K520,
    N_DIMS,
    ProfileTable,
    ResourceProfile,
    RooflineSpec,
    TPU_V5E,
    measure_cpu_profile,
)
from .streams import AnalysisProgram, FrameSize, StreamSpec

__all__ = [
    "ARTIFACT_VERSION",
    "CpuSpec",
    "EC2_C4_CPU",
    "TPU_HOST_CPU",
    "ProgramWorkload",
    "vision_workload",
    "model_workload",
    "CalibrationEntry",
    "CalibrationArtifact",
    "StaleCalibrationError",
    "calibrate",
    "requirements_from_calibration",
    "stream_kinds",
    "stream_mix",
    "preset_workloads",
    "load_or_calibrate",
    "default_artifact_path",
    "PRESETS",
]

ARTIFACT_VERSION = 1

#: Significant digits requirement vectors are quantized to.  Coarse enough
#: to absorb any cross-backend last-ulp wobble, fine enough that packing
#: decisions are unaffected (capacities are O(1)-O(1000) in every dim).
_QUANT_DIGITS = 6

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


def _quant(x: float) -> float:
    """Round to :data:`_QUANT_DIGITS` significant digits (pure, total)."""
    fx = float(x)
    if fx == 0.0 or not math.isfinite(fx):
        return fx
    return float(f"{fx:.{_QUANT_DIGITS}g}")


@dataclasses.dataclass(frozen=True)
class CpuSpec:
    """The CPU half of the hardware spec a calibration was taken on.

    ``flops_per_core`` is the *sustained* per-core throughput on this
    workload class (far below peak: convolution inner loops on 2015 EC2
    c4 cores clear ~2 GFLOP/s through an interpreter-fed pipeline, modern
    vectorized inference hosts ~25 GFLOP/s).  It is a recorded measurement
    constant, not a datasheet number — re-measure, re-record, recalibrate.
    """

    name: str
    cores: float
    memory_gb: float
    flops_per_core: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CpuSpec":
        return CpuSpec(**d)


#: c4-family EC2 host (paper Table 1 era): analytic seconds-per-frame at
#: ~2 GFLOP/s/core reproduces paper Table 3 within ~5% (VGG-16 at 0.2 FPS:
#: 3.3 cores analytic vs 3.15 measured).
EC2_C4_CPU = CpuSpec(name="c4-haswell", cores=8.0, memory_gb=15.0, flops_per_core=2.0e9)

#: Modern vectorized inference host fronting the TPU-cloud catalog.
TPU_HOST_CPU = CpuSpec(name="cpu-host-16", cores=16.0, memory_gb=64.0, flops_per_core=25.0e9)


@dataclasses.dataclass(frozen=True)
class ProgramWorkload:
    """Per-frame work of one analysis program: what calibration measures.

    ``flops_per_frame`` / ``bytes_per_frame`` drive the roofline terms;
    ``memory_gb`` is the rate-invariant resident footprint (weights +
    per-stream cache).  ``tokens_per_frame`` is nonzero for model-zoo
    programs (captioning/VQA over each frame) and recorded for provenance.
    """

    program_id: str
    flops_per_frame: float
    bytes_per_frame: float
    memory_gb: float
    frame_size: str = "640x480"
    tokens_per_frame: int = 0


def vision_workload(program_id: str, frame_size: FrameSize | None = None) -> ProgramWorkload:
    """Workload of a vision net (vgg16/zf) from its analytic layer configs."""
    from ..models.analysis_programs import program_flops, program_params

    fsz = frame_size if frame_size is not None else FrameSize(640, 480)
    params = program_params(program_id)
    return ProgramWorkload(
        program_id=program_id,
        flops_per_frame=program_flops(program_id, fsz),
        # f32 weights stream through once per frame, plus the input frame.
        bytes_per_frame=4.0 * params + 4.0 * (fsz.pixels * 3),
        # f32 weights + ~50% activation workspace.
        memory_gb=6.0 * params / 1e9,
        frame_size=str(fsz),
    )


def model_workload(
    arch_id: str,
    tokens_per_frame: int,
    frame_size: FrameSize | None = None,
) -> ProgramWorkload:
    """Workload of a model-zoo program: a ``tokens_per_frame`` prefill
    (caption/VQA context) per analyzed camera frame."""
    from ..configs import get_config
    from ..roofline.analysis import model_flops, model_hbm_bytes, model_kv_bytes

    cfg = get_config(arch_id)
    fsz = frame_size if frame_size is not None else FrameSize(640, 480)
    return ProgramWorkload(
        program_id=cfg.name,
        flops_per_frame=model_flops(cfg, tokens_per_frame),
        bytes_per_frame=model_hbm_bytes(cfg, tokens_per_frame),
        # bf16 weights resident + one live KV slot per stream.
        memory_gb=(2.0 * cfg.param_count() + model_kv_bytes(cfg, tokens_per_frame)) / 1e9,
        frame_size=str(fsz),
        tokens_per_frame=tokens_per_frame,
    )


class StaleCalibrationError(ValueError):
    """Artifact's catalog signature no longer matches the live catalog."""


@dataclasses.dataclass(frozen=True)
class CalibrationEntry:
    """One (program, frame size, device) profile row plus its workload."""

    program_id: str
    frame_size: str
    device: str  # "cpu" | "accel"
    reference_fps: float
    requirement: tuple[float, ...]
    max_fps: float
    source: str  # "analytic" | "measured" | "derived"
    flops_per_frame: float
    bytes_per_frame: float

    def profile(self) -> ResourceProfile:
        return ResourceProfile(
            program_id=self.program_id,
            frame_size=self.frame_size,
            device=self.device,
            reference_fps=self.reference_fps,
            requirement=self.requirement,
            max_fps=self.max_fps,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["requirement"] = list(self.requirement)
        return d

    @staticmethod
    def from_dict(d: dict) -> "CalibrationEntry":
        d = dict(d)
        d["requirement"] = tuple(float(x) for x in d["requirement"])
        return CalibrationEntry(**d)


@dataclasses.dataclass(frozen=True)
class CalibrationArtifact:
    """A persisted set of calibrated profiles, pinned to a catalog shape."""

    version: int
    catalog_signature: str
    catalog: tuple[tuple[str, tuple[float, ...]], ...]  # (name, capacity) echo
    hardware: dict  # {"cpu": CpuSpec dict, "roofline": RooflineSpec dict}
    provenance: dict  # mode/impl/fractions — how the numbers were produced
    entries: tuple[CalibrationEntry, ...]

    # -- ProfileTable compatibility ------------------------------------
    def profile_table(self) -> ProfileTable:
        table = ProfileTable()
        for e in self.entries:
            table.add(e.profile())
        return table

    def programs(self) -> tuple[str, ...]:
        return tuple(sorted({e.program_id for e in self.entries}))

    def supports(self, program_id: str, frame_size: str) -> bool:
        return any(
            e.program_id == program_id and e.frame_size == frame_size
            for e in self.entries
        )

    def max_feasible_fps(self, program_id: str, frame_size: str) -> float:
        """Highest rate *any* device entry can serve (0.0 when unknown)."""
        return max(
            (
                e.max_fps
                for e in self.entries
                if e.program_id == program_id and e.frame_size == frame_size
            ),
            default=0.0,
        )

    def check_stream(self, spec: StreamSpec) -> None:
        """Raise ValueError when no calibrated device can serve ``spec``."""
        pid, fsz = spec.program.program_id, str(spec.frame_size)
        if not self.supports(pid, fsz):
            raise ValueError(
                f"stream {spec.name}: no calibration entry for "
                f"({pid!r}, {fsz!r}); known programs: {self.programs()}"
            )
        cap = self.max_feasible_fps(pid, fsz)
        if spec.desired_fps > cap + 1e-9:
            raise ValueError(
                f"stream {spec.name}: {spec.desired_fps} FPS exceeds the "
                f"calibrated max {cap:.4g} FPS for {pid}"
            )

    # -- integrity -----------------------------------------------------
    def verify(self, catalog: Sequence[BinType]) -> None:
        live = catalog_signature(tuple(catalog))
        if live != self.catalog_signature:
            raise StaleCalibrationError(
                f"calibration artifact was taken against catalog "
                f"{self.catalog_signature} but the live catalog hashes to "
                f"{live} — recalibrate against it (scripts/torch_recalibrate.py)"
            )

    # -- what-if transforms --------------------------------------------
    def with_accelerator_speedup(self, factor: float) -> "CalibrationArtifact":
        """The artifact as if the accelerator kernels got ``factor``× faster.

        Re-derives every accelerator entry with the roofline's peak FLOP/s
        and HBM bandwidth scaled by ``factor`` (an end-to-end kernel
        speedup shrinks both terms of the occupancy): the accel-compute
        requirement divides by ``factor``, memory floors and host cores are
        unchanged, and ``max_fps`` re-clamps against the same catalog.
        This is the kernel→dollars probe.
        """
        if factor <= 0.0:
            raise ValueError(f"speedup factor must be > 0, got {factor}")
        roof = RooflineSpec(**self.hardware["roofline"])
        fast = RooflineSpec(
            name=f"{roof.name}-x{factor:g}",
            peak_flops=roof.peak_flops * factor,
            hbm_bandwidth=roof.hbm_bandwidth * factor,
            compute_capacity_units=roof.compute_capacity_units,
            memory_capacity_gb=roof.memory_capacity_gb,
        )
        caps = _max_caps(self.catalog)
        entries = []
        for e in self.entries:
            if e.device != "accel":
                entries.append(e)
                continue
            occupancy = fast.occupancy_per_frame(e.flops_per_frame, e.bytes_per_frame)
            ref = e.reference_fps
            acc_units = _quant(occupancy * ref * fast.compute_capacity_units)
            req = (e.requirement[DIM_CPU], e.requirement[DIM_MEM],
                   acc_units, e.requirement[DIM_ACC_MEM])
            max_fps = _quant(_accel_max_fps(
                occupancy, ref, fast.compute_capacity_units,
                e.requirement[DIM_CPU], caps,
            ))
            entries.append(dataclasses.replace(e, requirement=req, max_fps=max_fps))
        prov = dict(self.provenance)
        prov["accelerator_speedup"] = float(factor) * float(
            prov.get("accelerator_speedup", 1.0)
        )
        hw = dict(self.hardware)
        hw["roofline"] = dataclasses.asdict(fast)
        return dataclasses.replace(
            self, hardware=hw, provenance=prov, entries=tuple(entries)
        )

    # -- persistence ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "catalog_signature": self.catalog_signature,
            "catalog": [[n, list(c)] for n, c in self.catalog],
            "hardware": self.hardware,
            "provenance": self.provenance,
            "entries": [e.to_dict() for e in self.entries],
        }

    @staticmethod
    def from_dict(d: dict) -> "CalibrationArtifact":
        if d.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"unsupported calibration artifact version {d.get('version')!r}"
            )
        return CalibrationArtifact(
            version=int(d["version"]),
            catalog_signature=str(d["catalog_signature"]),
            catalog=tuple(
                (str(n), tuple(float(x) for x in c)) for n, c in d["catalog"]
            ),
            hardware=dict(d["hardware"]),
            provenance=dict(d["provenance"]),
            entries=tuple(CalibrationEntry.from_dict(e) for e in d["entries"]),
        )

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"
        )

    @staticmethod
    def load(path: str | pathlib.Path) -> "CalibrationArtifact":
        return CalibrationArtifact.from_dict(json.loads(pathlib.Path(path).read_text()))


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def _max_caps(catalog_echo: Iterable[tuple[str, tuple[float, ...]]]) -> tuple[float, ...]:
    """Per-dimension maximum capacity any catalog type offers."""
    caps = [0.0] * N_DIMS
    for _name, capacity in catalog_echo:
        for i in range(N_DIMS):
            caps[i] = max(caps[i], float(capacity[i]))
    return tuple(caps)


def _accel_max_fps(
    occupancy: float,
    ref: float,
    capacity_units: float,
    host_cores_at_ref: float,
    caps: tuple[float, ...],
) -> float:
    """Catalog-clamped accelerator max rate (same IEEE tree as the torch path).

    Mirrors ``derive_accelerator_profile``'s hardware bound, then clamps by
    the two dimensions that scale with fps: accel compute units and host
    cores.
    """
    hw_max = ref / max(occupancy * ref, 1e-12)
    cat_units = caps[DIM_ACC] / max(occupancy * capacity_units, 1e-12)
    cat_host = caps[DIM_CPU] / max(host_cores_at_ref / ref, 1e-12)
    return min(hw_max, min(cat_units, cat_host))


def _calibrate_numpy(
    workloads: Sequence[ProgramWorkload],
    *,
    cpu: CpuSpec,
    roofline: RooflineSpec,
    caps: tuple[float, ...],
    host_cores_fraction: float,
    reference_fps: float,
    cpu_mode: str,
) -> list[CalibrationEntry]:
    """Per-entry scalar float64 path, built on the profiler primitives."""
    from .profiler import derive_accelerator_profile

    entries: list[CalibrationEntry] = []
    for w in workloads:
        cpu_source = "analytic"
        if cpu_mode == "measured":
            cpu_prof = _measured_cpu_profile(w, caps, reference_fps)
            if cpu_prof is not None:
                cpu_source = "measured"
        if cpu_source != "measured":
            sec_per_frame = w.flops_per_frame / cpu.flops_per_core
            cpu_prof = ResourceProfile(
                program_id=w.program_id,
                frame_size=w.frame_size,
                device="cpu",
                reference_fps=reference_fps,
                requirement=(sec_per_frame * reference_fps, w.memory_gb, 0.0, 0.0),
                max_fps=caps[DIM_CPU] / sec_per_frame,
            )
        accel_prof = derive_accelerator_profile(
            w.program_id,
            _frame_size(w.frame_size),
            flops_per_frame=w.flops_per_frame,
            bytes_per_frame=w.bytes_per_frame,
            memory_gb=w.memory_gb,
            host_cores_fraction_of_cpu_run=host_cores_fraction,
            cpu_profile=cpu_prof,
            roofline=roofline,
            reference_fps=reference_fps,
        )
        occupancy = roofline.occupancy_per_frame(w.flops_per_frame, w.bytes_per_frame)
        accel_max = _accel_max_fps(
            occupancy, reference_fps, roofline.compute_capacity_units,
            accel_prof.requirement[DIM_CPU], caps,
        )
        cpu_ok = w.memory_gb <= caps[DIM_MEM]
        accel_ok = (
            w.memory_gb <= caps[DIM_ACC_MEM]
            and w.memory_gb * 0.25 <= caps[DIM_MEM]
            and caps[DIM_ACC] > 0.0
        )
        if not cpu_ok and not accel_ok:
            raise ValueError(
                f"workload {w.program_id}: memory {w.memory_gb:.1f} GB fits "
                f"no catalog type (caps {caps})"
            )
        if cpu_ok:
            entries.append(_quantized_entry(w, cpu_prof, cpu_source))
        if accel_ok:
            entries.append(
                _quantized_entry(
                    w,
                    dataclasses.replace(accel_prof, max_fps=accel_max),
                    "derived",
                )
            )
    return entries


def _calibrate_torch(
    workloads: Sequence[ProgramWorkload],
    *,
    cpu: CpuSpec,
    roofline: RooflineSpec,
    caps: tuple[float, ...],
    host_cores_fraction: float,
    reference_fps: float,
    device: "str | torch.device | None" = None,
) -> list[CalibrationEntry]:
    """One vectorized float64 torch evaluation over every workload.

    Evaluates the identical IEEE expression tree as :func:`_calibrate_numpy`,
    on ``device`` (default: the card) — bit-identical results, test-gated.
    Every constant is a float64 tensor of the workloads' shape on the device
    and every quotient is ``torch.div(tensor, tensor)``, so each operation
    rounds once, as the scalar path's does; products keep its left-to-right
    order.
    """
    dev = resolve_device(device)
    f = torch.tensor([w.flops_per_frame for w in workloads], dtype=torch.float64, device=dev)
    b = torch.tensor([w.bytes_per_frame for w in workloads], dtype=torch.float64, device=dev)

    def full(x: float) -> torch.Tensor:
        return torch.full_like(f, x)

    ref = full(reference_fps)
    floor = full(1e-12)
    units = full(roofline.compute_capacity_units)

    sec_per_frame = torch.div(f, full(cpu.flops_per_core))
    cpu_cores = sec_per_frame * ref
    cpu_max = torch.div(full(caps[DIM_CPU]), sec_per_frame)

    occupancy = torch.maximum(
        torch.div(f, full(roofline.peak_flops)), torch.div(b, full(roofline.hbm_bandwidth))
    )
    acc_units = occupancy * ref * units
    # `at_fps(ref)` is an exact multiply-by-1.0, so the host-core draw
    # reduces to the scalar path's cpu_cores * fraction.
    host_cores = cpu_cores * full(host_cores_fraction)
    hw_max = torch.div(ref, torch.maximum(occupancy * ref, floor))
    cat_units = torch.div(full(caps[DIM_ACC]), torch.maximum(occupancy * units, floor))
    cat_host = torch.div(full(caps[DIM_CPU]), torch.maximum(torch.div(host_cores, ref), floor))
    accel_max = torch.minimum(hw_max, torch.minimum(cat_units, cat_host))

    cols = torch.stack((cpu_cores, cpu_max, host_cores, acc_units, accel_max)).cpu().tolist()
    cpu_cores_l, cpu_max_l, host_l, units_l, accel_max_l = cols

    entries: list[CalibrationEntry] = []
    for i, w in enumerate(workloads):
        cpu_ok = w.memory_gb <= caps[DIM_MEM]
        accel_ok = (
            w.memory_gb <= caps[DIM_ACC_MEM]
            and w.memory_gb * 0.25 <= caps[DIM_MEM]
            and caps[DIM_ACC] > 0.0
        )
        if not cpu_ok and not accel_ok:
            raise ValueError(
                f"workload {w.program_id}: memory {w.memory_gb:.1f} GB fits "
                f"no catalog type (caps {caps})"
            )
        if cpu_ok:
            prof = ResourceProfile(
                w.program_id, w.frame_size, "cpu", reference_fps,
                (cpu_cores_l[i], w.memory_gb, 0.0, 0.0),
                cpu_max_l[i],
            )
            entries.append(_quantized_entry(w, prof, "analytic"))
        if accel_ok:
            prof = ResourceProfile(
                w.program_id, w.frame_size, "accel", reference_fps,
                (host_l[i], w.memory_gb * 0.25, units_l[i], w.memory_gb),
                accel_max_l[i],
            )
            entries.append(_quantized_entry(w, prof, "derived"))
    return entries


def _measured_cpu_profile(
    w: ProgramWorkload, caps: tuple[float, ...], reference_fps: float
) -> ResourceProfile | None:
    """Real wall-clock test run, for programs with a runnable ``run_fn``.

    The program runs on the CPU, named explicitly: what is measured is the
    CPU's requirement (paper §3.1.1), whatever device `PROGRAMS` defaults to.
    """
    from ..models.analysis_programs import PROGRAMS, make_frame

    run_fn = PROGRAMS.get(w.program_id)
    if run_fn is None:
        return None
    return measure_cpu_profile(
        w.program_id,
        _frame_size(w.frame_size),
        functools.partial(run_fn, device="cpu"),
        make_frame,
        memory_gb=w.memory_gb,
        reference_fps=reference_fps,
        total_cores=caps[DIM_CPU],
    )


def _quantized_entry(
    w: ProgramWorkload, prof: ResourceProfile, source: str
) -> CalibrationEntry:
    return CalibrationEntry(
        program_id=prof.program_id,
        frame_size=prof.frame_size,
        device=prof.device,
        reference_fps=prof.reference_fps,
        requirement=tuple(_quant(x) for x in prof.requirement),
        max_fps=_quant(prof.max_fps),
        source=source,
        flops_per_frame=_quant(w.flops_per_frame),
        bytes_per_frame=_quant(w.bytes_per_frame),
    )


def _frame_size(fsz: str) -> FrameSize:
    w, h = fsz.split("x")
    return FrameSize(int(w), int(h))


def calibrate(
    catalog: Sequence[BinType],
    workloads: Sequence[ProgramWorkload],
    *,
    cpu: CpuSpec,
    roofline: RooflineSpec = TPU_V5E,
    impl: str = "numpy",
    cpu_mode: str = "analytic",
    host_cores_fraction: float = 0.134,
    reference_fps: float = 0.2,
    device: "str | torch.device | None" = None,
) -> CalibrationArtifact:
    """Run the test-run harness over ``workloads`` against ``catalog``.

    ``device`` is where ``impl="torch"`` evaluates (default: the card);
    ``impl="numpy"`` runs on the host and ignores it.
    """
    if impl not in ("numpy", "torch"):
        raise ValueError(f"impl must be 'numpy' or 'torch', got {impl!r}")
    if cpu_mode not in ("analytic", "measured"):
        raise ValueError(f"cpu_mode must be 'analytic' or 'measured', got {cpu_mode!r}")
    if cpu_mode == "measured" and impl != "numpy":
        raise ValueError("cpu_mode='measured' requires impl='numpy'")
    catalog = tuple(catalog)
    echo = tuple((bt.name, tuple(float(c) for c in bt.capacity)) for bt in catalog)
    caps = _max_caps(echo)
    kwargs = dict(
        cpu=cpu,
        roofline=roofline,
        caps=caps,
        host_cores_fraction=host_cores_fraction,
        reference_fps=reference_fps,
    )
    if impl == "torch":
        entries = _calibrate_torch(workloads, device=device, **kwargs)
    else:
        entries = _calibrate_numpy(workloads, cpu_mode=cpu_mode, **kwargs)
    return CalibrationArtifact(
        version=ARTIFACT_VERSION,
        catalog_signature=catalog_signature(catalog),
        catalog=echo,
        hardware={
            "cpu": cpu.to_dict(),
            "roofline": dataclasses.asdict(roofline),
        },
        provenance={
            "impl": impl,
            "cpu_mode": cpu_mode,
            "host_cores_fraction": host_cores_fraction,
            "reference_fps": reference_fps,
            "workloads": [dataclasses.asdict(w) for w in workloads],
        },
        entries=tuple(entries),
    )


# ---------------------------------------------------------------------------
# The consumption path: calibrated Problems and stream construction
# ---------------------------------------------------------------------------

def requirements_from_calibration(
    artifact: CalibrationArtifact,
    streams: Sequence[StreamSpec],
    *,
    catalog: Sequence[BinType] | None = None,
) -> tuple[Item, ...]:
    """The paper's multiple-choice items for ``streams``, from calibration.

    Every choice's requirement vector comes from a calibrated profile
    scaled by the linear frame-rate model — no hand-written numbers.  When
    ``catalog`` is given the artifact signature is verified first.
    """
    if catalog is not None:
        artifact.verify(catalog)
    table = artifact.profile_table()
    return tuple(table.choices_for(s) for s in streams)


def stream_kinds(
    artifact: CalibrationArtifact,
    n_kinds: int,
    *,
    fps_fractions: Sequence[float] = (0.3, 0.6, 0.85),
    programs: Sequence[str] | None = None,
) -> tuple[tuple[AnalysisProgram, FrameSize, float], ...]:
    """Deterministic (program, frame size, fps) ladder over the artifact.

    Cycles programs and fps fractions co-prime-ish so consecutive kinds
    differ in both; rates are fractions of the calibrated per-program max
    (so every kind is feasible by construction) quantized for readability.
    """
    pids = tuple(programs) if programs is not None else artifact.programs()
    if not pids:
        raise ValueError("artifact has no calibrated programs")
    by_pid = {}
    for e in artifact.entries:
        by_pid.setdefault(e.program_id, e.frame_size)
    kinds = []
    for i in range(n_kinds):
        pid = pids[i % len(pids)]
        frac = fps_fractions[i % len(fps_fractions)]
        fsz = by_pid[pid]
        fps = float(f"{frac * artifact.max_feasible_fps(pid, fsz):.3g}")
        kinds.append((AnalysisProgram(pid, pid), _frame_size(fsz), fps))
    return tuple(kinds)


def stream_mix(
    artifact: CalibrationArtifact,
    n_streams: int,
    *,
    kinds: Sequence[tuple[AnalysisProgram, FrameSize, float]] | None = None,
    n_kinds: int = 10,
    name_prefix: str = "s",
) -> tuple[StreamSpec, ...]:
    """A fixed calibrated fleet: ``n_streams`` specs cycling over ``kinds``.

    This is the `StreamSpec` construction helper of the calibrated path —
    every spec is validated against the artifact, so downstream
    ``choices_for`` can never hit an uncalibrated program or rate.
    """
    kinds = tuple(kinds) if kinds is not None else stream_kinds(artifact, n_kinds)
    specs = []
    for i in range(n_streams):
        prog, fsz, fps = kinds[i % len(kinds)]
        spec = StreamSpec(
            name=f"{name_prefix}{i}", program=prog, desired_fps=fps, frame_size=fsz
        )
        artifact.check_stream(spec)
        specs.append(spec)
    return tuple(specs)


# ---------------------------------------------------------------------------
# Presets + persistence entry points (scripts/torch_recalibrate.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Preset:
    catalog_fn: Callable[[], tuple[BinType, ...]]
    cpu: CpuSpec
    roofline: RooflineSpec
    workloads_fn: Callable[[], tuple[ProgramWorkload, ...]]
    #: host-CPU share of the CPU-run requirement while offloading: the
    #: paper's measured 0.134 for decode+feed of the vision nets on EC2; a
    #: token-feed sliver for the TPU serving stack.
    host_cores_fraction: float = 0.134


def _ec2_workloads() -> tuple[ProgramWorkload, ...]:
    return (vision_workload("vgg16"), vision_workload("zf"))


def _tpu_workloads() -> tuple[ProgramWorkload, ...]:
    # The two paper vision nets plus every model-zoo arch with a
    # frame-analysis deployment default (configs.DEFAULT_TOKENS_PER_FRAME):
    # small models at shallow context are CPU-viable at low rates;
    # deep-context programs are accel compute-bound (the kernel→dollars
    # lever); mid models are HBM-bound.  Archs without a default —
    # grok-1-314b (628 GB bf16 fits no type here), musicgen, yi-34b — are
    # excluded so every workload is feasible somewhere.
    from ..configs import DEFAULT_TOKENS_PER_FRAME

    return (
        vision_workload("vgg16"),
        vision_workload("zf"),
    ) + tuple(
        model_workload(arch, tokens)
        for arch, tokens in sorted(DEFAULT_TOKENS_PER_FRAME.items())
    )


PRESETS: dict[str, _Preset] = {
    "ec2": _Preset(paper_ec2_catalog, EC2_C4_CPU, GRID_K520, _ec2_workloads,
                   host_cores_fraction=0.134),
    # 0.002: the TPU serving stack feeds pre-tokenized frames over an async
    # queue, so the host draw is a sliver of the CPU run — and small enough
    # that accelerator compute (not host cores) is the binding dimension for
    # prefill-bound programs, which is what makes kernel speedups cash out
    # as fewer instances.
    "tpu": _Preset(tpu_cloud_catalog, TPU_HOST_CPU, TPU_V5E, _tpu_workloads,
                   host_cores_fraction=0.002),
}


def preset_workloads(name: str) -> tuple[ProgramWorkload, ...]:
    return PRESETS[name].workloads_fn()


def default_artifact_path(name: str) -> pathlib.Path:
    return _REPO_ROOT / f"CALIBRATION_{name}.json"


def load_or_calibrate(
    name: str,
    *,
    path: str | pathlib.Path | None = None,
    impl: str = "numpy",
    cpu_mode: str = "analytic",
    device: "str | torch.device | None" = None,
) -> CalibrationArtifact:
    """The artifact benchmarks consume: load the persisted one if it is
    fresh for the preset's catalog, else recalibrate in-process (``device``
    as `calibrate`'s).

    Never writes.
    """
    preset = PRESETS[name]
    catalog = preset.catalog_fn()
    p = pathlib.Path(path) if path is not None else default_artifact_path(name)
    if p.exists():
        try:
            artifact = CalibrationArtifact.load(p)
            artifact.verify(catalog)
            return artifact
        except (StaleCalibrationError, ValueError, KeyError):
            pass  # stale or unreadable: fall through to a fresh calibration
    return calibrate(
        catalog,
        preset.workloads_fn(),
        cpu=preset.cpu,
        roofline=preset.roofline,
        impl=impl,
        cpu_mode=cpu_mode,
        host_cores_fraction=preset.host_cores_fraction,
        device=device,
    )
