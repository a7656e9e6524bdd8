"""Parity of the port's calibration (`repro_torch.core.calibration`) with the
JAX package's, and its determinism, persistence and staleness contracts.

Everything here is exact.  Calibration is float64 host arithmetic (numpy
scalars) or one vectorized float64 torch evaluation of the same IEEE
expression tree, so:

- the port's analytic artifacts save to text byte-identical to the
  committed ``CALIBRATION_ec2.json`` and ``CALIBRATION_tpu.json`` (which
  the reference wrote) and equal the reference's `to_dict()`;
- ``impl="torch"`` equals ``_calibrate_numpy`` bit for bit, also with the
  6-digit quantization switched off, where a division rounded twice (a
  scalar over a tensor is a reciprocal times the scalar) would show;
- the calibrated allocations equal the reference's plans value for value.

The reference's numpy/jax bit-identity tests fail on this tree (its jax
path needs ``jax.experimental.enable_x64``), so the port is held against
``_calibrate_numpy`` only.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core.catalog import paper_ec2_catalog as ref_ec2_catalog
from repro.core.catalog import tpu_cloud_catalog as ref_tpu_catalog
from repro.core.manager import ResourceManager as RefManager
from repro.core.streams import AnalysisProgram as RefProgram
from repro.core.streams import StreamSpec as RefStream

from repro_torch.core import calibration as cal
from repro_torch.core.binpack.problem import BinType
from repro_torch.core.catalog import paper_ec2_catalog, tpu_cloud_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import DIM_ACC, DIM_ACC_MEM, DIM_CPU, DIM_MEM
from repro_torch.core.streams import AnalysisProgram, StreamSpec
from repro_torch.interop import plan_to_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRESET_NAMES = sorted(cal.PRESETS)
#: `benchmarks/calibration.py`'s TPU-cloud mix: (program, fps, count).
MIX = (
    ("vgg16", 0.2, 12),
    ("zf", 5.0, 8),
    ("internlm2-1.8b", 0.05, 10),
    ("gemma2-2b", 4.0, 8),
    ("llava-next-mistral-7b", 1.5, 6),
    ("mamba2-1.3b", 0.4, 6),
)
N_RANDOM = 256


def _kwargs(name: str) -> dict:
    preset = cal.PRESETS[name]
    return dict(cpu=preset.cpu, roofline=preset.roofline,
                host_cores_fraction=preset.host_cores_fraction)


def _calibrate(name: str, workloads=None, **overrides) -> cal.CalibrationArtifact:
    preset = cal.PRESETS[name]
    workloads = preset.workloads_fn() if workloads is None else workloads
    return cal.calibrate(preset.catalog_fn(), workloads, **{**_kwargs(name), **overrides})


def _ref_calibrate(name: str, **overrides) -> ref_cal.CalibrationArtifact:
    preset = ref_cal.PRESETS[name]
    return ref_cal.calibrate(
        preset.catalog_fn(), preset.workloads_fn(),
        cpu=preset.cpu, roofline=preset.roofline,
        host_cores_fraction=preset.host_cores_fraction, **overrides)


def _caps(name: str) -> tuple[float, ...]:
    catalog = cal.PRESETS[name].catalog_fn()
    return cal._max_caps((bt.name, tuple(float(c) for c in bt.capacity)) for bt in catalog)


def random_workloads(name: str, n: int, seed: int) -> tuple[cal.ProgramWorkload, ...]:
    """FLOPs and bytes log-uniform over 1e3-1e16, memory inside the preset
    catalog's largest capacity (so each fits some type)."""
    caps = _caps(name)
    rng = np.random.RandomState(seed)
    mem_cap = max(caps[DIM_MEM], caps[DIM_ACC_MEM])
    return tuple(
        cal.ProgramWorkload(
            f"w{i}",
            float(10.0 ** rng.uniform(3, 16)),
            float(10.0 ** rng.uniform(3, 16)),
            float(rng.uniform(1e-3, mem_cap)),
        )
        for i in range(n)
    )


# ---------------------------------------------------------------------------
# The committed artifacts and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESET_NAMES)
def test_analytic_artifact_saves_byte_identical_to_the_committed_one(name, tmp_path):
    art = _calibrate(name)
    out = tmp_path / f"CALIBRATION_{name}.json"
    art.save(out)
    assert out.read_bytes() == cal.default_artifact_path(name).read_bytes()
    assert cal.default_artifact_path(name) == ROOT / f"CALIBRATION_{name}.json"
    assert art.to_dict() == _ref_calibrate(name).to_dict()
    assert cal.CalibrationArtifact.load(cal.default_artifact_path(name)) == art


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_preset_workloads_equal_the_reference(name):
    port = cal.preset_workloads(name)
    ref = ref_cal.preset_workloads(name)
    assert [dataclasses.asdict(w) for w in port] == [dataclasses.asdict(w) for w in ref]
    preset, ref_preset = cal.PRESETS[name], ref_cal.PRESETS[name]
    assert preset.cpu.to_dict() == ref_preset.cpu.to_dict()
    assert dataclasses.asdict(preset.roofline) == dataclasses.asdict(ref_preset.roofline)
    assert preset.host_cores_fraction == ref_preset.host_cores_fraction


def test_cpu_specs_equal_the_reference():
    for port, ref in ((cal.EC2_C4_CPU, ref_cal.EC2_C4_CPU),
                      (cal.TPU_HOST_CPU, ref_cal.TPU_HOST_CPU)):
        assert port.to_dict() == ref.to_dict()
        assert cal.CpuSpec.from_dict(port.to_dict()) == port


def test_repeated_calibration_is_bit_identical():
    assert _calibrate("ec2") == _calibrate("ec2")


# ---------------------------------------------------------------------------
# The torch path against the numpy path, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "raw"])
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_torch_path_equals_numpy_on_the_presets(name, quantized, monkeypatch):
    if not quantized:
        monkeypatch.setattr(cal, "_quant", float)
    np_art = _calibrate(name, impl="numpy")
    th_art = _calibrate(name, impl="torch", device="cpu")
    assert th_art.entries == np_art.entries
    assert th_art.provenance["impl"] == "torch"
    assert {**th_art.provenance, "impl": "numpy"} == np_art.provenance


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "raw"])
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_torch_path_equals_numpy_on_random_workloads(name, quantized, monkeypatch):
    if not quantized:
        monkeypatch.setattr(cal, "_quant", float)
    workloads = random_workloads(name, N_RANDOM, seed=len(name))
    np_art = _calibrate(name, workloads, impl="numpy")
    th_art = _calibrate(name, workloads, impl="torch", device="cpu")
    assert len(np_art.entries) >= N_RANDOM
    assert th_art.entries == np_art.entries


def test_a_scalar_over_a_tensor_rounds_twice():
    """Why the torch path builds every operand as a tensor: on this
    workload set ``python_float / tensor`` (the preset's host-core cap over
    FLOPs) differs from the scalar path's division somewhere,
    ``torch.div(tensor, tensor)`` nowhere."""
    cap = _caps("tpu")[DIM_CPU]
    workloads = random_workloads("tpu", N_RANDOM, seed=3)
    f = torch.tensor([w.flops_per_frame for w in workloads], dtype=torch.float64)
    want = [cap / x for x in f.tolist()]
    assert torch.div(torch.full_like(f, cap), f).tolist() == want
    assert (cap / f).tolist() != want


@pytest.mark.parametrize("impl", ["numpy", "torch"])
def test_a_workload_that_fits_no_type_raises(impl):
    caps = _caps("ec2")
    huge = cal.ProgramWorkload("huge", 1e9, 1e9, 4.0 * max(caps) + 1.0)
    with pytest.raises(ValueError, match="fits no catalog type"):
        _calibrate("ec2", (huge,), impl=impl, device="cpu")


def test_calibrate_checks_its_arguments():
    with pytest.raises(ValueError, match="impl must be"):
        _calibrate("ec2", impl="jax")
    with pytest.raises(ValueError, match="cpu_mode must be"):
        _calibrate("ec2", cpu_mode="guessed")
    with pytest.raises(ValueError, match="requires impl='numpy'"):
        _calibrate("ec2", impl="torch", cpu_mode="measured", device="cpu")


def test_torch_path_needs_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _calibrate("ec2", impl="torch")
    # The numpy path runs on the host and takes no device.
    assert _calibrate("ec2", impl="numpy").entries == _calibrate("ec2").entries


# ---------------------------------------------------------------------------
# Persistence and staleness
# ---------------------------------------------------------------------------

def test_json_round_trip_is_unchanged(tmp_path):
    art = _calibrate("ec2")
    p = tmp_path / "cal.json"
    art.save(p)
    assert cal.CalibrationArtifact.load(p) == art
    p2 = tmp_path / "cal2.json"
    cal.CalibrationArtifact.load(p).save(p2)
    assert p.read_text() == p2.read_text()


def test_from_dict_rejects_unknown_version():
    d = _calibrate("ec2").to_dict()
    d["version"] = 999
    with pytest.raises(ValueError, match="version"):
        cal.CalibrationArtifact.from_dict(d)


def _grown_catalog() -> tuple[BinType, ...]:
    catalog = paper_ec2_catalog()
    first = catalog[0]
    caps = tuple(c * 2 for c in first.capacity)
    return (dataclasses.replace(first, capacity=caps),) + tuple(catalog[1:])


def test_stale_catalog_signature_is_rejected():
    art = _calibrate("ec2")
    art.verify(paper_ec2_catalog())  # fresh: no raise
    with pytest.raises(cal.StaleCalibrationError, match="recalibrate"):
        art.verify(_grown_catalog())


def test_manager_refuses_a_stale_artifact():
    art = _calibrate("ec2")
    with pytest.raises(cal.StaleCalibrationError):
        ResourceManager(_grown_catalog(), calibration=art, device="cpu")
    manager = ResourceManager(paper_ec2_catalog(), calibration=art, device="cpu")
    with pytest.raises(cal.StaleCalibrationError):
        ResourceManager(_grown_catalog(), manager.profiles, device="cpu").set_calibration(art)
    with pytest.raises(cal.StaleCalibrationError):
        cal.requirements_from_calibration(
            art, cal.stream_mix(art, 2, n_kinds=2), catalog=_grown_catalog())


def test_manager_takes_profiles_or_calibration_not_both():
    art = _calibrate("ec2")
    with pytest.raises(ValueError, match="not both"):
        ResourceManager(paper_ec2_catalog(), art.profile_table(), calibration=art,
                        device="cpu")
    with pytest.raises(ValueError, match="needs profiles or calibration"):
        ResourceManager(paper_ec2_catalog(), device="cpu")


def test_price_drift_does_not_stale_the_artifact():
    art = _calibrate("ec2")
    catalog = paper_ec2_catalog()
    repriced = (dataclasses.replace(catalog[0], cost=99.0),) + tuple(catalog[1:])
    art.verify(repriced)  # no raise


def test_load_or_calibrate_loads_fresh_and_recalibrates_stale(tmp_path):
    for name in PRESET_NAMES:
        assert cal.load_or_calibrate(name) == cal.CalibrationArtifact.load(
            cal.default_artifact_path(name))
    # An artifact of another catalog is stale for the preset: recalibrated
    # in-process, nothing written.
    stale = tmp_path / "stale.json"
    _calibrate("ec2").save(stale)
    before = stale.read_bytes()
    art = cal.load_or_calibrate("tpu", path=stale)
    assert art == _calibrate("tpu")
    assert stale.read_bytes() == before
    broken = tmp_path / "broken.json"
    broken.write_text("{}")
    assert cal.load_or_calibrate("ec2", path=broken) == _calibrate("ec2")
    via_torch = cal.load_or_calibrate("ec2", path=tmp_path / "missing.json",
                                      impl="torch", device="cpu")
    assert via_torch.entries == _calibrate("ec2").entries


# ---------------------------------------------------------------------------
# Consumption: items, kinds, mixes and the speedup transform
# ---------------------------------------------------------------------------

def _plain_items(items) -> list:
    return [(it.name, [(c.label, tuple(c.requirement)) for c in it.choices]) for it in items]


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_streams_and_items_equal_the_reference(name):
    art = cal.load_or_calibrate(name)
    ref_art = ref_cal.load_or_calibrate(name)
    kinds = cal.stream_kinds(art, 7)
    ref_kinds = ref_cal.stream_kinds(ref_art, 7)
    assert [(p.name, p.program_id, str(f), fps) for p, f, fps in kinds] == [
        (p.name, p.program_id, str(f), fps) for p, f, fps in ref_kinds]
    streams = cal.stream_mix(art, 23, n_kinds=7)
    ref_streams = ref_cal.stream_mix(ref_art, 23, n_kinds=7)
    assert [(s.name, s.program.program_id, s.desired_fps, str(s.frame_size))
            for s in streams] == [
        (s.name, s.program.program_id, s.desired_fps, str(s.frame_size))
        for s in ref_streams]
    catalog = cal.PRESETS[name].catalog_fn()
    items = cal.requirements_from_calibration(art, streams, catalog=catalog)
    ref_items = ref_cal.requirements_from_calibration(
        ref_art, ref_streams, catalog=ref_cal.PRESETS[name].catalog_fn())
    assert _plain_items(items) == _plain_items(ref_items)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_accelerator_speedup_equals_the_reference(name):
    art = cal.load_or_calibrate(name).with_accelerator_speedup(2.0)
    ref_art = ref_cal.load_or_calibrate(name).with_accelerator_speedup(2.0)
    assert art.to_dict() == ref_art.to_dict()
    with pytest.raises(ValueError, match="speedup factor"):
        art.with_accelerator_speedup(0.0)


def test_accelerator_speedup_halves_compute_not_memory():
    art = cal.load_or_calibrate("tpu")
    fast = art.with_accelerator_speedup(2.0)
    by_key = {(e.program_id, e.device): e for e in art.entries}
    sped = {(e.program_id, e.device): e for e in fast.entries}
    assert set(by_key) == set(sped)
    compute_bound_seen = 0
    for key, e in by_key.items():
        f = sped[key]
        if e.device == "cpu":
            assert f == e
            continue
        assert f.requirement[DIM_MEM] == e.requirement[DIM_MEM]
        assert f.requirement[DIM_ACC_MEM] == e.requirement[DIM_ACC_MEM]
        assert f.requirement[DIM_CPU] == e.requirement[DIM_CPU]
        assert f.requirement[DIM_ACC] == pytest.approx(e.requirement[DIM_ACC] / 2.0, rel=1e-5)
        if f.max_fps > e.max_fps:
            compute_bound_seen += 1
    assert compute_bound_seen > 0
    assert fast.provenance["accelerator_speedup"] == 2.0
    assert fast.with_accelerator_speedup(2.0).provenance["accelerator_speedup"] == 4.0


def test_calibrated_items_scale_linearly_with_fps():
    table = _calibrate("ec2").profile_table()
    lo = table.choices_for(StreamSpec("a", AnalysisProgram("zf", "zf"), 0.5))
    hi = table.choices_for(StreamSpec("b", AnalysisProgram("zf", "zf"), 1.0))
    for c_lo, c_hi in zip(lo.choices, hi.choices, strict=True):
        assert c_lo.label == c_hi.label
        for dim in (DIM_CPU, DIM_ACC):
            assert c_hi.requirement[dim] == pytest.approx(2.0 * c_lo.requirement[dim])
        for dim in (DIM_MEM, DIM_ACC_MEM):
            assert c_hi.requirement[dim] == c_lo.requirement[dim]


def test_stream_mix_rejects_uncalibrated_rates():
    art = _calibrate("ec2")
    zf_max = art.max_feasible_fps("zf", "640x480")
    assert zf_max > 0.0
    with pytest.raises(ValueError, match="exceeds the calibrated max"):
        art.check_stream(StreamSpec("hot", AnalysisProgram("zf", "zf"), zf_max * 2.0))
    with pytest.raises(ValueError, match="no calibration entry"):
        art.check_stream(StreamSpec("who", AnalysisProgram("nope", "nope"), 0.1))


# ---------------------------------------------------------------------------
# The manager on calibrated vectors
# ---------------------------------------------------------------------------

def test_set_calibration_swaps_profiles_and_clears_the_memo():
    art = _calibrate("ec2")
    manager = ResourceManager(paper_ec2_catalog(), calibration=art, device="cpu")
    assert manager.calibration is art
    streams = [StreamSpec("z", AnalysisProgram("zf", "zf"), 5.0)]
    before = manager.formulate(streams)
    assert manager.formulate(streams) is before  # memoized
    fast = art.with_accelerator_speedup(2.0)
    manager.set_calibration(fast)
    assert manager.calibration is fast
    assert not manager._formulate_cache
    after = manager.formulate(streams)
    assert after is not before
    accel = {c.label: c.requirement for c in after.items[0].choices}["accel"]
    old = {c.label: c.requirement for c in before.items[0].choices}["accel"]
    assert accel[DIM_ACC] == pytest.approx(old[DIM_ACC] / 2.0, rel=1e-5)


def _assert_same_plan(plan, ref_plan):
    a, b = plan_to_plain(plan), plan_to_plain(ref_plan)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def _ec2_fleet(program_cls, stream_cls):
    return ([stream_cls(f"v{i}", program_cls("vgg16", "vgg16"), 0.2) for i in range(20)]
            + [stream_cls(f"z{i}", program_cls("zf", "zf"), 5.0) for i in range(20)])


def _mix_fleet(program_cls, stream_cls):
    return [stream_cls(f"{pid[:5]}{i}", program_cls(pid, pid), fps)
            for pid, fps, n in MIX for i in range(n)]


@pytest.mark.parametrize("name", ["ec2", "tpu"])
def test_calibrated_allocation_equals_the_reference(name):
    """The paper's scenario on calibrated vectors (ec2: 20 VGG-16 at 0.2
    FPS, 20 ZF at 5 FPS) and the 50-stream TPU-cloud mix, both through
    branch-and-price, priced with the plain DP on the CPU."""
    catalog, ref_catalog, fleet = {
        "ec2": (paper_ec2_catalog, ref_ec2_catalog, _ec2_fleet),
        "tpu": (tpu_cloud_catalog, ref_tpu_catalog, _mix_fleet),
    }[name]
    art = cal.load_or_calibrate(name)
    manager = ResourceManager(catalog(), calibration=art, solver="colgen", device="cpu")
    streams = fleet(AnalysisProgram, StreamSpec)
    for s in streams:
        art.check_stream(s)
    plan = manager.allocate(streams)
    plan.solution.validate()
    ref_plan = RefManager(ref_catalog(), calibration=ref_cal.load_or_calibrate(name),
                          solver="colgen").allocate(fleet(RefProgram, RefStream))
    _assert_same_plan(plan, ref_plan)
    expected = {"ec2": (3.9, {"g2.2xlarge": 6}, True),
                "tpu": (12.87, {"v5e-4": 1, "v5e-8": 1}, False)}[name]
    assert plan.hourly_cost == pytest.approx(expected[0], abs=1e-9)
    assert plan.instance_counts() == expected[1]
    assert plan.optimal is expected[2]


def test_measured_cpu_mode_runs_the_real_programs():
    art = _calibrate("ec2", cpu_mode="measured")
    cpu_sources = {e.program_id: e.source for e in art.entries if e.device == "cpu"}
    assert cpu_sources == {"vgg16": "measured", "zf": "measured"}
    for e in art.entries:
        if e.device == "cpu":
            assert e.requirement[DIM_CPU] > 0.0
            assert e.max_fps > 0.0
    assert art.provenance["cpu_mode"] == "measured"


# ---------------------------------------------------------------------------
# scripts/torch_recalibrate.py
# ---------------------------------------------------------------------------

def _run_script(*args, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_recalibrate.py"), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_recalibrate_check_reports_fresh_and_writes_nothing(tmp_path):
    committed = {p.name: p.read_bytes() for p in ROOT.glob("CALIBRATION_*.json")}
    assert set(committed) == {f"CALIBRATION_{n}.json" for n in PRESET_NAMES}
    listing = sorted(os.listdir(ROOT))
    for args in (("--check",), ("--check", "--impl", "torch", "--device", "cpu")):
        proc = _run_script(*args, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr
        for name in PRESET_NAMES:
            assert f"CALIBRATION_{name}.json: fresh" in proc.stdout
    assert not list(tmp_path.iterdir())
    assert sorted(os.listdir(ROOT)) == listing
    assert {p.name: p.read_bytes() for p in ROOT.glob("CALIBRATION_*.json")} == committed


def test_recalibrate_writes_only_under_out(tmp_path):
    proc = _run_script(cwd=tmp_path)
    assert proc.returncode != 0 and "--out" in proc.stderr
    proc = _run_script("--out", str(ROOT), cwd=tmp_path)
    assert proc.returncode != 0 and "read only" in proc.stderr
    out = tmp_path / "out"
    proc = _run_script("--out", str(out), "ec2", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in out.iterdir()) == ["CALIBRATION_ec2.json"]
    assert (out / "CALIBRATION_ec2.json").read_bytes() == (
        ROOT / "CALIBRATION_ec2.json").read_bytes()
