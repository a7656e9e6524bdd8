"""The port's kernel build table (`repro_torch.kernels._build`), on the CPU.

A library's name carries a hash of its source and of the headers listed
for it in ``SOURCES``, so that an edited header rebuilds every library
that includes it.  A header missing from the list would leave a stale
library in place: this holds the list to the sources' own includes.
"""
import importlib.util
import pathlib
import re

import pytest

from repro_torch.kernels import _build

INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _local_includes(path):
    """The ``csrc/`` headers a file includes, directly or through another."""
    found, todo = set(), [path]
    while todo:
        for name in INCLUDE.findall(todo.pop().read_text()):
            if name not in found:
                found.add(name)
                todo.append(_build.CSRC / name)
    return found


def test_every_source_is_in_the_table():
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def test_the_table_holds_the_port_kernels():
    """The nine sources, flash attention's backward among them, built with
    fused multiply-adds like the forward (no bit-identity with its plain
    version is asked)."""
    assert set(_build.SOURCES) == {
        "knapsack", "flash_attention", "flash_attention_bwd", "decode_attention", "ssd",
        "rglru", "grouped_gemm", "pack", "placement"}
    assert _build.SOURCES["flash_attention_bwd"] == (_build.FMAD_FLAGS, ("attention_common.cuh",))


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_include_is_listed_with_its_source(name):
    """Every ``#include "..."`` of ``csrc/<name>.cu`` (and of the headers it
    includes) is a file under ``csrc/`` listed in the source's entry, and
    nothing else is listed there."""
    includes = _local_includes(_build.CSRC / f"{name}.cu")
    assert all((_build.CSRC / h).is_file() for h in includes)
    assert includes == set(_build.SOURCES[name][1])


# ---- chip_smoke.py's phase 2 check of the ptxas report ---------------------

_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN2wg11flash_wgmmaILi{d}EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg11flash_wgmmaILi{d}EEEv14CUtensorMap_st
    {frame} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN4simt10flash_simtIfLi{d}EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN4simt10flash_simtIfLi{d}EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log(spills_at_256):
    return "".join(_PTXAS_LOG.format(
        d=d, regs=200 + d // 64, frame=8 * bool(s), stores=s, loads=s)
        for d, s in ((64, 0), (128, 0), (256, spills_at_256)))


@pytest.mark.parametrize("spills", [0, 844])
def test_phase_2_fails_on_a_flash_wgmma_spill(monkeypatch, spills):
    """The ptxas report is read per function: registers and spills of each
    ``flash_wgmma`` instantiation; a spill store in any of them fails the
    phase, while the SIMT kernels' spills are not its concern."""
    cs = _chip_smoke()
    report = cs.ptxas_report(_log(spills))
    assert len(report) == 6
    assert report["_ZN2wg11flash_wgmmaILi256EEEv14CUtensorMap_st"] == {
        "registers": 204, "spill_stores": spills, "spill_loads": spills}
    monkeypatch.setitem(_build.BUILD_INFO, "flash_attention",
                        {"seconds": 1.0, "log": _log(spills), "path": ""})
    if spills:
        with pytest.raises(AssertionError, match="flash_wgmma spills"):
            cs.check_flash_wgmma_spills()
    else:
        assert len(cs.check_flash_wgmma_spills()) == 3
