"""`scripts/torch_profile_wave.py`'s split of a traced wave, on a made-up
Chrome trace (the script itself needs the card)."""
import importlib.util
import pathlib

import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_profile_wave.py"


@pytest.fixture(scope="module")
def tpw():
    spec = importlib.util.spec_from_file_location("torch_profile_wave", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_split_counts_the_card_busy_once_and_clips_to_the_wave(tpw):
    trace = {"traceEvents": [
        _x("user_annotation", "prefill wave 2", 1000.0, 1000.0),
        _x("kernel", "void wg::flash_wgmma<128>(CUtensorMap_st)", 1100.0, 200.0),
        _x("kernel", "grouped_gemm_wgmma(CUtensorMap_st)", 1200.0, 300.0),  # overlaps
        _x("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 1900.0, 400.0),  # clipped
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1600.0, 50.0),
        _x("kernel", "void at::native::elementwise_kernel", 500.0, 100.0),  # before
        _x("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 1590.0, 70.0),
        _x("cuda_runtime", "cudaStreamSynchronize", 2500.0, 10.0),  # after
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1500.0},
    ]}
    got = tpw.split_trace(trace, "prefill wave 2")
    # 1100-1500 (two kernels), 1600-1650 (copy), 1900-2000 (clipped)
    assert got["device_busy_ms"] == pytest.approx(0.55)
    assert got["wave_ms"] == pytest.approx(1.0)
    assert got["device_idle_share"] == pytest.approx(0.45)
    assert got["device_ms_by_group"] == pytest.approx({
        "flash attention": 0.2, "grouped GEMM": 0.3, "library GEMM": 0.1, "the rest": 0.05})
    assert got["device_ops"] == 4 and got["host_launch_calls"] == 1
    assert got["host_wait_ms"] == pytest.approx(0.07)
    assert got["host_waits"] == {"cudaMemcpyAsync": 1}


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_kernel<__nv_bfloat16, 128>(...)", "flash attention"),
    ("void (anonymous namespace)::simt::flash_simt<float, 256>(...)", "flash attention"),
    ("(anonymous namespace)::grouped_gemm_simt<float>(...)", "grouped GEMM"),
    ("void gemv2N_kernel<int, int, float, float>(...)", "library GEMM"),
    ("void (anonymous namespace)::split_kernel<__nv_bfloat16, 256>(...)", "the rest"),
])
def test_kernel_groups(tpw, name, group):
    assert tpw._group(name) == group
