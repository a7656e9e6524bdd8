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
    ("void (anonymous namespace)::flash_bwd_dkdv<__nv_bfloat16, 128>(...)", "flash backward"),
    ("void (anonymous namespace)::wg::flash_bwd_dq_wgmma<256>(CUtensorMap_st, ...)",
     "flash backward"),
    ("(anonymous namespace)::grouped_gemm_simt<float>(...)", "grouped GEMM"),
    ("void (anonymous namespace)::grouped_gemm_bwd_dx<__nv_bfloat16>(...)",
     "grouped GEMM backward"),
    ("void (anonymous namespace)::grouped_gemm_bwd_dw<float>(...)", "grouped GEMM backward"),
    ("void (anonymous namespace)::grouped_gemm_bwd_dx_wgmma(CUtensorMap_st, ...)",
     "grouped GEMM backward"),
    ("void (anonymous namespace)::grouped_gemm_bwd_dw_wgmma(CUtensorMap_st, ...)",
     "grouped GEMM backward"),
    ("void (anonymous namespace)::simt::grouped_gemm_bwd_dw_simt<float>(...)",
     "grouped GEMM backward"),
    ("void gemv2N_kernel<int, int, float, float>(...)", "library GEMM"),
    ("void (anonymous namespace)::split_kernel<__nv_bfloat16, 256>(...)", "the rest"),
])
def test_kernel_groups(tpw, name, group):
    assert tpw._group(name) == group


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::tc::decode_mma<256, 1>(...)", "flash-decode"),
    ("void (anonymous namespace)::decode_combine<__nv_bfloat16>(...)", "flash-decode"),
    ("void (anonymous namespace)::simt::decode_simt<float, 128>(...)", "flash-decode"),
    ("void (anonymous namespace)::tc::ssd_cb<128, 128>(...)", "SSD scan"),
    ("void (anonymous namespace)::tc::ssd_mma<64, 128, 128>(...)", "SSD scan"),
    ("void (anonymous namespace)::ssd_kernel<__nv_bfloat16, 64, 128, 128>(...)", "SSD scan"),
    ("void (anonymous namespace)::tc::ssd_bwd_mma<64, 128, 128>(...)", "SSD backward"),
    ("void (anonymous namespace)::simt::ssd_bwd_simt<64, 128, 128>(...)", "SSD backward"),
    ("void (anonymous namespace)::ssd_bwd_reduce<__nv_bfloat16>(...)", "SSD backward"),
    ("void (anonymous namespace)::tc::ssd_bwd_walk_mma<64, 128, 128>(...)", "SSD backward"),
    ("void (anonymous namespace)::tc::ssd_bwd_grads_wgmma<64, 128, 128>(...)", "SSD backward"),
    ("void (anonymous namespace)::ssd_bwd_finish<128>(...)", "SSD backward"),
    ("void (anonymous namespace)::ssd_bwd_reduce<float>(...)", "SSD backward"),
    ("void (anonymous namespace)::rglru_tma<128>(CUtensorMap_st, ...)", "RG-LRU scan"),
    ("void (anonymous namespace)::rglru_cp_async<64>(...)", "RG-LRU scan"),
    ("void (anonymous namespace)::rglru_bwd_cp_async<64>(...)", "RG-LRU backward"),
    ("void (anonymous namespace)::rglru_bwd_walk<64>(...)", "RG-LRU backward"),
    ("void (anonymous namespace)::rglru_bwd_split(CUtensorMap_st, ...)", "RG-LRU backward"),
])
def test_decode_and_scan_kernel_groups(tpw, name, group):
    """The redesigned kernels' names, and the SSD kernels' names in earlier
    commits (the scan's ``ssd_kernel``, the backward's ``ssd_bwd_mma``,
    ``ssd_bwd_simt`` and ``ssd_bwd_reduce``; the RG-LRU backward's
    ``rglru_bwd_cp_async``), so that a parent checkout's wave groups its
    scans alike."""
    assert tpw._group(name) == group


def test_split_of_a_decode_step(tpw):
    """``--decode`` traces a step annotated ``decode step 5``; the split
    reads it as it reads a wave, and other steps stay outside."""
    trace = {"traceEvents": [
        _x("user_annotation", "decode step 4", 0.0, 500.0),
        _x("kernel", "void tc::decode_mma<256, 1>(...)", 100.0, 50.0),  # the step before
        _x("user_annotation", "decode step 5", 1000.0, 400.0),
        _x("kernel", "void tc::decode_mma<256, 1>(...)", 1100.0, 20.0),
        _x("kernel", "void decode_combine<__nv_bfloat16>(...)", 1120.0, 5.0),
        _x("kernel", "void at::native::elementwise_kernel", 1200.0, 25.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1030.0, 5.0),
        _x("cuda_runtime", "cudaStreamSynchronize", 1300.0, 90.0),
    ]}
    got = tpw.split_trace(trace, "decode step 5")
    assert got["wave_ms"] == pytest.approx(0.4)
    assert got["device_busy_ms"] == pytest.approx(0.05)
    assert got["device_idle_share"] == pytest.approx(0.875)
    assert got["device_ms_by_group"] == pytest.approx({"flash-decode": 0.025, "the rest": 0.025})
    assert got["host_launch_calls"] == 2
    assert got["host_wait_ms"] == pytest.approx(0.09)


@pytest.mark.parametrize("argv", [[], ["--arch", "gemma2-2b", "--decode"],
                                  ["--arch", "mamba2-1.3b", "--label", "parent"]])
def test_options_parse_and_the_cpu_is_refused(tpw, argv, capsys):
    """``--arch`` and ``--decode`` parse; without a card the script prints
    no result and fails."""
    if tpw.torch.cuda.is_available():
        pytest.skip("has a card")
    assert tpw.main(argv) == 1
    assert capsys.readouterr().out == ""


def test_an_unknown_arch_is_refused(tpw):
    with pytest.raises(SystemExit):
        tpw.main(["--arch", "no-such-model"])
