"""The compile profiler of cylon_tpu_torch (``telemetry.profiler``, the
CUDA counterpart of cylon_tpu's XLA cost capture) on the CPU:

* the same scripted ``_record`` calls give both packages the same
  records, summary, histogram series and cost counters;
* ``enable``/``disable``/``reset`` and the counted_cache build hook;
* the hook on a kernel-library handle: one record a library, named by
  the library, its nvcc seconds and its ptxas resources read from the
  build's log, the handle passed on unchanged; a missing log or one
  without kernel lines raises;
* the parser on a report that ``nvcc -Xptxas -v`` printed on the card.
A load of a real library is a ``gpu`` test (tests/test_torch_port_gpu.py).
"""
import types

import pytest

from cylon_tpu import telemetry as jtel
from cylon_tpu.telemetry import profiler as jprof

import cylon_tpu_torch as tct
from cylon_tpu_torch import telemetry as ttel
from cylon_tpu_torch.telemetry import metrics as tmetrics
from cylon_tpu_torch.telemetry import profiler as tprof

# the reports nvcc -Xptxas -v wrote for csrc/partition.cu and
# csrc/join_stream.cu (_build/<name>.log; NVIDIA H100 80GB HBM3, nvcc
# 12.9, chip_smoke.py phase 1)
PTXAS_LOG = """\
ptxas info    : 30 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b24partition_scatter_kernelEPKiNS_4LegsEiPjS1_ixiiS3_PyS4_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b24partition_scatter_kernelEPKiNS_4LegsEiPjS1_ixiiS3_PyS4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 39208 bytes smem
ptxas info    : Compile time = 83.772 ms
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b21partition_hist_kernelEPKiPixii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b21partition_hist_kernelEPKiPixii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 1280 bytes smem
ptxas info    : Compile time = 30.535 ms
"""
PTXAS_JOIN_LOG = """\
ptxas info    : 30 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__ab1ec4f4_14_join_stream_cu_3b2fb43b11join_expandEPKiPKjixS3_ixixiPjS4_S4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__ab1ec4f4_14_join_stream_cu_3b2fb43b11join_expandEPKiPKjixS3_ixixiPjS4_S4_S4_
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size, 8196 bytes smem
ptxas info    : Compile time = 320.077 ms
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__ab1ec4f4_14_join_stream_cu_3b2fb43b11plan_streamEPKjS1_S1_NS_5Ptrs8EiS2_iiixiixxPjN8lookback9ScanStateES3_S3_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__ab1ec4f4_14_join_stream_cu_3b2fb43b11plan_streamEPKjS1_S1_NS_5Ptrs8EiS2_iiixiixxPjN8lookback9ScanStateES3_S3_Pi
    152 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 152 bytes cumulative stack size, 45600 bytes smem
ptxas info    : Compile time = 299.538 ms
"""
PTXAS_KERNELS = {
    "_ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b24partition_scatter"
    "_kernelEPKiNS_4LegsEiPjS1_ixiiS3_PyS4_": {
        "registers": 78, "smem_bytes": 39208, "spill_bytes": 0},
    "_ZN45_GLOBAL__N__1be2f35d_12_partition_cu_3b2fb43b21partition_hist"
    "_kernelEPKiPixii": {
        "registers": 32, "smem_bytes": 1280, "spill_bytes": 0},
}

SCRIPT = [("_prof_probe_a", 0.5, 1000.0, 4096.0),
          ("_prof_probe_a", 1.25, None, None),
          ("_prof_probe_b", 0.02, None, 64.0),
          ("_prof_probe_b", 0.0, 7.0, None)]


@pytest.fixture(autouse=True)
def _clean():
    for p in (jprof, tprof):
        p.disable()
        p.reset()
    yield
    for p in (jprof, tprof):
        p.disable()
        p.reset()


def _series(tel):
    return {k: v for k, v in tel.metrics_snapshot().items()
            if "_prof_probe_" in k}


def test_scripted_records_equal_reference():
    before = [_series(tel) for tel in (jtel, ttel)]
    for p in (jprof, tprof):
        for rec in SCRIPT:
            p._record(*rec)
    assert tprof.records() == jprof.records()
    assert len(tprof.records()) == len(SCRIPT)
    assert tprof.summary() == jprof.summary()
    s = tprof.summary()
    assert s["_prof_probe_a"]["programs"] == 2
    assert s["_prof_probe_a"]["compile_s"] == 1.75
    assert s["_prof_probe_b"]["flops"] == 7.0
    after = [_series(tel) for tel in (jtel, ttel)]
    assert after[0] == after[1]
    assert before[0] == before[1]
    key = 'cylon_kernel_compile_seconds{factory="_prof_probe_a"}'
    assert after[1][key]["count"] - before[1].get(key, {"count": 0})[
        "count"] == 2
    assert tprof.COMPILE_SECONDS_BUCKETS == jprof.COMPILE_SECONDS_BUCKETS


def test_enable_disable_reset():
    assert not tprof.enabled()
    tprof.enable()
    assert tprof.enabled()
    assert tmetrics._factory_build_hook is tprof._build_hook
    tprof._record("_prof_probe_c", 0.1, None, None)
    assert len(tprof.records()) == 1
    tprof.reset()
    assert tprof.records() == []
    tprof.disable()
    assert not tprof.enabled()
    assert tmetrics._factory_build_hook is None
    assert ttel.profiler is tprof


def _handle(tmp_path, name, seconds, text):
    log = tmp_path / f"{name}.log"
    if text is not None:
        log.write_text(text)
    return types.SimpleNamespace(cylon_library=name, cylon_build_s=seconds,
                                 cylon_build_log=str(log))


def test_build_hook_records_a_library(tmp_path):
    """Through counted_cache, as ``kernels.load_library`` is built: one
    record a library, the loader's handle returned as it came."""
    lib = _handle(tmp_path, "_prof_probe_lib", 11.5, PTXAS_LOG)

    @tmetrics.counted_cache
    def _prof_probe_loader(name):
        return lib

    tprof.enable()
    assert _prof_probe_loader("x") is lib
    assert _prof_probe_loader("x") is lib          # memoized: no record
    tprof.disable()
    assert tprof.records() == [{
        "factory": "_prof_probe_lib", "compile_s": 11.5, "flops": None,
        "bytes_accessed": None, "kernels": PTXAS_KERNELS}]
    s = tprof.summary()["_prof_probe_lib"]
    assert s["programs"] == 1 and s["kernels"] == PTXAS_KERNELS
    snap = ttel.metrics_snapshot()
    assert snap['cylon_kernel_compile_seconds{factory="_prof_probe_lib"}'][
        "count"] == 1
    assert not any(k.startswith("cylon_kernel_compile_flops_total")
                   and "_prof_probe_lib" in k for k in snap)


def test_build_hook_passes_other_objects_and_idles_when_disabled(tmp_path):
    plain = object()
    tprof.enable()
    assert tprof._build_hook("f", plain) is plain
    tprof.disable()
    lib = _handle(tmp_path, "_prof_probe_off", 1.0, PTXAS_LOG)
    assert tprof._build_hook("load_library", lib) is lib
    assert tprof.records() == []


def test_missing_or_unparseable_log_raises(tmp_path):
    tprof.enable()
    with pytest.raises(tct.CylonError, match="unreadable"):
        tprof._build_hook("load_library",
                          _handle(tmp_path, "_prof_probe_nolog", 0.0, None))
    with pytest.raises(tct.CylonError, match="no kernel resources"):
        tprof._build_hook("load_library", _handle(
            tmp_path, "_prof_probe_empty", 0.0,
            "ptxas info    : 0 bytes gmem\nnvcc warning : something\n"))
    assert tprof.records() == []


def test_ptxas_parser():
    assert tprof.parse_ptxas(PTXAS_LOG) == PTXAS_KERNELS
    # spill bytes are the stores plus the loads
    k = tprof.parse_ptxas(PTXAS_JOIN_LOG)
    assert sorted((v["registers"], v["smem_bytes"], v["spill_bytes"])
                  for v in k.values()) == [(64, 45600, 16), (80, 8196, 16)]
    assert all("join_stream" in name for name in k)
    # a report line without shared memory means none
    no_smem = "\n".join([
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1kv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 8 registers, used 0 barriers"])
    assert tprof.parse_ptxas(no_smem) == {
        "_Z1kv": {"registers": 8, "smem_bytes": 0, "spill_bytes": 0}}
    with pytest.raises(tct.CylonError):
        tprof.parse_ptxas("")
