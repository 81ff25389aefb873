"""The port's kernel build reports and its wrappers' pointer checks, on the
CPU: no nvcc or card is needed (the parsers read text; the checks raise
before any launch).

chip_smoke.py gates on what these parsers return (each flash library's
registers, spills and HMMA count per kernel instance), so they are held
here to a ptxas report and a SASS listing written out by hand in the
tools' formats.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as tfa  # noqa: E402

FWD = ("_ZN4dl4j12_GLOBAL__N_119flash_fwd_tc_kernelI13__nv_bfloat16Li64EEEvPKT_"
       "S5_S5_PS3_PfS7_iifiii")
DKDV = ("_ZN4dl4j12_GLOBAL__N_124flash_bwd_dkdv_tc_kernelI6__halfLi128EEEvPKT_"
        "S5_S5_S5_PKfS7_S7_PS3_S8_iifiii")

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '{DKDV}' for 'sm_90a'
ptxas info    : Function properties for {DKDV}
    24 bytes stack frame, 28 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 424 bytes cmem[0]
"""

SASS = f"""
Fatbin elf code:
================
\tcode for sm_90a
\t\tFunction : {FWD}
        /*0440*/                   LDSM.16.M88.4 R24, [R2] ;
        /*0450*/                   HMMA.16816.F32.BF16 R8, R12, R24, R8 ;
        /*0460*/                   HMMA.16816.F32.BF16 R4, R12, R26, R4 ;
        /*0470*/                   MUFU.EX2 R3, R3 ;
\t\tFunction : {DKDV}
        /*0100*/                   FFMA R1, R2, R3, R4 ;
        /*0110*/                   HGMMA.64x64x16.F32 gdesc[UR4], RZ, !UPT ;
"""


def _by_kernel(report, kernel):
    (name,) = [n for n in report if kernel in n]
    return report[name]


def test_parse_ptxas_reads_each_instance():
    stats = _build.parse_ptxas(PTXAS)
    assert len(stats) == 2
    assert _by_kernel(stats, "flash_fwd_tc_kernel") == dict(
        registers=128, stack_frame=0, spill_stores=0, spill_loads=0)
    assert _by_kernel(stats, "flash_bwd_dkdv_tc_kernel") == dict(
        registers=255, stack_frame=24, spill_stores=28, spill_loads=44)


def test_count_mma_counts_tensor_core_instructions_per_instance():
    counts = _build.count_mma(SASS)
    assert _by_kernel(counts, "flash_fwd_tc_kernel") == 2
    assert _by_kernel(counts, "flash_bwd_dkdv_tc_kernel") == 1
    assert _build.count_mma("no function here\n  HMMA.16816 R0 ;") == {}


def test_check_aligned_refuses_an_odd_offset():
    flat = torch.zeros(64 + 1, dtype=torch.bfloat16)
    tfa._check_aligned("flash_fwd", flat[:64])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_aligned("flash_fwd", flat[1:])


@pytest.mark.parametrize("dtype,offset,refused", [
    (torch.float16, 1, True),      # 2 bytes past a 16-byte boundary
    (torch.float16, 8, False),     # 16 bytes: cp.async takes it
    (torch.float32, 1, False),     # the SIMT kernels use no cp.async
    (torch.float32, 3, False),
])
def test_check_aligned_holds_only_the_half_precision_inputs(dtype, offset,
                                                            refused):
    flat = torch.zeros(64 + 8, dtype=dtype)
    view = flat[offset:offset + 64]
    if refused:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._check_aligned("flash_bwd", flat[:64], view)
    else:
        tfa._check_aligned("flash_bwd", flat[:64], view)
