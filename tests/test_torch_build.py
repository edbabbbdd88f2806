"""What the port's kernel build reports, read on the CPU: the ``ptxas -v``
report and ``cuobjdump -sass`` listings that ``chip_smoke.py`` turns into
registers, spills and tensor-core instruction counts.  The texts below
have the tools' own format (CUDA 12); no compiler runs here."""
import pytest

from repro_torch.kernels import cuda_lib

PTXAS = """\
== flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5repro2tc27flash_attention_bf16_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro2tc27flash_attention_bf16_kernelEPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5repro22flash_attention_kernelIfLi128EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro22flash_attention_kernelIfLi128EEEvPKT_
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem, 528 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN5repro2tc27flash_attention_bf16_kernelEPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a10*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0a20*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
        /*0a30*/              @!P0 HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
        /*0a40*/                   FFMA R3, R2, R5, R3 ;
\t\tFunction : _ZN5repro22flash_attention_kernelIfLi128EEEvPKT_
        /*0000*/                   FFMA R3, R2, R5, R3 ;
        /*0010*/               @P1 FFMA R4, R2, R5, R4 ;
        /*0020*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    usage = cuda_lib.ptxas_usage(PTXAS)
    bf16 = "_ZN5repro2tc27flash_attention_bf16_kernelEPK13__nv_bfloat16"
    f32 = "_ZN5repro22flash_attention_kernelIfLi128EEEvPKT_"
    assert set(usage) == {bf16, f32}          # the helper is no kernel
    assert usage[bf16] == {"registers": 168, "spill_stores": 0,
                           "spill_loads": 0}
    assert usage[f32] == {"registers": 255, "spill_stores": 12,
                          "spill_loads": 16, "static_smem_bytes": 4096}


@pytest.mark.parametrize("needle,want", [
    ("flash_attention_bf16_kernel", {"HMMA": 2, "FFMA": 1, "LDSM": 1}),
    ("flash_attention_kernel", {"HMMA": 1, "FFMA": 2, "LDSM": 0}),
    ("softmax", {"HMMA": 0, "FFMA": 0, "LDSM": 0}),
])
def test_sass_opcodes_counts_one_function(needle, want):
    assert cuda_lib.sass_opcodes(SASS, needle, want) == want
