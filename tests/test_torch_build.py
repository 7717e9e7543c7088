"""The port's kernel build helpers on the CPU: library names keyed by the
source, the headers and the flags, and the ptxas report that
`chip_smoke.py` prints and gates on."""
from repro_torch.kernels import build
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_S3_PKfS3_PS1_PfiiifiifE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_S3_PKfS3_PS1_PfiiifiifE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13ce_fwd_kernelPKfPKiPfS3_S3_ii' for 'sm_90a'
ptxas info    : Function properties for _Z13ce_fwd_kernelPKfPKiPfS3_S3_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""


def test_library_name_follows_source_headers_and_flags(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "t.cuh").write_text("// header\n")
    first = build._target("k")
    assert first == build._target("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    (tmp_path / "t.cuh").write_text("// header, edited\n")
    edited = build._target("k")
    assert edited != first
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-G"))
    assert build._target("k") not in (first, edited)


def test_ptxas_report_names_kernels_with_template_arguments():
    assert build.ptxas_report(PTXAS) == [
        ("flash_bwd_dq_kernel<128,64>", 168, 8, 12),
        ("ce_fwd_kernel", 40, 0, 0)]
