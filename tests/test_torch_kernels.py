"""The port's kernel build plumbing (relayrl_tpu_torch._kernels), the
SASS and ptxas readers of chip_smoke.py and the bf16 kernels they must
cover, and the host side of the flash backward kernels, on the CPU.

No test here needs a GPU or the CUDA toolkit: the library name is a hash
of files, the SASS and ptxas readers parse text, the bf16 kernels are
read from the sources, and the backward's prescaled q and its alignment
rule are plain tensor code.
"""

import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from relayrl_tpu.ops.flash import _prescale_q as jax_prescale_q
from relayrl_tpu_torch import _kernels
from relayrl_tpu_torch.ops.flash import KERNEL_HEAD_DIMS, _rows_aligned, prescale_q

# What `cuobjdump -sass` prints for a library: one section per function.
SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

	code for sm_90a
		Function : _ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi32EEEvNS_7BwdArgsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*2530*/                   HMMA.16816.F32.BF16 R120, R4.reuse, R116, RZ ;
        /*2540*/                   HMMA.16816.F32.BF16 R116, R4, R118, RZ ;
        /*2550*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
		..........

		Function : _ZN12_GLOBAL__N_119flash_dq_f32_kernelILi32EEEvNS_7BwdArgsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   FFMA R3, R4, R5, R3 ;
		..........

		Function : _ZN12_GLOBAL__N_126ring_chunk_fwd_bf16_kernelILi16EEEvNS_7FwdArgsE
        /*0f10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
		..........

		Function : _ZN12_GLOBAL__N_125ring_chunk_dq_bf16_kernelILi32EEEvNS_7BwdArgsE
        /*1a20*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*1a30*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
		..........

		Function : _ZN12_GLOBAL__N_126ring_chunk_dkv_bf16_kernelILi64EEEvNS_7BwdArgsE
        /*2b40*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
		..........

		Function : _ZN12_GLOBAL__N_125ring_chunk_dq_f32_kernelILi64EEEvNS_7BwdArgsE
        /*0000*/                   FFMA R3, R4, R5, R3 ;
		..........
"""

# What `nvcc -Xptxas=-v` prints for two entry functions.
PTXAS = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 102 registers, used 1 barriers, 20480 bytes smem
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 0 bytes smem
"""


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """``_kernels`` pointed at a copy of the sources and an empty build
    directory."""
    src = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, src)
    monkeypatch.setattr(_kernels, "CSRC", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edited,rebuilds", [
    ("flash_bwd.cu", True),       # the source itself
    ("tensor_core.cuh", True),    # a header it shares
    ("new.cuh", True),            # a header added to csrc/
    ("ring_flash.cu", False),     # another source
])
def test_library_path_follows_sources_and_headers(csrc_copy, edited, rebuilds):
    before = _kernels.library_path("flash_bwd")
    path = csrc_copy / edited
    path.write_text((path.read_text() if path.exists() else "") + "\n// edited\n")
    after = _kernels.library_path("flash_bwd")
    assert (after != before) == rebuilds
    assert after.parent == _kernels.BUILD_DIR and after.suffix == ".so"


def test_build_log_is_read_beside_the_library(csrc_copy, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_LOGS", {})
    log = _kernels.library_path("flash_bwd").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(PTXAS)
    assert chip_smoke.build_log("flash_bwd") == PTXAS
    _kernels.BUILD_LOGS["flash_bwd"] = "this process's log"
    assert chip_smoke.build_log("flash_bwd") == "this process's log"


def test_sass_needs_cuobjdump_beside_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(tmp_path / "bin" / "nvcc"))
    with pytest.raises(RuntimeError, match="cuobjdump"):
        chip_smoke.sass("flash_bwd")


def test_count_sass_counts_tensor_core_products_per_function():
    counts = chip_smoke.count_tensor_core_ops(SASS)
    assert counts == {
        "_ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi32EEEvNS_7BwdArgsE": 3,
        "_ZN12_GLOBAL__N_119flash_dq_f32_kernelILi32EEEvNS_7BwdArgsE": 0,
        "_ZN12_GLOBAL__N_126ring_chunk_fwd_bf16_kernelILi16EEEvNS_7FwdArgsE": 1,
        "_ZN12_GLOBAL__N_125ring_chunk_dq_bf16_kernelILi32EEEvNS_7BwdArgsE": 2,
        "_ZN12_GLOBAL__N_126ring_chunk_dkv_bf16_kernelILi64EEEvNS_7BwdArgsE": 1,
        "_ZN12_GLOBAL__N_125ring_chunk_dq_f32_kernelILi64EEEvNS_7BwdArgsE": 0,
    }
    # What check_tensor_cores reads from each name: the ring_flash pattern
    # takes the three bf16 ring kernels with their head dims, and no f32 one.
    pattern = dict((lib, p) for lib, p, _ in chip_smoke.TENSOR_CORE_KERNELS)["ring_flash"]
    found = [m.groups() for m in map(lambda fn: re.search(pattern, fn), counts) if m]
    assert found == [("ring_chunk_fwd", "16"), ("ring_chunk_dq", "32"),
                     ("ring_chunk_dkv", "64")]


def _bf16_kernels() -> list[tuple[str, str]]:
    """(source stem, kernel name) of every ``__global__`` bf16 kernel
    template in ``csrc/*.cu``."""
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+_bf16_kernel)\s*\(")
    return sorted((path.stem, name) for path in _kernels.CSRC.glob("*.cu")
                  for name in decl.findall(path.read_text()))


def test_bf16_kernel_templates_are_found_in_the_sources():
    assert {name for _, name in _bf16_kernels()} >= {
        f"{k}_bf16_kernel" for k in ("flash_fwd", "flash_dq", "flash_dkv", "ring_chunk_fwd",
                                     "ring_chunk_dq", "ring_chunk_dkv")}


@pytest.mark.parametrize("source,kernel", _bf16_kernels())
def test_every_bf16_kernel_is_covered_by_the_tensor_core_check(source, kernel):
    """chip_smoke.check_tensor_cores finds a bf16 kernel's instantiations in
    the SASS of its library by the library's pattern and requires one per
    head dim: a bf16 kernel that no pattern matches would escape the HMMA
    and spill check."""
    entries = [(p, names) for lib, p, names in chip_smoke.TENSOR_CORE_KERNELS if lib == source]
    assert len(entries) == 1, f"no TENSOR_CORE_KERNELS entry for {source}"
    pattern, names = entries[0]
    for d in KERNEL_HEAD_DIMS:
        mangled = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{d}EEEvNS_7BwdArgsE"
        m = re.search(pattern, mangled)
        assert m is not None and m.groups() == (kernel.removesuffix("_bf16_kernel"), str(d))
        assert m.group(1) in names


def test_ptxas_spills_per_function():
    assert chip_smoke.ptxas_spills(PTXAS) == {"_Z3fooPf": (0, 0), "_Z3barPf": (4, 12)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prescale_matches_jax(dtype):
    """The backward's prescaled q, bit for bit the JAX package's
    ``_prescale_q``, from a strided view of a fused projection."""
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    qkv = np.random.default_rng(0).standard_normal((2, 9, 3, 2, 16)).astype(np.float32) * 3
    q = torch.from_numpy(qkv).to(torch_dtype).unbind(2)[0]
    got = prescale_q(q)
    want = jax_prescale_q(jnp.asarray(qkv[:, :, 0]).astype(getattr(jnp, dtype)))
    assert got.dtype == torch_dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_rows_aligned_is_the_16_byte_copy_rule():
    qkv = torch.zeros((2, 5, 3, 4, 16), dtype=torch.bfloat16)
    assert all(_rows_aligned(x) for x in qkv.unbind(2))      # the model's views
    flat = torch.zeros(2 * 5 * 4 * 16 + 1, dtype=torch.bfloat16)
    assert not _rows_aligned(flat[1:].view(2, 5, 4, 16))     # data off by 2 bytes
    wide = torch.zeros((2, 5, 4, 20), dtype=torch.bfloat16)
    assert not _rows_aligned(wide[..., :16])                 # 40-byte rows
    assert _rows_aligned(torch.zeros((2, 5, 4, 16), dtype=torch.float32))
