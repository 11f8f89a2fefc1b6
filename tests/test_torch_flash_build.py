"""The build helpers around flash_attn, on the CPU: the committed
wgmma_ops.cuh is what gen_wgmma.py writes, the headers that the kernels
include are part of the build's digest, and the parsers of the compiler's
report and of cuobjdump's SASS read what those tools print."""
import importlib.util

from repro_torch.kernels import build


def test_wgmma_header_matches_its_generator():
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", build.CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (build.CSRC / "wgmma_ops.cuh").read_text() == gen.render()


def test_included_headers_are_in_the_digest():
    for src in build.SOURCES.values():
        for line in (build.CSRC / src).read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in build.HEADERS, (src, line)


PTXAS = """\
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 204 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0450*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0460*/   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR8], R24 ;
\t\tFunction : _Z3barPf
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], RZ ;
"""


def test_ptxas_entries_reads_registers_and_spills():
    assert build.ptxas_entries(PTXAS) == {
        "_Z3fooPf": {"spill_stores": 0, "spill_loads": 0, "registers": 204},
        "_Z3barPf": {"spill_stores": 16, "spill_loads": 24,
                     "registers": 255}}


def test_sass_counts_per_function():
    assert build.sass_counts(SASS, "HGMMA") == {"_Z3fooPf": 2,
                                                "_Z3barPf": 0}
    assert build.sass_counts(SASS, "IGMMA") == {"_Z3fooPf": 0,
                                                "_Z3barPf": 1}
