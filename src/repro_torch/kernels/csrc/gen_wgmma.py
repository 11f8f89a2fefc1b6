"""Write wgmma_ops.cuh: the `wgmma.mma_async` instructions that
flash_attn.cu, flash_attn_bwd.cu, ring_matmul.cu, secure_matmul.cu, ssd.cu
and ssd_bwd.cu issue, one inline-PTX function per
(operand source, type, N). Each names every accumulator register of the
m64nN tile (N / 2 a thread: floats, or s32 for the u8 products), which
no preprocessor loop can spell out, hence this generator. Run it after changing the set below:

    python src/repro_torch/kernels/csrc/gen_wgmma.py

The output is committed; tests/test_torch_flash_build.py checks that it
matches this script.
"""
from __future__ import annotations

from pathlib import Path

NS = (8, 16, 32, 64, 128, 256)
OUT = Path(__file__).resolve().parent / "wgmma_ops.cuh"

# name: (k, accumulator type, operand type, A from registers?, the
# immediates after scale-d: scale-a, scale-b and the transposes, which the
# integer forms do not take)
FORMS = {
    # A and B K-major in shared memory: S = Q K^T
    "ss_bf16": (16, "f32", "bf16", False, "1, 1, 0, 0"),
    # A (P) in registers, B in shared memory MN-major (imm-trans-b 1):
    # O += P V with V's rows along N
    "rs_bf16_bmn": (16, "f32", "bf16", True, "1, 1, 1"),
    # A and B both MN-major in shared memory (imm-trans-a 1, imm-trans-b
    # 1): ssd's state update S^T += B^T (decayed X), B's and X's rows
    # along K
    "ss_bf16_tt": (16, "f32", "bf16", False, "1, 1, 1, 1"),
    # A K-major, B MN-major in shared memory (imm-trans-b 1): ssd's
    # backward X dS and dY S0, the state's rows (P) along K
    "ss_bf16_bmn": (16, "f32", "bf16", False, "1, 1, 0, 1"),
    # tf32 takes K-major operands only
    "ss_tf32": (8, "f32", "tf32", False, "1, 1"),
    "rs_tf32": (8, "f32", "tf32", True, "1, 1"),
    # unsigned bytes (ring_matmul's limbs), A in registers, B K-major:
    # exact s32 sums, wrapping (no .satfinite)
    "rs_u8": (32, "s32", "u8", True, None),
}


def _regs(first: int, count: int) -> str:
    return ", ".join(f"%{i}" for i in range(first, first + count))


def _function(name: str, n: int) -> str:
    k, acc, ty, a_regs, imm = FORMS[name]
    nd = n // 2
    c_type, con = ("float", "f") if acc == "f32" else ("uint32_t", "r")
    tail = f", {imm}" if imm else ""
    if a_regs:
        a_param, a_op, a_in = "const uint32_t (&a)[4]", \
            "{" + _regs(nd, 4) + "}", ", ".join(f'"r"(a[{j}])'
                                               for j in range(4))
    else:
        a_param, a_op, a_in = "uint64_t a", f"%{nd}", '"l"(a)'
    b = nd + (4 if a_regs else 1)
    outs = ",\n        ".join(
        ", ".join(f'"+{con}"(d[{j}])' for j in range(i, min(i + 4, nd)))
        for i in range(0, nd, 4))
    return (
        f"__device__ __forceinline__ void {name}({c_type} (&d)[{nd}], "
        f"{a_param},\n"
        f"    uint64_t b, int scale_d) {{\n"
        f"  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{b + 1}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{acc}.{ty}.{ty} "\n'
        f'      "{{{_regs(0, nd)}}}, "\n'
        f'      "{a_op}, %{b}, p{tail};\\n}}\\n"\n'
        f"      : {outs}\n"
        f"      : {a_in}, \"l\"(b), \"r\"(scale_d));\n"
        f"}}\n")


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py; do not edit. The wgmma.mma_async "
        "forms that\n"
        "// flash_attn*.cu and ssd*.cu issue, m64nNk16 bf16 and m64nNk8 tf32 "
        "into float32\n"
        "// accumulators, and that ring_matmul.cu issues, m64nNk32 u8 into "
        "s32\n"
        "// accumulators: d (N / 2 a thread), A from a shared-memory "
        "descriptor\n"
        "// (ss_*) or four registers (rs_*), B from a descriptor; scale_d 0 "
        "overwrites d.\n",
        "#pragma once\n\n#include <stdint.h>\n\nnamespace hopper {\n",
        "template <int N>\nstruct Wgmma;\n"]
    for n in NS:
        body = "\n".join(
            "  " + "\n  ".join(("static " + _function(name, n)).splitlines())
            for name in FORMS)
        parts.append(f"template <>\nstruct Wgmma<{n}> {{\n{body}\n}};\n")
    parts.append("}  // namespace hopper\n")
    return "\n".join(parts)


if __name__ == "__main__":
    OUT.write_text(render())
    print(f"wrote {OUT}")
