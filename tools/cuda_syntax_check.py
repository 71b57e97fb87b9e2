#!/usr/bin/env python3
"""Check the port's CUDA sources with g++ -fsyntax-only, on a machine
without nvcc.

Usage, from the root of a checkout:  python3 tools/cuda_syntax_check.py

Each ``src/repro_torch/csrc/*.cu`` is copied into a temporary directory
with its CUDA headers replaced by the stand-in declarations below
(qualifiers, ``__grid_constant__`` included, thread indices, the runtime
calls the sources make, ``cudaLaunchKernelEx`` and its launch attributes,
``cudaFuncGetAttributes``, the driver entry point through which the host
reaches ``cuTensorMapEncodeTiled``, ``CUtensorMap`` and its encoding's
enums from ``cuda.h``, the device intrinsics, bf16, and
cooperative_groups' cluster), the ``<<<...>>>`` launch rewritten as a
call, and every inline ``asm`` statement (mma, wgmma and its fence,
commit and wait, setmaxnreg, cvt, cp.async, the bulk and TMA tensor
copies, mbarrier, the proxy fence) replaced by an expression that reads
its inputs and assigns its outputs.  g++ then parses every template instance the C entry points reach.
This catches C++ syntax and type errors; it cannot check PTX, register
constraints or anything nvcc alone refuses, which only the card's build
shows.  Exits non-zero if g++ reports an error.
"""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__
#define __grid_constant__
#define CUDART_VERSION 12080
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int);
cudaError_t cudaGetDevice(int*);
cudaError_t cudaGetLastError();
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(E...), A&&...);
struct cudaFuncAttributes { int numRegs; };
template <class T> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, T);
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDriverEntryPointByVersion(const char*, void**, unsigned, unsigned long long,
                                             cudaDriverEntryPointQueryResult*);
typedef unsigned cuuint32_t;
typedef unsigned long long cuuint64_t;
enum CUresult { CUDA_SUCCESS = 0 };
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_DATA_TYPE_FLOAT32 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
long long clock64();
void __trap();
void __syncwarp(unsigned = 0xffffffffu);
void __syncthreads();
int __popc(unsigned);
int __clz(unsigned);
unsigned __umulhi(unsigned, unsigned);
template <class T> T __ldg(const T*);
size_t __cvta_generic_to_shared(const void*);
float __uint_as_float(unsigned);
unsigned __float_as_uint(float);
float tanhf(float); float fmaxf(float, float); float fminf(float, float); float rintf(float);
using std::max; using std::min;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
float2 make_float2(float, float);
float4 make_float4(float, float, float, float);
int4 make_int4(int, int, int, int);
float __fmul_rn(float, float); float __fadd_rn(float, float); float __fdiv_rn(float, float);
float __int2float_rn(int);
struct __nv_bfloat16 { unsigned short v; };
float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16(float);
namespace cooperative_groups {
struct cluster_group {
  void sync();
  template <class T> T* map_shared_rank(T*, unsigned);
  unsigned block_rank();
};
cluster_group this_cluster();
}  // namespace cooperative_groups
"""

_OPERAND = r'"([=+]?)[a-z]+"\s*\(([^()]*(?:\([^()]*\))*[^()]*)\)'


def _replace_asm(src: str) -> str:
    """Every ``asm [volatile](...)`` statement as an expression that reads
    its input operands and assigns its outputs."""
    out, i = [], 0
    pat = re.compile(r"\basm\s*(?:volatile\s*)?\(")
    while True:
        m = pat.search(src, i)
        if m is None:
            out.append(src[i:])
            return "".join(out)
        out.append(src[i:m.start()])
        k, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[k], 0)
            k += 1
        parts = []
        for mode, expr in re.findall(_OPERAND, src[m.end():k - 1]):
            parts.append(f"({expr}) = {{}}" if mode else f"(void)({expr})")
        out.append("(" + (", ".join(parts) or "0") + ")")
        i = k


def check(path: pathlib.Path, tmp: pathlib.Path) -> int:
    src = path.read_text()
    for header in ("cuda.h", "cuda_runtime.h", "cuda_bf16.h",
                   "cooperative_groups.h"):
        src = src.replace(f"#include <{header}>", "#include \"cuda_stub.h\"")
    src = re.sub(r"(\w+)<<<[^>]*>>>\(", r"\1(", src)
    cpp = tmp / (path.stem + ".cpp")
    cpp.write_text(_replace_asm(src))
    res = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only", "-Wall", "-Wno-unknown-pragmas",
         "-Wno-unused-parameter", "-Wno-sign-compare", "-Wno-unused-value",
         "-I", str(tmp), str(cpp)], capture_output=True, text=True)
    print(f"{path.name}: {'ok' if res.returncode == 0 else 'FAILED'}")
    sys.stdout.write(res.stderr)
    return res.returncode


def main() -> int:
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        (tmp / "cuda_stub.h").write_text(STUB)
        return max(check(p, tmp) for p in sorted(CSRC.glob("*.cu")))


if __name__ == "__main__":
    sys.exit(main())
