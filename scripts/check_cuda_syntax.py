#!/usr/bin/env python3
"""Syntax-check the port's CUDA sources where there is no nvcc.

    python3 scripts/check_cuda_syntax.py

Each ``automerge_tpu_torch/csrc/*.cu`` is compiled by ``g++ -std=c++17
-fsyntax-only`` as C++, its launches (``<<<...>>>``) stripped, against a
small header that declares CUDA's builtins (below). It finds undefined
names, wrong argument counts and type errors before a run on the card;
it knows nothing of device semantics, so only ``nvcc`` on the card
proves a source. Prints each file's first errors; exits 1 if any file
has one.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "automerge_tpu_torch" / "csrc"

SHIM = r"""// syntax-check shim: just enough of CUDA for g++ -fsyntax-only
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct int2 { int x, y; }; struct int4 { int x, y, z, w; }; struct uint4 { unsigned x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
cudaError_t cudaGetLastError(); const char* cudaGetErrorString(cudaError_t);
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int);
cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t);
unsigned __ballot_sync(unsigned, int); unsigned __activemask(); int __popc(unsigned); int __ffs(int); int __clz(int);
template <class T> T __shfl_sync(unsigned, T, int, int = 32); template <class T> T __shfl_up_sync(unsigned, T, unsigned, int = 32);
template <class T> T __shfl_down_sync(unsigned, T, unsigned, int = 32); template <class T> T __shfl_xor_sync(unsigned, T, int, int = 32);
template <class T> unsigned __match_any_sync(unsigned, T); int __reduce_add_sync(unsigned, int); unsigned __reduce_add_sync(unsigned, unsigned);
void __syncthreads(); int __syncthreads_or(int); int __syncthreads_and(int); int __syncthreads_count(int); void __syncwarp(unsigned = 0xffffffffu); void __threadfence();
template <class T> T atomicAdd(T*, T); template <class T> T atomicMax(T*, T); template <class T> T atomicMin(T*, T); template <class T> T atomicCAS(T*, T, T); template <class T> T atomicExch(T*, T); template <class T> T atomicOr(T*, T);
long long clock64(); template <class T> T __ldg(const T*); template <class T> T min(T, T); template <class T> T max(T, T);
inline int min(int a, int b) { return a < b ? a : b; } inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; } inline long long max(long long a, long long b) { return a > b ? a : b; }
unsigned long long __double2ull_rz(double); int __float_as_int(float);
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization };
union cudaLaunchAttributeValue { int programmaticStreamSerializationAllowed; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t { dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
template <class... E, class... A> cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(E...), A&&...);
"""


def main() -> int:
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "cuda_runtime.h").write_text(SHIM)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, tmp)
        for src in sorted(CSRC.glob("*.cu")):
            text = re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S)
            cpp = Path(tmp, src.name + ".cpp")
            cpp.write_text(text)
            r = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w", "-I", tmp,
                                "-x", "c++", str(cpp)], capture_output=True, text=True)
            errors = [ln for ln in r.stderr.splitlines() if "error" in ln]
            if errors:
                bad = 1
                print(f"{src.name}:", *errors[:5], sep="\n  ")
    print("csrc: no syntax errors" if not bad else "csrc: syntax errors")
    return bad


if __name__ == "__main__":
    sys.exit(main())
