"""Build csrc/grid_chain.cu, csrc/kron_pair.cu, csrc/banded_apply.cu,
csrc/time_solve.cu and csrc/level_pair.cu for the CPU, for the tests.

The kernels' C sources are compiled by g++ against small stand-ins for
cuda_runtime.h and cuda_bf16.h: a launch runs the grid's blocks one after
another, each block's threads (x fastest, then y, then z) as std::threads
meeting at a std::barrier for __syncthreads(); cp.async becomes a plain
copy (one off its size's alignment makes the launch fail, as on the card)
and shared memory starts out as NaN, so that a read of an element nobody
wrote shows.  This checks the kernels' indexing,
tiling and synchronisation on the CPU; speed, and what only nvcc accepts,
show on the card alone (tests/test_torch_kernels_cuda.py).
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "stfem_tpu_torch" / "csrc"

_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
inline thread_local unsigned char* g_smem;
inline thread_local std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
struct double2 { double x, y; };
inline double2 make_double2(double a, double b) { return {a, b}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorMisalignedAddress = 716 };
inline std::atomic<bool> g_misaligned{false};   // a cp.async off alignment
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  return g_misaligned.exchange(false) ? cudaErrorMisalignedAddress : cudaSuccess;
}
template <class F>
void emu_launch(unsigned grid, dim3 block, size_t smem, F f) {
  const unsigned threads = block.x * block.y * block.z;
  blockDim = {block.x, block.y, block.z};
  gridDim = {grid, 1, 1};
  std::vector<float> sm((smem + 64) / 4, std::nanf(""));
  for (unsigned b = 0; b < grid; ++b) {
    std::fill(sm.begin(), sm.end(), std::nanf(""));
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx = {b};
        threadIdx = {t % block.x, t / block.x % block.y,
                     t / (block.x * block.y)};
        g_smem = reinterpret_cast<unsigned char*>(sm.data());
        g_bar = &bar;
        f();
      });
    for (auto& th : ts) th.join();
  }
}
"""

_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
"""


def _emulable(src: str) -> str:
    """A kernel source with its device-only pieces replaced."""
    src = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                 r"unsigned char* \1 = g_smem;", src)
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    src = re.sub(r"(void cp_async(\d+)\((?:\w+)\* smem, "
                 r"const (?:\w+)\* gmem\)) \{.*?\n\}",
                 r"\1 { if ((reinterpret_cast<size_t>(smem) | "
                 r"reinterpret_cast<size_t>(gmem)) % \2) g_misaligned = true; "
                 r"std::memcpy(smem, gmem, \2); }", src, flags=re.S)
    src = "\n".join(";" if 'asm volatile("cp.async.' in line
                    and "_group" in line else line
                    for line in src.split("\n"))
    # kernel<<<grid, threads, smem, stream>>>(args);
    return re.sub(r"([\w<>, ]+?)<<<(.*?)>>>\((.*?)\);",
                  lambda m: "emu_launch({}, [&] {{ {}({}); }});".format(
                      m.group(2).rsplit(",", 1)[0], m.group(1).strip(),
                      m.group(3)), src, flags=re.S)


def build(out_dir: Path) -> ctypes.CDLL | None:
    """The emulated kernels as a shared library (None without a C++20
    g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(_RUNTIME)
    (out_dir / "cuda_bf16.h").write_text(_BF16)
    srcs = []
    for name in ("grid_chain", "kron_pair", "banded_apply", "time_solve",
                 "level_pair"):
        path = out_dir / f"{name}.cpp"
        path.write_text(_emulable((CSRC / f"{name}.cu").read_text()))
        srcs.append(str(path))
    lib = out_dir / "libemulated.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-Wno-unknown-pragmas", "-I", str(out_dir),
                        "-o", str(lib)] + srcs, capture_output=True,
                       text=True)
    if r.returncode != 0:
        if "barrier" in r.stderr and "No such file" in r.stderr:
            return None
        raise RuntimeError("g++ failed on the emulated kernels:\n"
                           + r.stderr[-4000:])
    return ctypes.CDLL(str(lib))
