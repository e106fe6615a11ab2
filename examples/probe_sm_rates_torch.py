#!/usr/bin/env python3
"""Per-SM rates on the card that the top-2 matchers (K1, K4) run into: fp32
FMAs from registers, and 16-byte shared-memory loads (LDS.128) by the
pattern of addresses a warp reads.  K1 and K4 feed their FMAs and
population counts from shared memory; how many of these loads an SM
retires per clock, for the patterns their register tiles produce, sets how
many FMAs each load has to feed.

    python examples/probe_sm_rates_torch.py

Patterns (one 16-byte load per lane; rows of 17 float4, i.e. 68 floats, so
distinct rows at one column fall in disjoint bank groups):
  broadcast   every lane of the warp reads the same address
  4 rows      lanes 8q..8q+7 read row q (one address per quarter-warp)
  8 rows      lane l reads row l % 8 (8 addresses, repeated in each quarter)
  32 rows     lane l reads row l (32 addresses, no bank conflict)

Prints, per pattern, warp-wide loads per SM per clock at the SM clock that
`nvidia-smi` reports during the run, and the bytes per clock that implies;
then fp32 FMAs, and separate multiplies and adds (as kernels built with
``--fmad=false`` issue them), per SM per clock for 32 independent
accumulators a thread (no memory operand), against the 128 lanes of an SM.
Builds with nvcc into build/probe/ and needs one CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

SRC = r"""
#include <cuda_runtime.h>
extern "C" __global__ void lds(float* out, int mode, int iters) {
  __shared__ float4 s[17 * 32 + 64];
  for (int i = threadIdx.x; i < 17 * 32 + 64; i += blockDim.x)
    s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int row = 0;
  if (mode == 1) row = lane >> 3;
  if (mode == 2) row = lane & 7;
  if (mode == 3) row = lane;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s + row * 17));
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int i = 0; i < iters; i += 4) {
    // one 16-byte load each (ld.volatile: kept whole although only .x is
    // used), and one add, so that the loads and not the adds are the limit;
    // a column offset common to all lanes keeps the pattern's banks
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
                   : "r"(base + 16u * ((i + u) & 15)));
    a0 += v[0].x; a1 += v[1].x; a2 += v[2].x; a3 += v[3].x;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (a0 + a1) + (a2 + a3);
}
extern "C" __global__ void fma_rate(float* out, float x, int iters) {
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = threadIdx.x + j;
  const float y = x * 0.5f;
  for (int i = 0; i < iters; i += 2) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = fmaf(acc[j], x, y);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = fmaf(acc[j], y, x);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// separate fp32 multiplies and adds (__fmul_rn / __fadd_rn are never
// contracted into FMAs), as the kernels built with --fmad=false issue them
extern "C" __global__ void mul_add_rate(float* out, float x, int iters) {
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = threadIdx.x + j;
  const float y = x * 0.5f;
  for (int i = 0; i < iters; i += 2) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = __fmul_rn(acc[j], x);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = __fadd_rn(acc[j], y);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int mode, int iters, int blocks, int threads) {
  if (mode < 4) lds<<<blocks, threads>>>(out, mode, iters);
  else if (mode == 4) fma_rate<<<blocks, threads>>>(out, 0.999f, iters);
  else mul_add_rate<<<blocks, threads>>>(out, 0.999f, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from points_matching_tpu_torch.ops.kernels import _build

    out_dir = os.path.join(root, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "lds.cu"), os.path.join(out_dir, "liblds.so")
    with open(cu, "w") as f:
        f.write(SRC)
    built = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        print(built.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, blocks, iters = 512, sms * 4, 1 << 14
    out = torch.empty(blocks * threads, device="cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for mode, name in enumerate(("broadcast", "4 rows", "8 rows", "32 rows")):
        for _ in range(2):
            lib.run(out.data_ptr(), mode, iters, blocks, threads)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.run(out.data_ptr(), mode, iters, blocks, threads)
        end.record()
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.strip()
        end.synchronize()
        ms = start.elapsed_time(end)
        loads = blocks * threads / 32 * iters          # warp-wide LDS.128
        per_sm_clk = loads / sms / (ms * 1e-3 * float(clock) * 1e6)
        print(f"{name:9s}: {ms:.3f} ms, {per_sm_clk:.3f} warp loads per SM per clock "
              f"({per_sm_clk * 512:.0f} B/clk as if every lane's 16 B were moved; "
              f"SM clock {clock} MHz)")
    for mode, name in ((4, "ffma"), (5, "fmul+fadd")):
        for threads in (128, 256, 512):
            iters = 1 << 12
            for _ in range(2):
                lib.run(out.data_ptr(), mode, iters, blocks, threads)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(out.data_ptr(), mode, iters, blocks, threads)
            end.record()
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True).stdout.strip()
            end.synchronize()
            ms = start.elapsed_time(end)
            ops = blocks * threads * iters * 32
            per_sm_clk = ops / sms / (ms * 1e-3 * float(clock) * 1e6)
            print(f"{name}, {threads // 32 * blocks // sms} warps/SM: {ms:.3f} ms, "
                  f"{per_sm_clk:.1f} fp32 instructions per SM per clock of 128 "
                  f"(SM clock {clock} MHz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
