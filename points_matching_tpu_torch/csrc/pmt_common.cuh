// Shared helpers for the port's CUDA kernels (plain C interface, no
// PyTorch headers: the library is loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PMT_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point returns the launch status: cudaGetLastError() right
// after the launch, so a launch the CUDA runtime refused is reported by the
// wrapper instead of being silently skipped.
#define PMT_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

constexpr float kPmtBig = 1e30f;  // "+inf" sentinel of the reference kernels

// -- cp.async: 16-byte copies from device to shared memory that bypass the
// registers and complete asynchronously, in commit groups ----------------
__device__ __forceinline__ void pmt_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// the same copy, or 16 zero bytes where `valid` is false (nothing is read)
__device__ __forceinline__ void pmt_cp_async16_zfill(void* smem, const void* gmem,
                                                     bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void pmt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void pmt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- top-2 under the lexicographic order of (distance, column) ------------
// The matchers' contract (K1, K4): column 0 is the lowest index at the
// minimum, column 1 the lowest other index at the runner-up, and with fewer
// than two valid train rows the missing entries are the sentinel (big, 0).
// That is the lexicographic top-2 of the columns together with two sentinel
// entries (big, 0).  A top-2 over disjoint column sets therefore merges
// exactly: the lexicographic top-2 of two lexicographic top-2s (sentinels
// included) is the top-2 of the union, in any grouping and any order.
template <typename T>
struct PmtTop2 {
  T d1, d2;
  int i1, i2;

  __device__ __forceinline__ static PmtTop2 empty(T big) { return {big, big, 0, 0}; }

  // next column j, visited in increasing order: the strict `<` update is
  // the lexicographic one, since j is above every column seen so far
  // (selects, not branches: the lanes of a warp disagree on the outcome)
  __device__ __forceinline__ void push(T d, int j) {
    const bool lt1 = d < d1, lt2 = d < d2;
    d2 = lt1 ? d1 : (lt2 ? d : d2);
    i2 = lt1 ? i1 : (lt2 ? j : i2);
    d1 = lt1 ? d : d1;
    i1 = lt1 ? j : i1;
  }

  __device__ __forceinline__ static bool less(T a, int ia, T b, int ib) {
    return a < b || (a == b && ia < ib);
  }

  // the lexicographic top-2 of this and o (two sorted pairs)
  __device__ __forceinline__ void merge(const PmtTop2& o) {
    if (less(o.d1, o.i1, d1, i1)) {
      const bool keep = less(d1, i1, o.d2, o.i2);
      d2 = keep ? d1 : o.d2;
      i2 = keep ? i1 : o.i2;
      d1 = o.d1;
      i1 = o.i1;
    } else if (less(o.d1, o.i1, d2, i2)) {
      d2 = o.d1;
      i2 = o.i1;
    }
  }

  // merge with the lane `mask` away (all 32 lanes of the warp take part)
  __device__ __forceinline__ void merge_lane(int mask) {
    PmtTop2 o;
    o.d1 = __shfl_xor_sync(0xffffffffu, d1, mask);
    o.d2 = __shfl_xor_sync(0xffffffffu, d2, mask);
    o.i1 = __shfl_xor_sync(0xffffffffu, i1, mask);
    o.i2 = __shfl_xor_sync(0xffffffffu, i2, mask);
    merge(o);
  }
};

// A partial top-2 as the split kernels leave it in scratch: one int4 per
// (pair, split, query row), the distances' bits in .x and .z.
__device__ __forceinline__ int4 pmt_pack(const PmtTop2<float>& p) {
  return make_int4(__float_as_int(p.d1), p.i1, __float_as_int(p.d2), p.i2);
}

__device__ __forceinline__ int4 pmt_pack(const PmtTop2<int>& p) {
  return make_int4(p.d1, p.i1, p.d2, p.i2);
}

__device__ __forceinline__ void pmt_unpack(int4 v, PmtTop2<float>* p) {
  *p = {__int_as_float(v.x), __int_as_float(v.z), v.y, v.w};
}

__device__ __forceinline__ void pmt_unpack(int4 v, PmtTop2<int>* p) {
  *p = {v.x, v.z, v.y, v.w};
}

// Column range [begin, end) of split s of S over N2 train rows: every split
// gets ⌊N2/S⌋ or ⌈N2/S⌉ columns (none is empty while S ≤ N2).
__device__ __forceinline__ void pmt_split_range(int s, int S, int N2, int* begin,
                                                int* end) {
  *begin = static_cast<int>(static_cast<long long>(s) * N2 / S);
  *end = static_cast<int>(static_cast<long long>(s + 1) * N2 / S);
}
