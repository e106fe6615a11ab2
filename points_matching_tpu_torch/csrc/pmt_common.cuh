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

__device__ __forceinline__ uint32_t pmt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier: a barrier in shared memory that completes a phase once its
// expected arrivals have come and the bytes an arrival announced
// (expect-tx) have landed.  Waits name the parity of the phase they wait
// for: a fresh barrier is in phase 0, and a wait on parity 1 passes at once.
__device__ __forceinline__ void pmt_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(pmt_smem_addr(bar)),
               "r"(count));
}

// make the initialised barriers visible to the async proxy (bulk copies)
__device__ __forceinline__ void pmt_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void pmt_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(pmt_smem_addr(bar))
               : "memory");
}

// arrive, and announce `bytes` that bulk copies will complete on this barrier
__device__ __forceinline__ void pmt_mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   pmt_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool pmt_mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(pmt_smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void pmt_mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!pmt_mbar_try_wait(bar, parity)) {
  }
}

// -- cp.async.bulk: `bytes` (a multiple of 16, from a 16-byte aligned
// address to one) from device to shared memory by the copy engine,
// completing on `bar` (which an arrive-expect-tx told to wait for them)
__device__ __forceinline__ void pmt_bulk_copy_g2s(void* smem, const void* gmem, uint32_t bytes,
                                                  uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          pmt_smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(pmt_smem_addr(bar))
      : "memory");
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma's operand fetch)
__device__ __forceinline__ void pmt_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's warp index, as a value the compiler knows to be the same
// across the warp (a role branch on it is not divergent, which would
// otherwise serialise the wgmma instructions behind it)
__device__ __forceinline__ int pmt_warp_uniform(int warp) {
  return __shfl_sync(0xffffffffu, warp, 0);
}

// a named barrier over `threads` threads (a warpgroup: 128), id 1..15
__device__ __forceinline__ void pmt_named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma: a warpgroup's (4 warps, 128 threads) asynchronous tensor-core
// product.  fence before the first wgmma that reads registers or shared
// memory written since; commit closes a group; wait<N> returns once at most
// N groups are in flight.
__device__ __forceinline__ void pmt_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void pmt_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void pmt_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the wgmma instructions that write it asynchronously: before the fence
// that starts them and after the wait that ends them
template <int N>
__device__ __forceinline__ void pmt_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory matrix descriptor of a wgmma operand: start address,
// leading and stride byte offsets (16-byte units) and the layout
// (0 none, 1 128-byte swizzle, 2 64-byte, 3 32-byte).  For a K-major
// operand, SBO is the distance between groups of 8 rows; LBO the distance
// between the two 16-byte k-chunks of a k16 step without a swizzle (with
// one, the k16 step lies inside a row of the swizzle atom and LBO is unused).
__device__ __forceinline__ uint64_t pmt_wgmma_desc(const void* smem, uint32_t lbo_bytes,
                                                   uint32_t sbo_bytes, uint32_t layout) {
  const uint64_t a = pmt_smem_addr(smem);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// D[64 × N] (+)= A[64 × 16] · B[16 × N], bf16 operands, fp32 accumulators:
// A from registers (the m16n8k16 fragment of each warp's 16 rows), B from
// shared memory, K-major (descriptor).  scale_d = 0 overwrites D.
// Accumulator i of a thread: row 16·warp + lane/4 + 8·((i/2) % 2), column
// 8·(i/4) + 2·(lane % 4) + i % 2.
__device__ __forceinline__ void pmt_wgmma_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void pmt_wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the m64nNk16 above by its N
template <int N>
__device__ __forceinline__ void pmt_wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  static_assert(N == 16 || N == 32, "wgmma N built: 16, 32");
  if constexpr (N == 16) pmt_wgmma_m64n16(d, a, desc, scale_d);
  else pmt_wgmma_m64n32(d, a, desc, scale_d);
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
