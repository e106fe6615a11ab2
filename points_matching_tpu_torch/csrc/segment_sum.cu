// Segmented sum in a fixed order — the reduction of the sparse bundle
// adjustment's normal equations (ba/sparse.py) and of the pose graph's
// (ba/pose_graph.py):
//
//     out[r, :] = Σ values[perm[i], :]  for i in [offsets[r], offsets[r+1])
//
// Replaces no Pallas kernel: it ports the semantics of the reference's
// 'sorted' observation layout (points_matching_tpu/ba/sparse.py
// _sort_obs_by_landmark / _sorted_ops), whose sums come out in the same
// bits on every run.  index_add_ on the card adds with float atomics, in
// whatever order they land; this kernel adds in an order fixed by the
// row's own segment, so two runs give the same bits and a batch of
// problems (rows s·C + c) gives each problem the bits it gets alone.
// The plan (perm stably sorted by target row, offsets, the pieces of the
// long rows and the row of each piece) is built once per BA call by
// ops/kernels/segment_sum.py, whose segment_sum_ordered adds in the same
// order on the CPU.
//
// The order, for a row whose segment holds m entries e_0 .. e_{m-1}; it
// depends on m and on the entries' order in perm alone, never on the grid,
// the launch, the number of rows or the other rows:
//   * a chunk is kChunk consecutive entries; each column of its sum is
//     0 + e_0 + e_1 + ... in entry order;
//   * a piece is kChunksPerPiece consecutive chunks, its sum 0 + c_0 + c_1
//     + ... in chunk order;
//   * the row is 0 + p_0 + p_1 + ... over its pieces in order (an empty
//     row is 0).  A sum that starts from +0 is never -0, so the 0 + x at
//     each level is exact and a row of one chunk or one piece is that sum.
//
// What bounds it on the card: bytes — each valid entry's W values read
// once through perm (a gather of one row of W contiguous elements an
// entry), perm and offsets read once, the output written once; m - 1 adds
// an element.  Design, one launch a call, 256-thread blocks in two roles:
//   * short rows (m <= kShort, a constant on m; empty rows too): a group of
//     G = W / V lanes takes a row, each lane V adjacent columns, and adds
//     down the row's entries; a warp covers 32 / G consecutive rows, so
//     the pose graph's rows of ~2 entries and the BA's landmark rows of ~8
//     share warps;
//   * long rows: a block a piece (the plan's piece_rows names its row),
//     a warp a chunk.  The chunk's perm is loaded once (a lane an entry)
//     and passed along by __shfl_sync; the warp copies the chunk's rows
//     into shared memory with cp.async (16, 8 or 4 bytes a copy, as the
//     row's alignment allows; every copy of the chunk in flight at once,
//     no registers held), then lane l adds columns l and l + 32 down the
//     staged entries in order.  The block adds
//     its chunks' sums from shared memory in order; a row of one piece is
//     written out there, a longer one leaves its piece sum in the plan's
//     scratch and the block that arrives last at the row's integer counter
//     adds the row's pieces in order (which block that is does not touch
//     the order) and resets the counter.  The piece blocks come first in
//     the grid and stride over the plan's pieces, so no host read sizes
//     the launch.
// No float atomics, no shuffle trees, no second pass.
#include "pmt_common.cuh"

namespace {

constexpr int kChunk = 32;                         // CHUNK in segment_sum.py
constexpr int kChunksPerPiece = 8;
constexpr int kPiece = kChunk * kChunksPerPiece;   // PIECE in segment_sum.py
constexpr int kShort = kChunk;                     // SHORT: rows of at most this many entries
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kShortUnroll = 4;                    // a short row's entries loaded together
constexpr int kStageBytes = 4608;                  // a warp's staged rows: 32 of 36 floats

constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

// the columns a lane owns in a short row: V adjacent elements, G = W / V lanes a row
template <int W> struct ShortShape;
template <> struct ShortShape<3> { static constexpr int V = 3; };
template <> struct ShortShape<6> { static constexpr int V = 2; };
template <> struct ShortShape<9> { static constexpr int V = 3; };
template <> struct ShortShape<36> { static constexpr int V = 4; };

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T x[N];
};

// V elements of a W-element row at column q·V, loaded as the widest vectors
// the address allows (a row starts a multiple of W·sizeof(T) bytes from a
// 16-byte aligned base)
template <typename T, int W, int V>
struct Slice {
  static constexpr int kAlign = gcd_c(gcd_c(W * int(sizeof(T)), V * int(sizeof(T))), 16);
  static constexpr int kVec = gcd_c(kAlign / int(sizeof(T)), V);
  using P = Pack<T, kVec>;
  __device__ __forceinline__ static void load(const T* p, T (&v)[V]) {
    const P* src = reinterpret_cast<const P*>(p);
#pragma unroll
    for (int j = 0; j < V / kVec; ++j) {
      const P x = src[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[j * kVec + i] = x.x[i];
    }
  }
  __device__ __forceinline__ static void store(T* p, const T (&v)[V]) {
    P* dst = reinterpret_cast<P*>(p);
#pragma unroll
    for (int j = 0; j < V / kVec; ++j) {
      P x;
#pragma unroll
      for (int i = 0; i < kVec; ++i) x.x[i] = v[j * kVec + i];
      dst[j] = x;
    }
  }
};

// a long row's chunk staged in shared memory: kEntries rows at a time (the
// whole chunk, or half of it for f64 at W = 36), each row in kPerEntry copies
// of kCopy bytes (16, 8 or 4: what the row's alignment allows)
template <typename T, int W>
struct Stage {
  static constexpr int kBytes = W * int(sizeof(T));
  static constexpr int kCopy = gcd_c(kBytes, 16);
  static constexpr int kPerEntry = kBytes / kCopy;
  static constexpr int kEntries = kChunk * kBytes <= kStageBytes ? kChunk : kChunk / 2;
  static constexpr int kCopies = kEntries * kPerEntry;
  static_assert(kCopies % 32 == 0, "a lane issues a whole number of copies");
  static_assert(kEntries * kBytes <= kStageBytes, "the stage holds kEntries rows");
};

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
  }
}

// rows of at most kShort entries: lane group g of warp `warp` takes row
// warp·(32 / G) + g; longer rows are left to the piece blocks
template <typename T, int W>
__device__ __forceinline__ void short_rows(const T* __restrict__ values,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ offsets, int n, int warp,
                                           T* __restrict__ out) {
  constexpr int V = ShortShape<W>::V, G = W / V, kRows = 32 / G;
  using S = Slice<T, W, V>;
  const int lane = threadIdx.x % 32, g = lane / G, q = lane % G;
  const int r = warp * kRows + g;
  if (g >= kRows || r >= n) return;
  const int b = offsets[r], e = offsets[r + 1];
  if (e - b > kShort) return;
  T acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = T(0);
  const T* base = values + q * V;
  for (int i = b; i < e; i += kShortUnroll) {
    T v[kShortUnroll][V];
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      if (i + u < e) {
        S::load(base + static_cast<size_t>(perm[i + u]) * W, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[u][k] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      if (i + u < e) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += v[u][k];
      }
    }
  }
  S::store(out + static_cast<size_t>(r) * W + q * V, acc);
}

// the pieces of the long rows, blockIdx.x, blockIdx.x + long_blocks, ...
template <typename T, int W>
__device__ __forceinline__ void long_pieces(const T* __restrict__ values,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ pieces,
                                            const int* __restrict__ piece_rows, int n,
                                            int long_blocks, T* __restrict__ out,
                                            T* __restrict__ scratch, int* __restrict__ arrivals,
                                            T (*part)[W], T* stage, int* last) {
  using St = Stage<T, W>;
  constexpr int NC = (W + 31) / 32;                // columns a lane: l, l + 32
  constexpr int kVec = St::kCopy / int(sizeof(T));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = threadIdx.x;
  T* warp_stage = stage + warp * (St::kEntries * W);
  const int total = pieces[n];
  for (int p = blockIdx.x; p < total; p += long_blocks) {
    const int r = piece_rows[p];
    const int p0 = pieces[r], np = pieces[r + 1] - p0;
    const int row_end = offsets[r + 1];
    const int piece_begin = offsets[r] + (p - p0) * kPiece;
    const int chunks = min((row_end - piece_begin + kChunk - 1) / kChunk, kChunksPerPiece);
    const int begin = piece_begin + warp * kChunk;
    const int len = min(row_end - begin, kChunk);
    if (len > 0) {
      const int mine = lane < len ? perm[begin + lane] : 0;
      T acc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = T(0);
      for (int j = 0; j < len; j += St::kEntries) {
        const int staged = min(len - j, St::kEntries);
#pragma unroll 1                                   // fewer registers, as fast
        for (int i = 0; i < St::kCopies / 32; ++i) {
          const int k = lane + 32 * i;
          const int e = k / St::kPerEntry, off = (k % St::kPerEntry) * kVec;
          const int idx = __shfl_sync(0xffffffffu, mine, (j + e) % 32);
          if (e < staged) {
            cp_async<St::kCopy>(warp_stage + e * W + off,
                                values + static_cast<size_t>(idx) * W + off);
          }
        }
        pmt_cp_async_commit();
        pmt_cp_async_wait<0>();
        __syncwarp();
        for (int e = 0; e < staged; ++e) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (lane + 32 * c < W) acc[c] += warp_stage[e * W + lane + 32 * c];
          }
        }
        __syncwarp();                              // the stage is refilled next
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (lane + 32 * c < W) part[warp][lane + 32 * c] = acc[c];
      }
    }
    __syncthreads();
    if (t < W) {
      T s = T(0);
      for (int c = 0; c < chunks; ++c) s += part[c][t];
      if (np == 1) {
        out[static_cast<size_t>(r) * W + t] = s;
      } else {
        scratch[static_cast<size_t>(p) * W + t] = s;
        __threadfence();
      }
    }
    if (np > 1) {                                  // the same in the whole block
      __syncthreads();
      if (t == 0) *last = atomicAdd(arrivals + r, 1) == np - 1;
      __syncthreads();
      if (*last) {
        if (t < W) {
          T s = T(0);
          for (int k = p0; k < p0 + np; ++k) s += __ldcg(scratch + static_cast<size_t>(k) * W + t);
          out[static_cast<size_t>(r) * W + t] = s;
        }
        if (t == 0) arrivals[r] = 0;
      }
    }
    __syncthreads();                               // part and last are reused
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ perm,
                   const int* __restrict__ offsets, const int* __restrict__ pieces,
                   const int* __restrict__ piece_rows, int n, int long_blocks,
                   T* __restrict__ out, T* __restrict__ scratch, int* __restrict__ arrivals) {
  __shared__ T part[kChunksPerPiece][W];
  __shared__ __align__(16) T stage[kWarps * Stage<T, W>::kEntries * W];
  __shared__ int last;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    long_pieces<T, W>(values, perm, offsets, pieces, piece_rows, n, long_blocks, out, scratch,
                      arrivals, part, stage, &last);
  } else {
    short_rows<T, W>(values, perm, offsets, n,
                     (static_cast<int>(blockIdx.x) - long_blocks) * kWarps + threadIdx.x / 32,
                     out);
  }
}

template <typename T, int W>
int launch(const void* values, const void* perm, const void* offsets, const void* pieces,
           const void* piece_rows, void* out, void* scratch, void* arrivals, int n,
           int long_blocks, cudaStream_t st) {
  constexpr int kRowsPerBlock = kWarps * (32 / (W / ShortShape<W>::V));
  const long long blocks = long_blocks + (static_cast<long long>(n) + kRowsPerBlock - 1) /
                                         kRowsPerBlock;
  if (blocks == 0) return 0;
  segment_sum_kernel<T, W><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(values), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<const int*>(pieces),
      static_cast<const int*>(piece_rows), n, long_blocks, static_cast<T*>(out),
      static_cast<T*>(scratch), static_cast<int*>(arrivals));
  PMT_RETURN_LAUNCH_STATUS();
}

}  // namespace

// values [R, W] (f32 or f64, W ∈ {3, 6, 9, 36}; WIDTHS in segment_sum.py), 16-byte
// aligned; perm [R] i32; offsets, pieces [n + 1] i32; piece_rows [max_pieces]
// i32, max_pieces ≥ pieces[n]; out [n, W]; scratch [max_pieces, W]; arrivals
// [n] i32, zero before the first launch and left zero by each; long_blocks
// blocks stride over the pieces; `f64` selects the type
PMT_EXPORT int pmt_segment_sum(const void* values, const void* perm, const void* offsets,
                               const void* pieces, const void* piece_rows, void* out,
                               void* scratch, void* arrivals, int n, int W, int long_blocks,
                               int f64, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto f) {
    return f(values, perm, offsets, pieces, piece_rows, out, scratch, arrivals, n, long_blocks,
             st);
  };
  if (f64) {
    switch (W) {
      case 3: return run(launch<double, 3>);
      case 6: return run(launch<double, 6>);
      case 9: return run(launch<double, 9>);
      case 36: return run(launch<double, 36>);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (W) {
    case 3: return run(launch<float, 3>);
    case 6: return run(launch<float, 6>);
    case 9: return run(launch<float, 9>);
    case 36: return run(launch<float, 36>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
