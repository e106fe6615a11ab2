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
// The plan (perm stably sorted by target row, offsets, pieces and the row
// of each piece) is built once per BA call by ops/kernels/segment_sum.py.
//
// The order, for a row whose segment holds m entries e_0 .. e_{m-1}:
//   * a chunk is 32 consecutive entries, lane l holding e_{32c+l} (0 past
//     the end); its sum is the xor butterfly over the lanes (offsets 16, 8,
//     4, 2, 1), which leaves the same bits in every lane;
//   * a piece is kChunksPerPiece consecutive chunks, summed in chunk order;
//   * the row is its pieces summed in piece order (an empty row is 0).
// Nothing in it depends on the grid, the launch or the other rows.
//
// What bounds it on the card: bytes — each value read once through perm
// (a gather of W contiguous elements an entry), perm and offsets read once,
// the output written once; a few adds an element.  Design: pass 1 gives
// each piece a warp (its row read from the plan's piece_rows), so a
// 2,048-entry camera row spreads over 8 warps and an 8-entry landmark row
// takes one; a row of one piece is written straight to the output, longer
// rows leave their pieces' sums in scratch, and pass 2 (one thread an
// output element) adds them in piece order.  No atomics.
#include "pmt_common.cuh"

namespace {

constexpr int kChunksPerPiece = 8;                 // kPiece in segment_sum.py
constexpr int kPiece = 32 * kChunksPerPiece;       // entries a piece (a warp's work)
constexpr int kWarpsPerBlock = 8;

// W elements of type T, loaded as the widest vectors the row's alignment
// allows (row starts are multiples of W·sizeof(T) bytes from a 16-byte
// aligned base)
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T x[N];
};

template <typename T, int W>
struct RowLoad {
  static constexpr int kBytes = W * static_cast<int>(sizeof(T));
  static constexpr int kVec = (kBytes % 16 == 0) ? 16 / sizeof(T)
                              : (kBytes % 8 == 0) ? 8 / sizeof(T) : 1;
  __device__ __forceinline__ static void load(const T* row, T (&v)[W]) {
    using P = Pack<T, kVec>;
    const P* src = reinterpret_cast<const P*>(row);
#pragma unroll
    for (int j = 0; j < W / kVec; ++j) {
      const P p = src[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[j * kVec + i] = p.x[i];
    }
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_pieces_kernel(const T* __restrict__ values, const int* __restrict__ perm,
                      const int* __restrict__ offsets, const int* __restrict__ pieces,
                      const int* __restrict__ piece_rows, int n, int max_pieces,
                      T* __restrict__ out, T* __restrict__ part) {
  const int lane = threadIdx.x % 32;
  const int piece = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (piece >= max_pieces) return;
  const int r = piece_rows[piece];                 // n past the last piece
  if (r >= n) return;
  const int begin = offsets[r] + (piece - pieces[r]) * kPiece;
  const int end = min(offsets[r + 1], begin + kPiece);

  T acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = T(0);
  for (int c = begin; c < end; c += 32) {
    T v[W];
    const int i = c + lane;
    if (i < end) {
      RowLoad<T, W>::load(values + static_cast<size_t>(perm[i]) * W, v);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] = T(0);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
    if (c == begin) {
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] += v[k];
    }
  }
  T* dst = (pieces[r + 1] - pieces[r] == 1) ? out + static_cast<size_t>(r) * W
                                              : part + static_cast<size_t>(piece) * W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k % 32 == lane) dst[k] = acc[k];
  }
}

// rows of no piece get 0, rows of several the sum of their pieces in order
template <typename T, int W>
__global__ void segment_rows_kernel(const int* __restrict__ pieces, int n,
                                    const T* __restrict__ part, T* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(n) * W) return;
  const int r = static_cast<int>(e / W), k = static_cast<int>(e % W);
  const int p0 = pieces[r], p1 = pieces[r + 1];
  if (p1 - p0 == 1) return;                        // written by pass 1
  T acc = T(0);
  if (p1 > p0) {
    acc = part[static_cast<size_t>(p0) * W + k];
    for (int p = p0 + 1; p < p1; ++p) acc += part[static_cast<size_t>(p) * W + k];
  }
  out[e] = acc;
}

template <typename T, int W>
int launch(const void* values, const void* perm, const void* offsets, const void* pieces,
           const void* piece_rows, void* out, void* part, int n, int max_pieces,
           cudaStream_t st) {
  const T* v = static_cast<const T*>(values);
  const int* pm = static_cast<const int*>(perm);
  const int* of = static_cast<const int*>(offsets);
  const int* pc = static_cast<const int*>(pieces);
  const int* pr = static_cast<const int*>(piece_rows);
  T* o = static_cast<T*>(out);
  T* pt = static_cast<T*>(part);
  if (max_pieces > 0) {
    const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segment_pieces_kernel<T, W><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        v, pm, of, pc, pr, n, max_pieces, o, pt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t elems = static_cast<size_t>(n) * W;
  if (elems > 0) {
    const int threads = 256;
    segment_rows_kernel<T, W><<<static_cast<unsigned>((elems + threads - 1) / threads),
                                threads, 0, st>>>(pc, n, pt, o);
  }
  PMT_RETURN_LAUNCH_STATUS();
}

}  // namespace

// values [R, W] (f32 or f64, W ∈ {3, 6, 9, 36}; WIDTHS in segment_sum.py), 16-byte
// aligned; perm [R] i32; offsets, pieces [n + 1] i32; piece_rows
// [max_pieces] i32, max_pieces ≥ pieces[n]; out [n, W]; part [max_pieces, W]
// scratch; `f64` selects the type
PMT_EXPORT int pmt_segment_sum(const void* values, const void* perm, const void* offsets,
                               const void* pieces, const void* piece_rows, void* out,
                               void* part, int n, int W, int max_pieces, int f64,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto f) {
    return f(values, perm, offsets, pieces, piece_rows, out, part, n, max_pieces, st);
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
