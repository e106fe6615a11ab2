// K3 — batched minimal 8-point solve, the RANSAC hypothesis factory.
//
// Replaces the TPU kernel points_matching_tpu/ops/pallas/eightpoint_kernel.py
// minimal_eight_point (_eightpoint_kernel, _hartley, _chol_unrolled,
// _chol_solve_unrolled, _smallest_eigvec).  Same chain, same constants:
//   Hartley normalization (max(mean_dist, 1e-9)) → AᵀA (9×9) →
//   Cholesky of AᵀA + εI (ε = 1e-5·tr/9 + 1e-20, sqrt(max(·, 1e-30)) pivots)
//   → 4 inverse iterations from the golden-angle start cos(i·2.399963)+0.1
//   → rank-2 projection via the smallest eigenvector of FᵀF (3×3, ε with
//   n = 3, 8 iterations) → denormalization → unit Frobenius norm and the
//   sign pivot (largest |entry| positive, first on ties).
//
// What bounds it on the card: the latency of one sample's chain, not
// memory (~2.5 k fp32 operations per sample against 164 bytes) and, at the
// slices' 512 samples, not the fp32 rate either.  The chain holds ~68 IEEE
// square roots and divisions, each a branch-guarded sequence of dependent
// instructions; 16 of the roots (Hartley's point distances) and the 45
// AᵀA entries are independent work, the rest (Cholesky pivots, inverse
// iteration, the 3×3 stage, the sign) one dependent chain per sample.
//
// Design: a block is one warp holding 32 / G samples with G lanes each (G ∈
// {1, 8}, chosen by the wrapper, ops/kernels/_build.eight_point_group), so
// that one pair's 512 samples spread over 128 SMs.
//   1. The warp stages its samples' 64 + 64 input bytes through shared
//      memory with coalesced 16-byte cp.async copies.
//   2. With G = 8 each group of 8 lanes shares its sample's independent
//      work in shared memory, lane p taking point p: every lane forms both
//      centroids and its point's distances to them (16 square roots over
//      the group), lanes 0 and 1 sum one image's distances each into its
//      scale, lane p forms the constraint row r_p = (x2x1, x2y1, x2, y2x1,
//      y2y1, y2, x1, y1, 1), and then the lanes deal out the 45 AᵀA
//      entries, each summed over the 8 points in order.  With G = 1 one
//      lane does all of it in registers.
//   3. Lanes 0 .. 32/G − 1 then run the serial core in registers, one lane
//      per sample: the Cholesky factorization, the 4 inverse iterations,
//      the 3×3 stage, denormalization, the sign pivot and the store.
//      (Dealing the Cholesky rows out too, with L in shared memory, was
//      measured slower: each column then waits for a shared-memory round
//      trip, and the pivot's root and division, not the rows, set the
//      column's time.)
//   A large batch takes G = 1: the groups' shared-memory traffic, one
//   warp-wide load a clock per SM, then costs more than they save.
// Built with --fmad=false, IEEE sqrt and division, and every operation in
// the order of the plain PyTorch version (ops/kernels/eightpoint_kernel.py),
// so that for every G the two agree to the last bit.  Products with the
// constant 1 in r_p are exact, as the plain version's skipped multiplies.
#include "pmt_common.cuh"

namespace {

constexpr int kWarp = 32;             // a block is one warp: 32 / G samples
constexpr int kGroup = 8;             // lanes a sample when the lanes share its work
// per-sample shared-memory area (G = kGroup), in floats
constexpr int kDist = 0;              // distances to the centroid [image][point]
constexpr int kPrm = 16;              // cx1, cy1, s1, cx2, cy2, s2
constexpr int kRows = 22;             // r_p [8][9]
constexpr int kAta = kRows + 72;      // AᵀA (45, packed lower triangle)
constexpr int kStride = kAta + 45;    // 139: odd, so samples at one offset hit distinct banks
static_assert(kStride % 2 == 1, "the per-sample stride must be odd");
constexpr float kSqrt2 = 1.4142135623730951f;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// golden-angle start vector cos(i·2.399963) + 0.1, rounded to fp32
__constant__ float kStart[9] = {
    1.100000023841858f,   -0.6373687386512756f, 0.18742527067661285f,
    0.7084394097328186f,  -0.8847136497497559f, 0.9437546730041504f,
    -0.15960296988487244f, -0.3609084486961365f, 1.0393218994140625f};

// Cholesky of the symmetric matrix A + εI (A packed lower triangle) into
// packed L and invd = 1/diag(L), ε = 1e-5·tr(A)/N + 1e-20, left-looking.
template <int N>
__device__ __forceinline__ void cholesky(const float (&A)[N * (N + 1) / 2],
                                         float (&L)[N * (N + 1) / 2], float (&invd)[N]) {
  constexpr float kEpsScale = static_cast<float>(1e-5 / N);
  float tr = A[tri(0, 0)];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + A[tri(i, i)];
  const float eps = tr * kEpsScale + 1e-20f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = A[tri(j, j)] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
    const float d = sqrtf(fmaxf(s, 1e-30f));
    const float inv = 1.0f / d;
    L[tri(j, j)] = d;
    invd[j] = inv;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s2 = A[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = s2 * inv;
    }
  }
}

// ITERS inverse iterations v ← (LLᵀ)⁻¹v / ‖·‖ from the golden-angle start,
// rows in order (forward, then backward substitution); v = e₀ where the
// norm is not finite or below 1e-20.
template <int N, int ITERS>
__device__ __forceinline__ void inverse_iteration(const float* L, const float* invd,
                                                  float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = kStart[i];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float y[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = v[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
      y[i] = s * invd[i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s = s - L[tri(k, i)] * x[k];
      x[i] = s * invd[i];
    }
    float ss = x[0] * x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) ss = ss + x[i] * x[i];
    const float norm = sqrtf(ss);
    const bool ok = norm > 1e-20f && isfinite(norm);
    const float inv = 1.0f / fmaxf(norm, 1e-20f);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ok ? x[i] * inv : (i == 0 ? 1.f : 0.f);
  }
}

// Unweighted Hartley normalization of one image's 8 points ([x, y] × 8 in
// `in`): the normalized points to `out`, (cx, cy, s) to `prm`.
__device__ __forceinline__ void hartley(const float* in, float* out, float* prm) {
  float xs[8], ys[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    xs[p] = in[2 * p];
    ys[p] = in[2 * p + 1];
  }
  float cx = xs[0];
  float cy = ys[0];
#pragma unroll
  for (int p = 1; p < 8; ++p) {
    cx = cx + xs[p];
    cy = cy + ys[p];
  }
  cx = cx * 0.125f;
  cy = cy * 0.125f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    xs[p] = xs[p] - cx;
    ys[p] = ys[p] - cy;
  }
  float md = sqrtf(xs[0] * xs[0] + ys[0] * ys[0]);
#pragma unroll
  for (int p = 1; p < 8; ++p) md = md + sqrtf(xs[p] * xs[p] + ys[p] * ys[p]);
  md = md * 0.125f;
  const float s = kSqrt2 / fmaxf(md, 1e-9f);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    out[2 * p] = xs[p] * s;
    out[2 * p + 1] = ys[p] * s;
  }
  prm[0] = cx;
  prm[1] = cy;
  prm[2] = s;
}

// AᵀA over the rows r_p = [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] of
// one sample's normalized points, summed over p in order, packed.
__device__ __forceinline__ void ata_registers(const float* n1, const float* n2,
                                              float (&A)[45]) {
#pragma unroll
  for (int e = 0; e < 45; ++e) A[e] = 0.f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float x1 = n1[2 * p], y1 = n1[2 * p + 1], x2 = n2[2 * p], y2 = n2[2 * p + 1];
    const float r[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, 1.f};
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) A[tri(i, j)] = A[tri(i, j)] + r[i] * r[j];
  }
}

// The group's shared work (G = kGroup, lane p takes point p) for one
// sample: Hartley scales and centroids to my[kPrm..], AᵀA to my[kAta..].
__device__ __forceinline__ void group_ata(const float* in1, const float* in2, float* my,
                                          int lane) {
  const float* in[2] = {in1, in2};
  float cx[2], cy[2], dx[2], dy[2];
#pragma unroll
  for (int img = 0; img < 2; ++img) {
    // every lane forms the centroid, in the plain order
    cx[img] = in[img][0];
    cy[img] = in[img][1];
#pragma unroll
    for (int p = 1; p < 8; ++p) {
      cx[img] = cx[img] + in[img][2 * p];
      cy[img] = cy[img] + in[img][2 * p + 1];
    }
    cx[img] = cx[img] * 0.125f;
    cy[img] = cy[img] * 0.125f;
    dx[img] = in[img][2 * lane] - cx[img];
    dy[img] = in[img][2 * lane + 1] - cy[img];
    my[kDist + 8 * img + lane] = sqrtf(dx[img] * dx[img] + dy[img] * dy[img]);
  }
  __syncwarp();
  if (lane < 2) {                             // lane 0: image 1, lane 1: image 2
    const float* dist = my + kDist + 8 * lane;
    float md = dist[0];
#pragma unroll
    for (int p = 1; p < 8; ++p) md = md + dist[p];
    md = md * 0.125f;
    float* prm = my + kPrm + 3 * lane;
    prm[0] = lane ? cx[1] : cx[0];      // selects: no runtime index into registers
    prm[1] = lane ? cy[1] : cy[0];
    prm[2] = kSqrt2 / fmaxf(md, 1e-9f);
  }
  __syncwarp();
  const float s1 = my[kPrm + 2], s2 = my[kPrm + 5];
  const float x1 = dx[0] * s1, y1 = dy[0] * s1;
  const float x2 = dx[1] * s2, y2 = dy[1] * s2;
  float* r = my + kRows + 9 * lane;
  r[0] = x2 * x1;
  r[1] = x2 * y1;
  r[2] = x2;
  r[3] = y2 * x1;
  r[4] = y2 * y1;
  r[5] = y2;
  r[6] = x1;
  r[7] = y1;
  r[8] = 1.f;
  __syncwarp();
#pragma unroll
  for (int e0 = 0; e0 < 45; e0 += kGroup) {
    const int e = e0 + lane;
    if (e < 45) {
      // (i, j) of packed entry e, from compares: no table, whose reads
      // would differ across the lanes of a warp
      int i = 0;
#pragma unroll
      for (int t = 1; t < 9; ++t) i += e >= tri(t, 0);
      const float* ri = my + kRows + i;
      const float* rj = my + kRows + (e - tri(i, 0));
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p) acc = acc + ri[9 * p] * rj[9 * p];
      my[kAta + e] = acc;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kWarp)
eight_point_kernel(const float* __restrict__ sp1, const float* __restrict__ sp2,
                   float* __restrict__ out, int count) {
  static_assert(G == 1 || G == kGroup, "G is 1 or kGroup");
  constexpr int kSamples = kWarp / G;
  __shared__ __align__(16) float raw[2][kSamples][16];
  const int base = blockIdx.x * kSamples;

  // 1. stage the inputs: 2 images × kSamples × 4 16-byte chunks, zeros
  // past the last sample (computed on, never stored)
  for (int c = threadIdx.x; c < 2 * kSamples * 4; c += kWarp) {
    const int img = c / (kSamples * 4), s = (c / 4) % kSamples, q = c % 4;
    const float* src = img ? sp2 : sp1;
    const bool valid = base + s < count;
    pmt_cp_async16_zfill(&raw[img][s][4 * q],
                         src + (valid ? (static_cast<size_t>(base + s) * 16 + 4 * q) : 0),
                         valid);
  }
  pmt_cp_async_commit();
  pmt_cp_async_wait<0>();
  __syncwarp();

  // 2. Hartley and AᵀA
  float A[45], prm[6];
  if constexpr (G == 1) {
    float n[2][16];
    hartley(raw[0][threadIdx.x], n[0], prm);
    hartley(raw[1][threadIdx.x], n[1], prm + 3);
    ata_registers(n[0], n[1], A);
  } else {
    __shared__ float area[kSamples * kStride];
    const int s = threadIdx.x / G;
    group_ata(raw[0][s], raw[1][s], area + s * kStride, threadIdx.x % G);
    __syncwarp();
    if (threadIdx.x >= kSamples) return;
    const float* mine = area + threadIdx.x * kStride;
#pragma unroll
    for (int e = 0; e < 45; ++e) A[e] = mine[kAta + e];
#pragma unroll
    for (int k = 0; k < 6; ++k) prm[k] = mine[kPrm + k];
  }

  // 3. the serial core, one lane per sample
  float L[45], invd[9], f[9];
  cholesky<9>(A, L, invd);
  inverse_iteration<9, 4>(L, invd, f);

  // rank-2 projection: Fn ← Fn − (Fn v₃) v₃ᵀ, v₃ from FnᵀFn
  float M[6], L3[6], invd3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float t = f[i] * f[j];
#pragma unroll
      for (int k = 1; k < 3; ++k) t = t + f[3 * k + i] * f[3 * k + j];
      M[tri(i, j)] = t;
    }
  cholesky<3>(M, L3, invd3);
  float v3[3];
  inverse_iteration<3, 8>(L3, invd3, v3);
  float Fr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fv = f[3 * i] * v3[0] + f[3 * i + 1] * v3[1] + f[3 * i + 2] * v3[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) Fr[i][j] = f[3 * i + j] - fv * v3[j];
  }

  // denormalize: F = T2ᵀ Fr T1, T = [[s, 0, -s·cx], [0, s, -s·cy], [0, 0, 1]]
  const float cx1 = prm[0], cy1 = prm[1], s1 = prm[2];
  const float cx2 = prm[3], cy2 = prm[4], s2 = prm[5];
  float Gm[3][3], F[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Gm[i][0] = Fr[i][0] * s1;
    Gm[i][1] = Fr[i][1] * s1;
    Gm[i][2] = Fr[i][2] - cx1 * Gm[i][0] - cy1 * Gm[i][1];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    F[0][j] = Gm[0][j] * s2;
    F[1][j] = Gm[1][j] * s2;
    F[2][j] = Gm[2][j] - cx2 * F[0][j] - cy2 * F[1][j];
  }

  // unit Frobenius norm, then the largest-|entry| (first on ties) positive
  float ss = F[0][0] * F[0][0];
#pragma unroll
  for (int k = 1; k < 9; ++k) ss = ss + F[k / 3][k % 3] * F[k / 3][k % 3];
  const float inv = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
  float flat[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) flat[k] = F[k / 3][k % 3] * inv;
  float best_abs = fabsf(flat[0]);
  float best = flat[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float ak = fabsf(flat[k]);
    if (ak > best_abs) {
      best_abs = ak;
      best = flat[k];
    }
  }
  const float sign = best < 0.f ? -1.f : 1.f;
  const int g = base + static_cast<int>(threadIdx.x);
  if (g >= count) return;
  float* o = out + static_cast<size_t>(g) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = flat[k] * sign;
}

template <int G>
void launch(const float* sp1, const float* sp2, float* F, int count,
            cudaStream_t stream) {
  constexpr int kSamples = kWarp / G;
  const int grid = (count + kSamples - 1) / kSamples;
  eight_point_kernel<G><<<grid, kWarp, 0, stream>>>(sp1, sp2, F, count);
}

}  // namespace

// sp1, sp2 [count, 8, 2] f32, 16-byte aligned → F [count, 3, 3] f32, with
// G = group ∈ {1, 8} lanes per sample
PMT_EXPORT int pmt_eight_point(const void* sp1, const void* sp2, void* F, int count,
                               int group, void* stream) {
  if (count == 0) return 0;
  const auto* a = static_cast<const float*>(sp1);
  const auto* c = static_cast<const float*>(sp2);
  auto* o = static_cast<float*>(F);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: launch<1>(a, c, o, count, st); break;
    case kGroup: launch<kGroup>(a, c, o, count, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  PMT_RETURN_LAUNCH_STATUS();
}
