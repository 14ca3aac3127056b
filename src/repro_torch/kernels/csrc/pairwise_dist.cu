// Squared pairwise distances of the delay embedding of one series.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_dist.py::_kernel_vpu
// (wrapper pairwise_distances). For embedded rows i, j < Lp it writes
//     D[i, j] = Σ_{k=0}^{E-1} (x[i+kτ] - x[j+kτ])^2
// as the strict chain from acc = 0 (kbest::add_sq: each subtraction,
// square and addition rounded on its own, lags in order), so the bits equal
// the plain version's. Unlike the TPU wrapper it does not mean-center x:
// the port matches the reference's ref.pairwise_distances, which does not.
//
// What bounds it on the H100: the store of the (Lp, Lp) float32 matrix
// (10.2 MB at Lp = 1598, 3.05 µs at 3.35 TB/s; 398 MB at Lp = 9,981). The
// arithmetic is three operations a lag term that no FMA may fuse (a
// subtraction, a square, an addition), E·Lp² of each: below the store at
// E = 3, above it at E = 20 when counted at the FP32 pipes' 128 results a
// clock an SM.
//
// Design. The first design gave each thread one column and 16 rows: two
// shared-memory operand loads and one 4-byte store an output; at
// Lp = 1598 it took 8.3 µs against a 3.4–3.9 µs fill_ of the same matrix.
// Here a block takes a 32 × 128 tile and each lane a micro-tile of
// kLaneRows rows × 4 columns held in registers (its warp's rows, columns
// 4·lane .. 4·lane + 3):
//   - the tile's two series windows, x[i0 : i0 + 32 + (E-1)τ] and
//     x[j0 : j0 + 128 + (E-1)τ], are staged in shared memory as four
//     copies each, copy s shifted by s words, so that every lag's operands
//     are aligned 16-byte loads: a lag costs a lane one float4 of column
//     operands and one of row operands (a broadcast) per 4 rows;
//   - all blocks run in one wave, so a block's stores can only hide the
//     staging and arithmetic of other warps: a lane computes kChunk of
//     its rows over all lags, stores them, then the next kChunk.
// Two designs of that kernel, picked by the wrapper (pairwise_dist.route)
// by E, where the store or the arithmetic dominates; bit-equal (only the
// layout of the work differs):
//   - vector (small E): 8 warps × 4 rows, chunks of 2 rows, each row
//     written with aligned 16-byte streaming stores (__stcs: the top-k
//     kernel that reads D next was not slowed by it). Row i's column j0
//     lies at word i·Lp + j0, so with s = (i·Lp + j0) mod 4 (the same for
//     the whole warp) the aligned groups begin s words before each lane's
//     columns: lane t writes the group of lane t - 1's last s values (a
//     shuffle) and its own first 4 - s. What no group covers goes word by
//     word: lane 0's first 4 - s values (the head), lane 31's last s (the
//     tail), and a group that crosses column Lp;
//   - word (large E): 4 warps × 8 rows in one chunk, and each lane's four
//     columns written as 4-byte stores: the realignment's shuffles and
//     branches cost more issue slots than they save once the arithmetic
//     (3·E operations an output) is the limit.
// pairwise_dist.py's _emulate repeats the tiles and either design's stores
// on the CPU for the tests.
#include <stdint.h>

#include "kbest.cuh"
#include "smem_grant.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 32;   // tile rows
constexpr int kCols = 128;  // tile columns, 4 a lane

// Words of one shifted copy of a window of n points and the lag span.
__host__ __device__ inline int window_words(int n, int span) {
  return (n + span + 3) & ~3;
}

// win[s·P + u] = x[base + u + s] (0 past L) for u < P, s < 4.
__device__ __forceinline__ void stage_window(const float* __restrict__ x,
                                             int L, int base, int P,
                                             float* win) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    for (int u = threadIdx.x; u < P; u += blockDim.x) {
      const int g = base + u + s;
      win[s * P + u] = g < L ? __ldg(x + g) : 0.f;
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The group of row columns u0 .. u0 + 3: one 16-byte store when all four
// lie in [0, n), else the words that do.
__device__ __forceinline__ void put(float* row, int u0, int n, float a,
                                    float b, float c, float d) {
  if (u0 >= 0 && u0 + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(row + u0), make_float4(a, b, c, d));
    return;
  }
  const float g[4] = {a, b, c, d};
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (u0 + p >= 0 && u0 + p < n) __stcs(row + u0 + p, g[p]);
}

// One row of the tile: lane t holds its columns 4t .. 4t + 3 in v, n of
// the tile's columns lie inside the matrix. kVec: row + s is 16-byte
// aligned, and all 32 lanes call it.
template <bool kVec>
__device__ __forceinline__ void write_row(float* row, int s, int n,
                                          const float (&v)[4]) {
  const int lane = threadIdx.x & 31;
  if (!kVec) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * lane + c < n) row[4 * lane + c] = v[c];
    return;
  }
  float p[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) p[c] = __shfl_up_sync(kFull, v[c], 1);
  const int u0 = 4 * lane - s;
  switch (s) {
    case 0: put(row, u0, n, v[0], v[1], v[2], v[3]); break;
    case 1: put(row, u0, n, p[3], v[0], v[1], v[2]); break;
    case 2: put(row, u0, n, p[2], p[3], v[0], v[1]); break;
    default: put(row, u0, n, p[1], p[2], p[3], v[0]); break;
  }
  if (s != 0 && lane == 31) {  // the tail: this lane's last s values
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (c >= 4 - s && 124 + c < n) __stcs(row + 124 + c, v[c]);
  }
}

template <int kLaneRows, int kChunk, bool kVec>
__global__ void __launch_bounds__(kRows / kLaneRows * 32)
pairwise_dist_kernel(const float* __restrict__ x, int L, int Lp, int E,
                     int tau, float* __restrict__ D) {
  extern __shared__ __align__(16) float smem[];
  const int span = (E - 1) * tau;
  const int Pr = window_words(kRows, span);
  const int Pc = window_words(kCols, span);
  float* wr = smem;           // the rows' window, four shifted copies
  float* wc = smem + 4 * Pr;  // the columns'
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  stage_window(x, L, i0, Pr, wr);
  stage_window(x, L, j0, Pc, wc);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kLaneRows;
  const int n = min(kCols, Lp - j0);
#pragma unroll
  for (int h = 0; h < kLaneRows; h += kChunk) {
    float acc[kChunk][4];
#pragma unroll
    for (int r = 0; r < kChunk; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int e = 0, o = 0; e < E; ++e, o += tau) {
      const int s = o & 3;
      const float* ws = wr + s * Pr + (o - s) + r0 + h;
      const float4 b4 = ld4(wc + s * Pc + (o - s) + 4 * lane);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      float a[kChunk];
      if constexpr (kChunk % 4 == 0) {
#pragma unroll
        for (int r = 0; r < kChunk; r += 4) {
          const float4 a4 = ld4(ws + r);
          a[r] = a4.x;
          a[r + 1] = a4.y;
          a[r + 2] = a4.z;
          a[r + 3] = a4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kChunk; ++r) a[r] = ws[r];
      }
#pragma unroll
      for (int r = 0; r < kChunk; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = kbest::add_sq(acc[r][c], a[r], b[c]);
    }
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int i = i0 + r0 + h + r;
      if (i >= Lp) break;  // the whole warp
      const size_t at = (size_t)i * Lp + j0;
      write_row<kVec>(D + at, (int)(at & 3), n, acc[r]);
    }
  }
}

template <int kLaneRows, int kChunk, bool kVec>
cudaError_t launch(const float* x, int L, int Lp, int E, int tau, float* D,
                   cudaStream_t stream) {
  static SmemGrant grant;
  const int span = (E - 1) * tau;
  const size_t smem =
      4 * (size_t)(window_words(kRows, span) + window_words(kCols, span)) *
      sizeof(float);
  const void* kernel =
      (const void*)pairwise_dist_kernel<kLaneRows, kChunk, kVec>;
  const cudaError_t err = grant_smem(kernel, grant, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lp + kCols - 1) / kCols),
                  (unsigned)((Lp + kRows - 1) / kRows));
  pairwise_dist_kernel<kLaneRows, kChunk, kVec>
      <<<grid, kRows / kLaneRows * 32, smem, stream>>>(x, L, Lp, E, tau, D);
  return cudaGetLastError();
}

}  // namespace

// x: (L,) float32. D: (Lp, Lp) float32, Lp = L - (E-1)·tau, 16-byte
// aligned. design: 0 the vector design, 1 the word design (the wrapper's
// route). Returns the launch's cudaGetLastError().
extern "C" int pairwise_dist_launch(const float* x, int L, int E, int tau,
                                    int design, float* D, void* stream) {
  if (E < 1 || tau < 1) return (int)cudaErrorInvalidValue;
  const long long Lp = L - (long long)(E - 1) * tau;
  if (Lp <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (design) {
    case 0: return (int)launch<4, 2, true>(x, L, (int)Lp, E, tau, D, st);
    case 1: return (int)launch<8, 8, false>(x, L, (int)Lp, E, tau, D, st);
  }
  return (int)cudaErrorInvalidValue;
}
