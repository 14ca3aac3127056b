// Incremental multi-E all-kNN for a whole (N, L) panel in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_multi_e.py::_kernel
// (wrapper all_knn_multi_e). For every series s, level e (E = e + 1) and
// row i it emits the k_e nearest columns of the delay-embedding distance
// D_E[i, j] = D_{E-1}[i, j] + (x[i+eτ] - x[j+eτ])^2, selected in
// (value, index) order, as (N, E_max, L, k_max) tables with dist = inf /
// idx = -1 outside each level's (Lp_E, k_E) block.
//
// The TPU kernel walks column tiles in order and carries the running
// k-best in its revisited output block; Hopper runs blocks in no order, so
// here one warp owns one row and walks every column itself, 32 columns at a
// time (one per lane), accumulating the lag terms level by level (the
// strict chain of kbest.cuh, so the bits equal the reference's) and
// offering each level's value to that level's k-best. Masked columns (past
// the level cap mx[e], and self) are offered as +inf with their real
// index, which reproduces the reference's positional fill on rows with
// fewer valid candidates than k.
//
// What bounds it on the H100: float32 ALU work, 3 operations per lag term
// for N·E_max·L² terms (≈0.35 ms at 67 TFLOP/s for 154 × 20 × 1600²)
// against writing the tables, N·E_max·L·k_max·8 B (≈0.26 ms at 3.35 TB/s
// for k_max = 22). Beside the lag chain, every term is compared with its
// level's k-th best, and the candidates that beat it have to be inserted.
//
// Two designs, picked by the wrapper by shape; both are bit-equal to the
// reference.
//  knn_multi_e_select_kernel (k_max ≤ 32, E_max ≤ 32): two passes of
//  buffered warp selection (warp_select.cuh). Inserting each candidate on
//  its own costs ~30 dependent warp instructions, and a row-level sees ~116
//  insertions at k = 22 on this data; buffering behind a threshold that only
//  moves at a flush still lets ~38 of the 50 column groups and ~160
//  candidates through, with ~5 flushes (counted on the CPU on the smoke's
//  panel). So pass 1 walks the columns, two lag chains a lane, keeping only
//  each lane's two smallest values per level (min/max only, no vote, no
//  branch); the k-th smallest of a level's 64 such values bounds its k-th
//  nearest from above and lets ~24 candidates through at k = 22 (at most 39
//  in that count). Pass 2 walks again with that bound as the threshold in a
//  register: at every level each group of 32 columns appends the lanes that
//  pass to a 64-slot buffer per (warp, level) in shared memory by one ballot
//  and popc, with no branch (a vote and branch per level to skip the empty
//  appends cost more than they saved); a buffer past half full after a group
//  is sorted bitonically with shuffles under the (value, index) key and cut
//  to its 32 first, which also tightens the threshold, and every buffer is
//  sorted once at the end. The series is staged once per block in shared
//  memory and the row's lag values sit in registers; the levels are unrolled
//  (a template on E_max ≤ 8, 16, 20, 24, 32, predicated past E_max), as
//  register arrays need compile-time indices, and a column group that no cap
//  or self masks skips the mask.
//  knn_multi_e_kernel (any k; the shapes the first does not take): the
//  lists live in shared memory and each candidate that beats the k-th
//  best is inserted by the whole warp (kbest::warp_offer); when all levels'
//  lists do not fit the block's budget, the levels are taken in chunks and
//  the column walk is repeated per chunk, recomputing the lag sum below the
//  chunk (any k up to a few thousand fits that way).
#include <limits.h>

#include "kbest.cuh"
#include "warp_select.cuh"

namespace {

struct Levels {
  int k[kbest::kMaxLevels];   // neighbours kept at level e
  int mx[kbest::kMaxLevels];  // inclusive column cap at level e
};

__global__ void knn_multi_e_kernel(const float* __restrict__ xpad, int Lx,
                                   int L, int E_max, int tau, Levels lv,
                                   int k_max, int exclude_self, int chunk,
                                   int row_blocks, float* __restrict__ out_d,
                                   int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x / row_blocks;
  const int i = (blockIdx.x % row_blocks) * W + warp;  // this warp's row
  const float* x = xpad + (size_t)s * Lx;
  const size_t per_warp = (size_t)chunk * k_max;
  float* sd = reinterpret_cast<float*>(smem) + warp * per_warp;
  int* si = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) +
                                   W * per_warp) + warp * per_warp;
  // Row i has valid coordinates at levels [0, e_valid): i < L - e·tau.
  const int e_valid = i < L ? min(E_max, (L - 1 - i) / tau + 1) : 0;
  int written = 0;  // levels [0, written) of row i are in the output

  for (int c0 = 0; c0 < E_max; c0 += chunk) {
    const int c1 = min(c0 + chunk, E_max);
    const int e_end = min(c1, e_valid);
    if (e_end <= c0) break;  // this row is past every later level too
    for (int e = c0; e < c1; ++e)
      kbest::warp_init(sd + (e - c0) * k_max, si + (e - c0) * k_max,
                       lv.k[e]);
    for (int jb = 0; jb < L; jb += 32) {
      const int j = jb + lane;
      const bool live = j < L;
      const int jr = live ? j : 0;  // in-range read for idle lanes
      float acc = 0.f;
      for (int e = 0; e < e_end; ++e) {
        acc = kbest::add_sq(acc, __ldg(x + i + e * tau),
                            __ldg(x + jr + e * tau));
        if (e >= c0) {
          const bool masked = j > lv.mx[e] || (exclude_self && j == i);
          kbest::warp_offer(sd + (e - c0) * k_max, si + (e - c0) * k_max,
                            lv.k[e], live, masked ? INFINITY : acc, j);
        }
      }
    }
    // Row i of each level is k_max contiguous slots of the output; the
    // squared distances are rooted on the way out.
    for (int e = c0; e < c1; ++e) {
      const bool row_ok = i < L - e * tau;
      const size_t base = (((size_t)s * E_max + e) * L + i) * k_max;
      for (int q = lane; q < k_max; q += 32) {
        const bool ok = row_ok && q < lv.k[e];
        out_d[base + q] = ok ? __fsqrt_rn(sd[(e - c0) * k_max + q])
                             : INFINITY;
        out_i[base + q] = ok ? si[(e - c0) * k_max + q] : -1;
      }
    }
    written = c1;
    __syncwarp();
  }
  // Levels this row never reached (it is past their Lp) are all padding.
  if (i < L) {
    for (int e = written; e < E_max; ++e) {
      const size_t base = (((size_t)s * E_max + e) * L + i) * k_max;
      for (int q = lane; q < k_max; q += 32) {
        out_d[base + q] = INFINITY;
        out_i[base + q] = -1;
      }
    }
  }
}

constexpr int kSelWarps = 8;  // rows (warps) per block of the selection
constexpr int kBuf = 64;      // buffer slots per (warp, level)

// Pass 2 over one group of 32 columns (one per lane): at every level, the
// lanes whose (v, j) beats the level's threshold (tv, ti) are appended to
// its buffer by one ballot and popc — no vote and branch per level, which
// cost more than the appends they skipped — and after the group each
// buffer that could not take another group (fill > 32 of 64) is merged
// into its 32 first, which also tightens the threshold. kMask: the group
// holds self, a column past L or past some level's cap (else no column of
// it is masked at any level); a lane past L offers NaN, which passes no
// threshold. lt: this lane's %lanemask_lt; cnt: the buffers' fills (the
// same in every lane).
template <int kLevels, bool kMask>
__device__ __forceinline__ void walk_group(
    const float* xj, const float* xi, int e_valid, int tau, const Levels& lv,
    int j, int jm, bool live, unsigned lt, float* tv, int* ti, int* cnt,
    float* bufv, int* bufi) {
  const float masked = live ? INFINITY : NAN;
  float acc = 0.f;
  unsigned full = 0;  // the levels whose buffer must be merged
#pragma unroll
  for (int e = 0; e < kLevels; ++e) {
    if (e >= e_valid) break;
    acc = kbest::add_sq(acc, xi[e], xj[e * tau]);
    const float v = kMask && jm > lv.mx[e] ? masked : acc;
    const bool take = kbest::before(v, j, tv[e], ti[e]);
    const unsigned b = __ballot_sync(kbest::kFull, take);
    if (take) {
      const int pos = cnt[e] + __popc(b & lt);
      bufv[e * kBuf + pos] = v;
      bufi[e * kBuf + pos] = j;
    }
    cnt[e] += __popc(b);
    full |= (cnt[e] > kBuf - 32 ? 1u : 0u) << e;
  }
  if (full) {
#pragma unroll
    for (int e = 0; e < kLevels; ++e) {
      if (!((full >> e) & 1)) continue;
      __syncwarp();
      const wsel::Key t = wsel::compact(bufv + e * kBuf, bufi + e * kBuf,
                                        cnt[e], lv.k[e]);
      tv[e] = t.v;
      ti[e] = t.i;
      cnt[e] = 32;
    }
  }
}

// Pass 1 over two groups of 32 columns (j and j + 32 a lane: two lag
// chains side by side): each lane's two smallest values per level, the
// pair (lo ≤ hi) merged into (m1 ≤ m2) by five min/max. A lane past L, or
// a masked column, counts as +inf (it raises no bound).
template <int kLevels, bool kMask>
__device__ __forceinline__ void bound_group(const float* xj, const float* xi,
                                            int e_valid, int tau,
                                            const Levels& lv, int jm0,
                                            int jm1, float* m1, float* m2) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int e = 0; e < kLevels; ++e) {
    if (e >= e_valid) break;
    a0 = kbest::add_sq(a0, xi[e], xj[e * tau]);
    a1 = kbest::add_sq(a1, xi[e], xj[32 + e * tau]);
    const float v0 = kMask && jm0 > lv.mx[e] ? INFINITY : a0;
    const float v1 = kMask && jm1 > lv.mx[e] ? INFINITY : a1;
    const float lo = fminf(v0, v1), hi = fmaxf(v0, v1);
    m2[e] = fminf(fmaxf(m1[e], lo), fminf(m2[e], hi));
    m1[e] = fminf(m1[e], lo);
  }
}

// grid N · ⌈L / kSelWarps⌉ blocks of kSelWarps warps, one row per warp.
// Shared memory: the series (Lx + 64 floats, zero past Lx: a step reads up
// to 63 columns past the last), then per warp and level a kBuf-slot buffer
// of values, one of indices, and a fill.
template <int kLevels>
__global__ void __launch_bounds__(kSelWarps * 32, kLevels <= 24 ? 2 : 1)
knn_multi_e_select_kernel(const float* __restrict__ xpad, int Lx, int L,
                          int E_max, int tau, Levels lv, int mx_min,
                          int k_max, int exclude_self, int row_blocks,
                          float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float sel_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x / row_blocks;
  const int i = (blockIdx.x - s * row_blocks) * kSelWarps + warp;
  const int xs_len = Lx + 64;
  const int per_warp = E_max * kBuf;
  float* xs = sel_smem;
  float* bufv = xs + xs_len + warp * per_warp;
  int* bufi = reinterpret_cast<int*>(xs + xs_len + kSelWarps * per_warp) +
              warp * per_warp;
  int* fill = reinterpret_cast<int*>(xs + xs_len + 2 * kSelWarps * per_warp) +
              warp * E_max;
  const float* x = xpad + (size_t)s * Lx;
  for (int q = threadIdx.x; q < xs_len; q += blockDim.x)
    xs[q] = q < Lx ? x[q] : 0.f;
  __syncthreads();
  if (i >= L) return;
  // Row i has valid coordinates at levels [0, e_valid): i < L - e·tau.
  const int e_valid = min(E_max, (L - 1 - i) / tau + 1);
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));

  float xi[kLevels];  // the row's lag values x[i + eτ]
  float m1[kLevels], m2[kLevels];
  float tv[kLevels];  // each level's threshold: (tv, ti)
  int ti[kLevels];
  int cnt[kLevels];    // each level's buffer fill
#pragma unroll
  for (int e = 0; e < kLevels; ++e) {
    xi[e] = e < e_valid ? xs[i + e * tau] : 0.f;
    m1[e] = m2[e] = INFINITY;
  }

  // Pass 1 walks every column 64 at a time.
  for (int jb = 0; jb < L; jb += 64) {
    const int j = jb + lane;
    const int jm0 = j < L && !(exclude_self && j == i) ? j : INT_MAX;
    const int jm1 =
        j + 32 < L && !(exclude_self && j + 32 == i) ? j + 32 : INT_MAX;
    if (jb + 63 <= mx_min && !(exclude_self && i >= jb && i < jb + 64))
      bound_group<kLevels, false>(xs + j, xi, e_valid, tau, lv, jm0, jm1, m1,
                                  m2);
    else
      bound_group<kLevels, true>(xs + j, xi, e_valid, tau, lv, jm0, jm1, m1,
                                 m2);
  }
  // Each level's bound: the k-th of its 64 kept values, through the
  // level's buffer so that one copy of the sort serves every level.
#pragma unroll
  for (int e = 0; e < kLevels; ++e) {
    if (e >= e_valid) break;
    bufv[e * kBuf + lane] = m1[e];
    bufv[e * kBuf + 32 + lane] = m2[e];
  }
  __syncwarp();
  for (int e = 0; e < e_valid; ++e) {
    const float t = wsel::kth_of_64(bufv[e * kBuf + lane],
                                    bufv[e * kBuf + 32 + lane], lv.k[e]);
    __syncwarp();
    if (lane == 0) bufv[e * kBuf] = t;
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < kLevels; ++e) {
    tv[e] = e < e_valid ? bufv[e * kBuf] : 0.f;
    ti[e] = kbest::kEmpty;
  }
#pragma unroll
  for (int e = 0; e < kLevels; ++e) cnt[e] = 0;
  __syncwarp();

  // Pass 2 walks every column 32 at a time.
  for (int jb = 0; jb < L; jb += 32) {
    const int j = jb + lane;
    const bool live = j < L;
    const int jm = live && !(exclude_self && j == i) ? j : INT_MAX;
    if (jb + 31 <= mx_min && !(exclude_self && i >= jb && i < jb + 32))
      walk_group<kLevels, false>(xs + j, xi, e_valid, tau, lv, j, jm, live,
                                 lt, tv, ti, cnt, bufv, bufi);
    else
      walk_group<kLevels, true>(xs + j, xi, e_valid, tau, lv, j, jm, live,
                                lt, tv, ti, cnt, bufv, bufi);
  }
#pragma unroll
  for (int e = 0; e < kLevels; ++e)
    if (e < e_valid && lane == 0) fill[e] = cnt[e];
  __syncwarp();

  // Each level's k first of its buffer, rooted on the way out.
  for (int e = 0; e < E_max; ++e) {
    float d = INFINITY;
    int ix = -1;
    if (e < e_valid) {
      __syncwarp();
      wsel::compact(bufv + e * kBuf, bufi + e * kBuf, fill[e], lv.k[e]);
      if (lane < lv.k[e]) {
        d = __fsqrt_rn(bufv[e * kBuf + lane]);
        ix = bufi[e * kBuf + lane];
      }
    }
    if (lane < k_max) {
      const size_t base = (((size_t)s * E_max + e) * L + i) * k_max;
      out_d[base + lane] = d;
      out_i[base + lane] = ix;
    }
  }
}

template <int kLevels>
cudaError_t launch_select(const float* xpad, int N, int L, int Lx, int E_max,
                          int tau, const Levels& lv, int mx_min, int k_max,
                          int exclude_self, float* out_d, int* out_i,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(Lx + 64) * 4 +
                      (size_t)kSelWarps * E_max * (kBuf * 8 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      knn_multi_e_select_kernel<kLevels>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (L + kSelWarps - 1) / kSelWarps;
  knn_multi_e_select_kernel<kLevels>
      <<<(unsigned)N * row_blocks, kSelWarps * 32, smem, stream>>>(
          xpad, Lx, L, E_max, tau, lv, mx_min, k_max, exclude_self,
          row_blocks, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// xpad: (N, Lx) float32, each series zero-padded to Lx = L + (E_max-1)·tau.
// ks, mxs: host arrays of E_max ints. out_d, out_i: (N, E_max, L, k_max).
// One warp per row, warps_per_block rows per block; chunk levels per pass.
// Returns the launch's cudaGetLastError().
extern "C" int knn_multi_e_launch(const float* xpad, int N, int L, int Lx,
                                  int E_max, int tau, const int* ks,
                                  const int* mxs, int k_max, int exclude_self,
                                  int warps_per_block, int chunk, float* out_d,
                                  int* out_i, void* stream) {
  if (E_max < 1 || E_max > kbest::kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int e = 0; e < E_max; ++e) {
    lv.k[e] = ks[e];
    lv.mx[e] = mxs[e];
  }
  const size_t smem = (size_t)chunk * k_max * warps_per_block * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_multi_e_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (L + warps_per_block - 1) / warps_per_block;
  knn_multi_e_kernel<<<(unsigned)N * row_blocks, warps_per_block * 32, smem,
                       (cudaStream_t)stream>>>(
      xpad, Lx, L, E_max, tau, lv, k_max, exclude_self, chunk, row_blocks,
      out_d, out_i);
  return (int)cudaGetLastError();
}

// The buffered-selection kernel: the same arguments as knn_multi_e_launch
// but no block shape (kSelWarps rows per block); k_max ≤ 32, E_max ≤ 32,
// and (Lx + 64)·4 + kSelWarps·E_max·(kBuf·8 + 4) bytes of shared memory per
// block.
extern "C" int knn_multi_e_select_launch(const float* xpad, int N, int L,
                                         int Lx, int E_max, int tau,
                                         const int* ks, const int* mxs,
                                         int k_max, int exclude_self,
                                         float* out_d, int* out_i,
                                         void* stream) {
  if (E_max < 1 || E_max > 32 || k_max < 1 || k_max > 32)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  int mx_min = INT_MAX;
  for (int e = 0; e < E_max; ++e) {
    if (ks[e] < 1 || ks[e] > k_max) return (int)cudaErrorInvalidValue;
    lv.k[e] = ks[e];
    lv.mx[e] = mxs[e];
    mx_min = mxs[e] < mx_min ? mxs[e] : mx_min;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      E_max <= 8    ? launch_select<8>(xpad, N, L, Lx, E_max, tau, lv, mx_min,
                                       k_max, exclude_self, out_d, out_i, s)
      : E_max <= 16 ? launch_select<16>(xpad, N, L, Lx, E_max, tau, lv,
                                        mx_min, k_max, exclude_self, out_d,
                                        out_i, s)
      : E_max <= 20 ? launch_select<20>(xpad, N, L, Lx, E_max, tau, lv,
                                        mx_min, k_max, exclude_self, out_d,
                                        out_i, s)
      : E_max <= 24 ? launch_select<24>(xpad, N, L, Lx, E_max, tau, lv,
                                        mx_min, k_max, exclude_self, out_d,
                                        out_i, s)
                    : launch_select<32>(xpad, N, L, Lx, E_max, tau, lv,
                                        mx_min, k_max, exclude_self, out_d,
                                        out_i, s);
  return (int)err;
}
