// Incremental multi-E all-kNN for a whole (N, L) panel in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_multi_e.py::_kernel
// (wrapper all_knn_multi_e). For every series s, level e (E = e + 1) and
// row i it emits the k_e nearest columns of the delay-embedding distance
// D_E[i, j] = D_{E-1}[i, j] + (x[i+eτ] - x[j+eτ])^2, selected in
// (value, index) order, as (N, E_max, L, k_max) tables with dist = inf /
// idx = -1 outside each level's (Lp_E, k_E) block.
//
// Design. The TPU kernel walks column tiles in order and carries the
// running k-best in its revisited output block; Hopper runs blocks in no
// order, so here one warp owns one row and walks every column itself, 32
// columns at a time (one per lane): per column it accumulates the lag
// terms level by level (the strict chain of kbest.cuh, so the bits equal
// the reference's) and offers the level's value to that level's k-best
// list (kbest::warp_offer). Masked columns (past the level cap mx[e], and
// self) are offered as +inf with their real index, which reproduces the
// reference's positional fill on rows with fewer valid candidates than k.
// The lists (levels × k_max × 8 B per row) live in shared memory; when all
// levels do not fit the block's budget, the levels are taken in chunks and
// the column walk is repeated per chunk, recomputing the lag sum below the
// chunk (any k up to a few thousand fits that way).
//
// What bounds it on the H100: float32 ALU work, 3 operations per lag term
// for N·E_max·L² terms (≈0.35 ms at 67 TFLOP/s for 154 × 20 × 1600²)
// against writing the tables, N·E_max·L·k_max·8 B (≈0.26 ms at 3.35 TB/s
// for k_max = 22). Each lag term also costs a comparison with the level's
// k-th best, and each insertion a few warp-wide steps.
#include "kbest.cuh"

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
