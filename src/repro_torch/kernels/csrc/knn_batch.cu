// Library-batched all-kNN at one embedding dimension E, one launch for B
// series.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_batch.py::_kernel
// (wrapper all_knn_batch). For series b and embedded row i < Lp it emits
// the k nearest columns j < Lp of D[i, j] = Σ_lag (x[i+lag·τ] - x[j+lag·τ])^2
// in (value, index) order as (B, Lp, k) tables; columns past the cap mx,
// and self, are offered as +inf with their real index (the reference's
// positional fill). Each series is computed by its own blocks with the same
// arithmetic at any B, so the tables are bit-invariant in B.
//
// Design. As knn_multi_e.cu: one warp owns one row and walks every column,
// 32 at a time, in a loop that replaces the TPU kernel's sequential column
// grid axis, offering each lane's candidate to the row's k-best list in
// shared memory (kbest::warp_offer), so any k that fits one block's shared
// memory works.
//
// What bounds it on the H100: float32 ALU work, 3 operations per lag term
// for B·E·Lp² terms (≈0.05 ms at 67 TFLOP/s for 154 × 3 × 1598²); the
// tables (B·Lp·k·8 B) are small. Each column also costs a comparison with
// the row's k-th best.
#include "kbest.cuh"

namespace {

__global__ void knn_batch_kernel(const float* __restrict__ X, int L, int Lp,
                                 int E, int tau, int k, int mx,
                                 int exclude_self, int row_blocks,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / row_blocks;
  const int i = (blockIdx.x % row_blocks) * W + warp;  // this warp's row
  if (i >= Lp) return;  // whole warp: no block-wide barrier below
  const float* x = X + (size_t)b * L;
  float* sd = reinterpret_cast<float*>(smem) + warp * k;
  int* si = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + W * k) +
            warp * k;

  kbest::warp_init(sd, si, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const int jr = live ? j : 0;  // in-range read for idle lanes
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, __ldg(x + i + e * tau),
                          __ldg(x + jr + e * tau));
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(sd, si, k, live, masked ? INFINITY : acc, j);
  }
  const size_t base = ((size_t)b * Lp + i) * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = __fsqrt_rn(sd[q]);
    out_i[base + q] = si[q];
  }
}

}  // namespace

// X: (B, L) float32. out_d, out_i: (B, Lp, k), Lp = L - (E-1)·tau.
// One warp per row, warps_per_block rows per block.
// Returns the launch's cudaGetLastError().
extern "C" int knn_batch_launch(const float* X, int B, int L, int E, int tau,
                                int k, int mx, int exclude_self,
                                int warps_per_block, float* out_d, int* out_i,
                                void* stream) {
  const int Lp = L - (E - 1) * tau;
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (Lp + warps_per_block - 1) / warps_per_block;
  knn_batch_kernel<<<(unsigned)B * row_blocks, warps_per_block * 32, smem,
                     (cudaStream_t)stream>>>(X, L, Lp, E, tau, k, mx,
                                             exclude_self, row_blocks, out_d,
                                             out_i);
  return (int)cudaGetLastError();
}
