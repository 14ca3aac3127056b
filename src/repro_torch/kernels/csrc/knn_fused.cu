// Fused all-kNN over one series: the distances and the k-best selection in
// one kernel, the (Lp, Lp) distance matrix never in global memory.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_fused.py::_kernel
// (wrapper all_knn_fused, reached by ops.all_knn(fused=True)). For every
// embedded row i < Lp it emits the k nearest columns j < Lp of
//     D[i, j] = Σ_{k<E} (x[i+kτ] − x[j+kτ])²,
// the strict chain of kbest.cuh (each subtraction, square and addition
// rounded on its own, lags in order), in (value, index) order; self
// (exclude_self) and columns past the cap mx enter as +inf with their real
// index; the roots are taken after the selection. Unlike the TPU wrapper it
// does not mean-center the series: the port's pairwise kernel and the
// reference's ref.pairwise_distances do not either, so this kernel's tables
// are bit-equal to pairwise_dist.cu followed by topk.cu.
//
// Design. The TPU kernel holds the series in VMEM and a (rows, Lp) block of
// distances for its k extraction passes. Here the whole series sits in the
// block's shared memory (up to ~56,000 points), one warp owns one row and
// walks the columns 32 at a time (one per lane), forms each distance from
// the shared series and offers it to the row's k-best list, also in shared
// memory (kbest::warp_offer). A distance lives only in a register.
//
// What bounds it on the H100: float32 ALU work, 3 operations per lag term
// for E·Lp² terms (6.0 GFLOP at L = 10,000, E = 20, ≈0.09 ms at
// 67 TFLOP/s); the traffic is the series and the tables, L·4 + Lp·k·8 bytes
// (1.7 MB there), where the two-kernel path writes and reads 4·Lp² bytes
// (398 MB) of distances. Each column also costs a comparison with the
// row's k-th best, and each insertion a few warp-wide steps.
#include "kbest.cuh"

namespace {

__global__ void knn_fused_kernel(const float* __restrict__ x, int L, int Lp,
                                 int E, int tau, int k, int mx,
                                 int exclude_self, float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = smem;
  float* sd = xs + L + warp * k;
  int* si = reinterpret_cast<int*>(xs + L + W * k) + warp * k;
  for (int u = threadIdx.x; u < L; u += blockDim.x) xs[u] = x[u];
  __syncthreads();
  const int i = blockIdx.x * W + warp;  // this warp's row
  if (i >= Lp) return;  // whole warp, after the block's only barrier

  kbest::warp_init(sd, si, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const int jr = live ? j : 0;  // in-range read for idle lanes
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[jr + e * tau]);
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(sd, si, k, live, masked ? INFINITY : acc, j);
  }
  const size_t base = (size_t)i * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = __fsqrt_rn(sd[q]);
    out_i[base + q] = si[q];
  }
}

}  // namespace

// x: (L,) float32. out_d, out_i: (Lp, k), Lp = L - (E-1)·tau. mx: the
// inclusive column cap (Lp - 1 for none). One warp per row,
// warps_per_block rows per block. Returns the launch's cudaGetLastError().
extern "C" int knn_fused_launch(const float* x, int L, int E, int tau, int k,
                                int mx, int exclude_self, int warps_per_block,
                                float* out_d, int* out_i, void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (Lp <= 0 || E < 1 || k < 1 || k > Lp) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)L + 2 * (size_t)k * warps_per_block) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      knn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  knn_fused_kernel<<<blocks, warps_per_block * 32, smem,
                     (cudaStream_t)stream>>>(x, L, Lp, E, tau, k, mx,
                                             exclude_self, out_d, out_i);
  return (int)cudaGetLastError();
}
