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
// Design. A block computes one 64 × 64 output tile with 256 threads, 16
// outputs each: the 32 lanes of a warp take 32 consecutive columns j of one
// row i, so each store is one 128-byte line. The two series windows the
// tile reads, x[i0 : i0 + 64 + (E-1)τ] and x[j0 : j0 + 64 + (E-1)τ], are
// staged in shared memory once; the row operand is then a broadcast and the
// column operand a conflict-free read.
//
// What bounds it on the H100: the store of the (Lp, Lp) float32 matrix
// (10.2 MB at Lp = 1598, ≈3 µs at 3.35 TB/s); the arithmetic, 3 operations
// per lag term for E·Lp² terms, is below that for E ≤ 20.
#include "kbest.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kRowThreads = 4;  // blockDim.y: tile rows taken in turn

__global__ void pairwise_dist_kernel(const float* __restrict__ x, int L,
                                     int Lp, int E, int tau,
                                     float* __restrict__ D) {
  extern __shared__ float win[];
  const int span = kTile + (E - 1) * tau;
  float* wi = win;
  float* wj = win + span;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < span;
       t += nthreads) {
    wi[t] = i0 + t < L ? x[i0 + t] : 0.f;
    wj[t] = j0 + t < L ? x[j0 + t] : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x;
  const int j = j0 + c;
  if (j >= Lp) return;
  for (int r = threadIdx.y; r < kTile && i0 + r < Lp; r += blockDim.y) {
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, wi[r + e * tau], wj[c + e * tau]);
    D[(size_t)(i0 + r) * Lp + j] = acc;
  }
}

}  // namespace

// x: (L,) float32. D: (Lp, Lp) float32, Lp = L - (E-1)·tau.
// Returns the launch's cudaGetLastError().
extern "C" int pairwise_dist_launch(const float* x, int L, int E, int tau,
                                    float* D, void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (Lp <= 0 || E < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(kTile + (E - 1) * tau) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lp + kTile - 1) / kTile;
  pairwise_dist_kernel<<<dim3(tiles, tiles), dim3(kTile, kRowThreads), smem,
                         (cudaStream_t)stream>>>(x, L, Lp, E, tau, D);
  return (int)cudaGetLastError();
}
