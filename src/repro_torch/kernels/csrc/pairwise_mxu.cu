// Squared pairwise distances of one series' delay embedding by norm
// expansion (the matrix-unit variant).
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_dist.py::_kernel_mxu
// (wrapper pairwise_distances(variant="mxu")). For embedded rows i, j < Lp
// of the mean-centered series xc (centered by the wrapper, as the TPU
// wrapper centers it) it writes
//     D[i, j] = max(‖z_i‖² + ‖z_j‖² − 2⟨z_i, z_j⟩, 0),   z_i[k] = xc[i + kτ].
// The embedding is built in the kernel from the 1-D series (the fusion of
// the paper's Algorithm 1 is kept) and the cross term is an FP32 sum of
// FMAs (__fmaf_rn: the build's --fmad=false does not touch explicit FMAs)
// in the kernel's own body. The TPU pads E to 128 for its matrix unit; here
// the inner product runs over the E lags and no further. Never bit-equal to
// the vpu kernel: results are held to a tolerance relative to
// ‖z_i‖² + ‖z_j‖².
//
// Design. A block computes one 64 × 64 output tile with 16 × 16 threads, a
// 4 × 4 register tile each (rows ty + 16a, columns tx + 16b). The two
// series windows the tile reads are staged in shared memory as in
// pairwise_dist.cu, and the tile's 64 row norms and 64 column norms are
// formed there once; each lag then costs a thread 8 shared reads for 16
// FMAs.
//
// What bounds it on the H100: the store of the (Lp, Lp) float32 matrix
// (398 MB at Lp = 9,981, ≈0.12 ms at 3.35 TB/s); the arithmetic, 2·E + 4
// operations per entry (4.4 GFLOP there at E = 20, ≈0.07 ms at
// 67 TFLOP/s), is below that.
#include <cuda_runtime.h>
#include <math.h>

#include "smem_grant.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kSide = 16;  // threads per tile side; kTile / kSide outputs each
constexpr int kReg = kTile / kSide;

__global__ void pairwise_mxu_kernel(const float* __restrict__ xc, int L,
                                    int Lp, int E, int tau,
                                    float* __restrict__ D) {
  extern __shared__ float win[];
  const int span = kTile + (E - 1) * tau;
  float* wi = win;
  float* wj = win + span;
  float* ni = wj + span;
  float* nj = ni + kTile;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int t = threadIdx.y * kSide + threadIdx.x;
  for (int u = t; u < span; u += kSide * kSide) {
    wi[u] = i0 + u < L ? xc[i0 + u] : 0.f;
    wj[u] = j0 + u < L ? xc[j0 + u] : 0.f;
  }
  __syncthreads();
  if (t < 2 * kTile) {  // one norm per thread: rows, then columns
    const float* w = t < kTile ? wi + t : wj + (t - kTile);
    float n = 0.f;
    for (int e = 0; e < E; ++e) n = __fmaf_rn(w[e * tau], w[e * tau], n);
    (t < kTile ? ni : nj)[t % kTile] = n;
  }
  __syncthreads();
  float acc[kReg][kReg] = {};
  for (int e = 0; e < E; ++e) {
    float a[kReg], b[kReg];
#pragma unroll
    for (int r = 0; r < kReg; ++r) {
      a[r] = wi[threadIdx.y + kSide * r + e * tau];
      b[r] = wj[threadIdx.x + kSide * r + e * tau];
    }
#pragma unroll
    for (int r = 0; r < kReg; ++r)
#pragma unroll
      for (int c = 0; c < kReg; ++c)
        acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < kReg; ++r) {
    const int ri = threadIdx.y + kSide * r;
    if (i0 + ri >= Lp) break;
#pragma unroll
    for (int c = 0; c < kReg; ++c) {
      const int cj = threadIdx.x + kSide * c;
      if (j0 + cj < Lp) {
        const float v = __fsub_rn(__fadd_rn(ni[ri], nj[cj]),
                                  __fmul_rn(2.f, acc[r][c]));
        D[(size_t)(i0 + ri) * Lp + j0 + cj] = fmaxf(v, 0.f);
      }
    }
  }
}

SmemGrant g_mxu;

}  // namespace

// xc: (L,) float32, the mean-centered series. D: (Lp, Lp) float32,
// Lp = L - (E-1)·tau. Returns the launch's cudaGetLastError().
extern "C" int pairwise_mxu_launch(const float* xc, int L, int E, int tau,
                                   float* D, void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (Lp <= 0 || E < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)(kTile + (E - 1) * tau) + 2 * kTile) * sizeof(float);
  const cudaError_t err =
      grant_smem((const void*)pairwise_mxu_kernel, g_mxu, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lp + kTile - 1) / kTile;
  pairwise_mxu_kernel<<<dim3(tiles, tiles), dim3(kSide, kSide), smem,
                        (cudaStream_t)stream>>>(xc, L, Lp, E, tau, D);
  return (int)cudaGetLastError();
}
