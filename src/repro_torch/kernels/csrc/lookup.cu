// Batched simplex lookup: predictions of N targets from one neighbour table.
//
// Replaces the Pallas TPU kernel repro/kernels/lookup.py::_kernel_lookup
// (wrapper lookup; paper Algorithm 3). For target n and row j < rows it
// writes
//     out[n, j] = Σ_q w[j, q] · Y[n, clamp(idx[j, q] + off, 0, L-1)]
// with the k products rounded on their own and summed left to right from
// the first (__fmul_rn / __fadd_rn), the fixed order of the plain
// version's ref.sum_last, so the bits equal it. Invalid slots carry
// idx = -1 and weight 0; the clamp keeps their read in range.
//
// Design. One thread per (n, j): the threads of a warp take consecutive
// rows j of one target, so the stores of out (N, rows) are coalesced; the
// gathers of Y hit L1/L2 (a series is a few kB).
//
// What bounds it on the H100: at the simplex path's shapes (N = 1, rows
// ≈ 1600, k = E + 1) the launch itself; by the work, the bytes of the
// table (rows·k·8), of Y and of out, and 2 operations per gathered term.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void lookup_kernel(const float* __restrict__ Y, int L, int N,
                              const int* __restrict__ idx,
                              const float* __restrict__ w, int rows, int k,
                              int off, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rows) return;
  const int* ij = idx + (size_t)j * k;
  const float* wj = w + (size_t)j * k;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const float* y = Y + (size_t)n * L;
    float acc = 0.f;
    for (int q = 0; q < k; ++q) {
      const int c = min(max(__ldg(ij + q) + off, 0), L - 1);
      const float t = __fmul_rn(__ldg(y + c), __ldg(wj + q));
      acc = q == 0 ? t : __fadd_rn(acc, t);
    }
    out[(size_t)n * rows + j] = acc;
  }
}

}  // namespace

// Y: (N, L) float32. idx, w: (rows, k) contiguous, k >= 1. out: (N, rows).
// Returns the launch's cudaGetLastError().
extern "C" int lookup_launch(const float* Y, int L, int N, const int* idx,
                             const float* w, int rows, int k, int off,
                             float* out, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kThreads - 1) / kThreads, N < kMaxGridY ? N
                                                                  : kMaxGridY);
  lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Y, L, N, idx, w, rows, k, off, out);
  return (int)cudaGetLastError();
}
