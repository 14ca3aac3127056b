// S-Map weighted Gram matrices and moments for every (query row, θ, target).
//
// Replaces the Pallas TPU kernel repro/kernels/smap_gram.py::_kernel
// (wrapper smap_gram). For B library series x_b (each (L,)), targets Y
// (N, L) shared by every library or (B, N, L) one set per library, and
// rows = L - (E-1)τ - Tp library points, it writes
//     G[b, j, t, p, q] = Σ_{i<rows} w_ij A_i[p] A_i[q]      (E+1, E+1)
//     M[b, j, t, n, p] = Σ_{i<rows} w_ij y_n[i + off] A_i[p]  (N, E+1)
// with A_i = [1, x_i, x_{i+τ}, …, x_{i+(E-1)τ}], off = (E-1)τ + Tp,
// w_ij = exp(-θ_t · d_ij / d̄_j) (0 for i == j under exclude_self), and
// d_ij the Euclidean distance of the embedded points: the strict chain of
// pairwise_dist.cu, then a correctly rounded root, so every d_ij equals the
// plain version's bits. d̄_j is the mean of d_ij over i < rows (self's
// zero included); d̄_j ≤ 1e-30 (a constant series) divides by 1 instead.
//
// Design. Two kernels on one stream.
//  Phase 0, smap_dbar_kernel: one warp per query row sums its rows
//  distances (lane-strided, then a shuffle tree) into d̄_j.
//  Phase 1, smap_gram_kernel: for each (library, θ) a tiled product
//  C = W · R of W (rows × rows) and R = [A_i ⊗ A_i | y_n[i]·A_i]
//  (rows × ((E+1)² + N(E+1))). A block owns 64 query rows × 64 columns of
//  C and walks the library in steps of 32 points; each step forms its
//  W tile from the series (held whole in shared memory) and d̄, and its R
//  tile from the series and Y, both in shared memory only: neither W nor
//  R ever exists in device memory. 256 threads each keep 4 × 4 sums,
//  FP32 FMAs on the CUDA cores; each step's 32 products go into a partial
//  sum that is then added to the running one, which keeps the rounding
//  error of a 1600-term sum near that of a blocked sum. The columns of C
//  are G's and M's own row-major layouts, so the results are written
//  query-major, straight into (rows, T, E+1, E+1) and (rows, T, N, E+1).
//  Every (library, θ) is independent and its sums run in a fixed order, so
//  a library's G and M are the same bits at any batch size B.
//
// What bounds it on the H100: operations. The product is
// 2·rows²·T·((E+1)² + N(E+1)) FP32 flops per library (3.2 GFLOP for one
// library at E = 3, N = 154, rows = 1597), against ≤ 4 MB of output. The
// W tile costs E·3 + ~25 operations per entry (distance, root, division,
// expf) and is formed again for each 64-column tile of C; with N = 1 (the
// θ-sweep) it, and not the FMAs, is most of the work.
#include "kbest.cuh"

namespace {

constexpr int kBM = 64;    // query rows of a block
constexpr int kBN = 64;    // columns of C of a block
constexpr int kBK = 32;    // library points per step
constexpr int kTX = 16;    // blockDim.x: column groups
constexpr int kTY = 16;    // blockDim.y: row groups
constexpr int kThreads = kTX * kTY;
constexpr int kMaxThetas = 64;
constexpr float kDbarTiny = 1e-30f;

struct Thetas {
  float neg[kMaxThetas];  // -θ_t
};

// d_ij = sqrt_rn(max(Σ_e fl((x[i+eτ] - x[j+eτ])²), 0)), the plain version's
// strict chain and root.
__device__ __forceinline__ float embed_dist(const float* __restrict__ x,
                                            int i, int j, int E, int tau) {
  float acc = 0.f;
  for (int e = 0; e < E; ++e)
    acc = kbest::add_sq(acc, x[j + e * tau], x[i + e * tau]);
  return __fsqrt_rn(acc > 0.f ? acc : 0.f);
}

// Phase 0: dbar[b, j] = mean_i d_ij, or 1 where that mean is ≤ 1e-30.
__global__ void smap_dbar_kernel(const float* __restrict__ X, int L,
                                 int rows, int E, int tau,
                                 float* __restrict__ dbar) {
  const int warps = blockDim.x >> 5;
  const int j = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (j >= rows) return;
  const float* x = X + (size_t)b * L;
  float s = 0.f;
  for (int i = lane; i < rows; i += 32)
    s = __fadd_rn(s, embed_dist(x, i, j, E, tau));
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kbest::kFull, s, o));
  if (lane == 0) {
    const float mean = __fdiv_rn(s, (float)rows);
    dbar[(size_t)b * rows + j] = mean > kDbarTiny ? mean : 1.f;
  }
}

// A_i[p] of the design matrix: 1 for p = 0, else x[i + (p-1)τ].
__device__ __forceinline__ float design(const float* x, int i, int p,
                                        int tau) {
  return p == 0 ? 1.f : x[i + (p - 1) * tau];
}

// Phase 1. grid (B·T, row tiles, column tiles), block (kTX, kTY).
__global__ void __launch_bounds__(kThreads)
smap_gram_kernel(const float* __restrict__ X, int L,
                 const float* __restrict__ Y, long long y_lib_stride, int N,
                 Thetas th, int T, const float* __restrict__ dbar, int E,
                 int tau, int Tp, int rows, int exclude_self,
                 float* __restrict__ G, float* __restrict__ M) {
  extern __shared__ float smem[];
  float* ws = smem;                 // [kBK][kBM] weights
  float* rs = ws + kBK * kBM;       // [kBK][kBN] R entries
  float* xs = rs + kBK * kBN;       // [L] this library's series
  const int b = blockIdx.x / T;
  const int t = blockIdx.x - b * T;
  const int j0 = blockIdx.y * kBM;
  const int c0 = blockIdx.z * kBN;
  const int E1 = E + 1;
  const int GG = E1 * E1;
  const int C = GG + N * E1;
  const int off = (E - 1) * tau + Tp;
  const float neg_theta = th.neg[t];
  const float* y = Y + (size_t)b * (size_t)y_lib_stride;
  const float* db = dbar + (size_t)b * rows;
  const int tid = threadIdx.y * kTX + threadIdx.x;

  for (int i = tid; i < L; i += kThreads) xs[i] = X[(size_t)b * L + i];
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int i0 = 0; i0 < rows; i0 += kBK) {
    // W tile: entry (k, r) is w between library point i0 + k and query
    // row j0 + r; 0 past the library, past the rows, and on the diagonal
    // under leave-one-out.
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int k = e / kBM, r = e - k * kBM;
      const int i = i0 + k, j = j0 + r;
      float w = 0.f;
      if (i < rows && j < rows && !(exclude_self && i == j)) {
        const float ratio = __fdiv_rn(embed_dist(xs, i, j, E, tau), db[j]);
        w = expf(__fmul_rn(neg_theta, ratio));
      }
      ws[e] = w;
    }
    // R tile: entry (k, c) is column c0 + c of R at library point i0 + k.
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, c = e - k * kBN;
      const int i = i0 + k, col = c0 + c;
      float v = 0.f;
      if (i < rows && col < C) {
        if (col < GG) {
          const int p = col / E1, q = col - p * E1;
          v = __fmul_rn(design(xs, i, p, tau), design(xs, i, q, tau));
        } else {
          const int m = col - GG;
          const int n = m / E1, p = m - n * E1;
          v = __fmul_rn(y[(size_t)n * L + i + off], design(xs, i, p, tau));
        }
      }
      rs[e] = v;
    }
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ws[k * kBM + threadIdx.y + kTY * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = rs[k * kBN + threadIdx.x + kTX * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[r][c] = __fmaf_rn(a[r], v[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], part[r][c]);
    __syncthreads();
  }

  const int NE1 = N * E1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + threadIdx.y + kTY * r;
    if (j >= rows) continue;
    const size_t q = ((size_t)b * rows + j) * T + t;  // (b, j, t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + threadIdx.x + kTX * c;
      if (col >= C) continue;
      if (col < GG)
        G[q * GG + col] = acc[r][c];
      else
        M[q * NE1 + (col - GG)] = acc[r][c];
    }
  }
}

}  // namespace

// X: (B, L) float32 library series. Y: targets, (N, L) float32 for
// y_lib_stride = 0 or (B, N, L) for y_lib_stride = N·L. thetas: T host
// floats. dbar: (B, rows) float32 scratch. G: (B, rows, T, E+1, E+1),
// M: (B, rows, T, N, E+1), float32, rows = L - (E-1)·tau - Tp.
// Returns the first nonzero cudaError_t of the two launches, or 0.
extern "C" int smap_gram_launch(const float* X, int B, int L, const float* Y,
                                long long y_lib_stride, int N,
                                const float* thetas, int T, int E, int tau,
                                int Tp, int exclude_self, float* dbar,
                                float* G, float* M, void* stream) {
  const int rows = L - (E - 1) * tau - Tp;
  if (B < 1 || N < 1 || E < 1 || tau < 1 || Tp < 0 || rows <= 0 || T < 1 ||
      T > kMaxThetas)
    return (int)cudaErrorInvalidValue;
  Thetas th;
  for (int t = 0; t < T; ++t) th.neg[t] = -thetas[t];
  cudaStream_t s = (cudaStream_t)stream;

  constexpr int kDbarWarps = 8;
  smap_dbar_kernel<<<dim3((rows + kDbarWarps - 1) / kDbarWarps, B),
                     32 * kDbarWarps, 0, s>>>(X, L, rows, E, tau, dbar);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)(kBK * (kBM + kBN) + L) * sizeof(float);
  err = cudaFuncSetAttribute(smap_gram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C = (E + 1) * (E + 1) + N * (E + 1);
  const dim3 grid(B * T, (rows + kBM - 1) / kBM, (C + kBN - 1) / kBN);
  smap_gram_kernel<<<grid, dim3(kTX, kTY), smem, s>>>(
      X, L, Y, y_lib_stride, N, th, T, dbar, E, tau, Tp, rows, exclude_self,
      G, M);
  return (int)cudaGetLastError();
}
