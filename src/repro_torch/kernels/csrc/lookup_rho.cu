// Fused simplex lookup + Pearson ρ for a batch of neighbour tables.
//
// Replaces the Pallas TPU kernel repro/kernels/lookup.py::_kernel_rho (with
// _gather_tile; wrapper lookup_rho). For table b (rows × k indices I and
// weights W) and target n it forms the prediction
//     yhat[j] = Σ_q W[b, j, q] · Y[n, clamp(I[b, j, q] + off, 0, L-1)]
// and returns the Pearson correlation of yhat with the aligned truth
// Y[n, j + off] over j < rows, or 0 where a variance is 0. yhat is never
// stored. Two target modes:
//   - all targets: out (B, Nt), table b against every target row of Y;
//   - own target:  out (B,),    table b against target b only (the ρ(E)
//     sweep of the optimal-E search).
// Invalid slots carry I = -1 and W = 0; the clamp keeps their read in range.
//
// Design. A block holds one table and up to TN targets (blockDim.x) and
// splits the rows over TJ thread rows (blockDim.y). Each thread keeps
// running Welford moments (means, M2 of yhat and truth, co-moment) over its
// rows; the TJ partial moments are then merged with the Chan/Schubert–Gertz
// pairwise formula, as the TPU kernel merges its tiles. In all-targets mode
// the caller passes Y transposed (L, Nt) so the 32 targets of a warp read
// consecutive words; indices and weights are the same for the whole warp.
// The result of (b, n) does not depend on B.
//
// What bounds it on the H100: the gathers. Every (b, n, j, q) reads one
// target value (B·Nt·rows·k loads, mostly L1/L2 hits since Y is small) and
// the tables are read once per target tile; the bytes a launch must move
// (tables + Y + out) are small, so its bound is the float32 work,
// 2 operations per gathered term plus the moment updates.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Moments {
  float n, ma, mb, m2a, m2b, c;
};

__device__ __forceinline__ Moments merge(Moments x, Moments y) {
  const float n = x.n + y.n;
  if (y.n == 0.f) return x;
  if (x.n == 0.f) return y;
  const float da = y.ma - x.ma;
  const float db = y.mb - x.mb;
  const float f = x.n * y.n / n;
  Moments r;
  r.n = n;
  r.ma = x.ma + da * y.n / n;
  r.mb = x.mb + db * y.n / n;
  r.m2a = x.m2a + y.m2a + da * da * f;
  r.m2b = x.m2b + y.m2b + db * db * f;
  r.c = x.c + y.c + da * db * f;
  return r;
}

__global__ void lookup_rho_kernel(const float* __restrict__ Y, long long sn,
                                  long long sc, int L, int Nt,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w, int rows, int k,
                                  int off, int own, float* __restrict__ out) {
  __shared__ Moments part[kThreads];
  const int TN = blockDim.x;
  const int TJ = blockDim.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x;
  const int n = own ? b : blockIdx.y * TN + tx;
  const bool live = own || n < Nt;

  Moments m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float* y = Y + (size_t)n * sn;
    const int* ib = idx + (size_t)b * rows * k;
    const float* wb = w + (size_t)b * rows * k;
    for (int j = ty; j < rows; j += TJ) {
      float yh = 0.f;
      for (int q = 0; q < k; ++q) {
        const int c = min(max(__ldg(ib + (size_t)j * k + q) + off, 0), L - 1);
        yh = __fadd_rn(yh, __fmul_rn(__ldg(wb + (size_t)j * k + q),
                                     __ldg(y + (size_t)c * sc)));
      }
      const float yt = __ldg(y + (size_t)(j + off) * sc);
      m.n += 1.f;
      const float da = yh - m.ma;
      m.ma += da / m.n;
      const float db = yt - m.mb;
      m.mb += db / m.n;
      m.m2a += da * (yh - m.ma);
      m.m2b += db * (yt - m.mb);
      m.c += da * (yt - m.mb);
    }
  }
  const int tid = ty * TN + tx;
  part[tid] = m;
  for (int h = TJ / 2; h >= 1; h /= 2) {  // TJ is a power of two
    __syncthreads();
    if (ty < h) part[tid] = merge(part[tid], part[(ty + h) * TN + tx]);
  }
  __syncthreads();
  if (ty == 0 && live) {
    const Moments r = part[tx];
    const float denom = sqrtf(r.m2a * r.m2b);
    const float rho = denom > 0.f ? r.c / fmaxf(denom, 1e-30f) : 0.f;
    out[own ? (size_t)b : (size_t)b * Nt + n] = rho;
  }
}

}  // namespace

// Y element (n, c) is Y[n·sn + c·sc]. idx, w: (B, rows, k) contiguous.
// own != 0: out (B,), table b against target b; else out (B, Nt).
// tn · tj must be at most 256, tj a power of two.
// Returns the launch's cudaGetLastError().
extern "C" int lookup_rho_launch(const float* Y, long long sn, long long sc,
                                 int L, int Nt, const int* idx, const float* w,
                                 int B, int rows, int k, int off, int own,
                                 int tn, int tj, float* out, void* stream) {
  if (tn * tj > kThreads || tj < 1 || (tj & (tj - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(tn, tj);
  const dim3 grid(B, own ? 1 : (Nt + tn - 1) / tn);
  lookup_rho_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      Y, sn, sc, L, Nt, idx, w, rows, k, off, own, out);
  return (int)cudaGetLastError();
}
