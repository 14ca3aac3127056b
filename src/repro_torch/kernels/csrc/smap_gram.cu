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
// What bounds it on the H100: operations. Per library the product
// C = W · R, W (rows × rows) and R = [A_i ⊗ A_i | y_n[i]·A_i]
// (rows × C, C = (E+1)² + N(E+1)), is 2·rows²·T·C flops (3.2 GFLOP at
// E = 3, N = 154, rows = 1598): 48 µs on the CUDA cores at 67 TFLOP/s,
// 20 µs as three TF32 products on the tensor cores at 495 TFLOP/s.
// Against that, each weight costs a distance (3E operations), a root, a
// division and an expf, about 50 instructions, and the output is ≤ 4 MB.
//
// Design. Five kernels on one stream per slice of libraries, four of them
// per slice of query rows j (one slice holding every row unless a single
// library's scratch would pass the wrapper's bound).
//  1a. smap_dist_kernel, a thread per (j, 4 points), the block's stretch
//      of the series in shared memory: d_ij, the strict chain and a
//      correctly rounded root, into scratch (nj × ldr per library for a
//      slice of nj query rows).
//  1b. smap_dbar_kernel, a warp per query row: d̄_j, the d_ij summed
//      lane-strided and by a shuffle tree (the fixed order of every earlier
//      version).
//  1c. smap_weights_kernel, a thread per (j, 4 points): r_ij = d_ij / d̄_j,
//      written once per (library, θ) — for the wide product already as the
//      weight exp(-θ·r_ij) in TF32 pairs (0 on the diagonal under
//      leave-one-out and past the rows), for the narrow one as the
//      θ-independent ratio.
//  2.  smap_rhs_kernel, once per slice of libraries: R transposed, Rt[c, i]
//      (C × ldr; TF32 pairs for the wide product); a block owns one column
//      c and takes its two factors' offsets once (no division per entry);
//      zero past the rows.
//  3.  The product C = W · R on the tensor cores in the 3×TF32 split:
//      v = hi + lo, hi = v rounded to TF32 (as cvt.rna, by integer
//      operations), lo = v - hi truncated to TF32; hi·hi + hi·lo + lo·hi
//      is as accurate as a float32 product (plain TF32 keeps 10 mantissa
//      bits and misses the 1e-5 bound of the tests).
//      smap_gemm_wide_kernel (C > 32 or one θ, the xmap) on wgmma: the
//      mma.sync version of this product fell well short of mma.sync's own
//      rate on the card, on its fragment reads and splits (PERF.md); wgmma
//      reads both operands straight from shared memory.
//      smap_gemm_theta_kernel (C ≤ 32, several θ: the θ-sweep) on mma.sync:
//      a block covers all of C for 64 rows and 2 θ, forming each W tile from
//      the ratios as it is staged (the expf is then the only per-entry work
//      repeated per θ), so no tile is mostly padding. Each step's products
//      of 32 library points go into a partial sum that is then added to the
//      running sum in float32 in one fixed order, so a tensor-core
//      accumulation never runs over more than 32 points. Results go straight
//      into G's and M's row-major layouts.
// Every query row's sums run in one fixed order inside its own block: no
// split-K across blocks and no atomics, so a library's G and M are the
// same bits at any batch size B and in any slice of libraries or rows.
#include <stdint.h>

#include "kbest.cuh"

namespace {

constexpr int kBK = 32;        // library points per step
constexpr int kLd = kBK + 4;   // shared row stride: conflict-free fragments
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxThetas = 64;
constexpr float kDbarTiny = 1e-30f;

struct Thetas {
  float neg[kMaxThetas];  // -θ_t
};

// v as its TF32 pair: hi is v rounded to the nearest TF32 value, ties away
// from zero (cvt.rna.tf32.f32's rounding, done with two integer operations:
// cvt itself cost ~15 % of the product's time here),
// lo = v - hi (exact) truncated to TF32. hi·hi + hi·lo + lo·hi is v·w to
// float32: the dropped lo·lo and the truncation are ≤ 2^-21 of |v·w|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kTf32 = 0xffffe000u;  // sign, exponent, 10 mantissa bits
  hi = (__float_as_uint(v) + 0x1000u) & kTf32;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi))) & kTf32;
}

// 1a. d[b, j - j_base, i] = d_ij for i < rows, 0 for rows ≤ i < ldr, for
// the nj query rows from j_base: a thread per (j, 4 points), the block's
// stretch of the series (1024 + (E-1)τ floats) and row j's lags in shared
// memory. grid (⌈ldr/1024⌉, nj, B).
__global__ void smap_dist_kernel(const float* __restrict__ X, int L, int rows,
                                 int ldr, int E, int tau, int j_base, int nj,
                                 float* __restrict__ d) {
  extern __shared__ float dsmem[];  // [E] row j's lags, then the stretch
  float* xs = dsmem + E;
  const int j = j_base + blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * 1024;
  const float* x = X + (size_t)b * L;
  for (int q = threadIdx.x; q < 1024 + (E - 1) * tau; q += blockDim.x)
    xs[q] = i0 + q < L ? x[i0 + q] : 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) dsmem[e] = x[j + e * tau];
  __syncthreads();
  const int i = i0 + 4 * threadIdx.x;
  if (i >= ldr) return;
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, dsmem[e], xs[4 * threadIdx.x + u + e * tau]);
    v[u] = i + u < rows ? __fsqrt_rn(acc > 0.f ? acc : 0.f) : 0.f;
  }
  *reinterpret_cast<float4*>(d + ((size_t)b * nj + blockIdx.y) * ldr + i) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// 1b. dbar[b, j - j_base] = d̄_j, a warp per row of the slice: the d_ij
// summed lane-strided and by a shuffle tree (the fixed order of every
// earlier version), or 1 where that mean is ≤ 1e-30. grid (⌈nj/8⌉, B),
// 8 warps.
__global__ void smap_dbar_kernel(const float* __restrict__ d, int rows,
                                 int ldr, int nj, float* __restrict__ dbar) {
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= nj) return;
  const float* r = d + ((size_t)blockIdx.y * nj + j) * ldr;
  float s = 0.f;
  for (int i = lane; i < rows; i += 32) s = __fadd_rn(s, r[i]);
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kbest::kFull, s, o));
  if (lane == 0) {
    const float mean = __fdiv_rn(s, (float)rows);
    dbar[(size_t)blockIdx.y * nj + j] = mean > kDbarTiny ? mean : 1.f;
  }
}

// 1c. A thread per (j, 4 points) of the slice: r_ij = d_ij / d̄_j, written
// for the wide product as each θ's weight exp(-θ·r_ij) in TF32 pairs Wh, Wl
// [b, t, j - j_base, i] (0 on the diagonal under leave-one-out and past the
// rows), or with Wh == nullptr as the ratio, in place of d.
// grid (⌈ldr/1024⌉, nj, B).
__global__ void smap_weights_kernel(float* __restrict__ d,
                                    const float* __restrict__ dbar, int rows,
                                    int ldr, int j_base, int nj, Thetas th,
                                    int T, int exclude_self,
                                    uint32_t* __restrict__ Wh,
                                    uint32_t* __restrict__ Wl) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int jl = blockIdx.y;
  const int j = j_base + jl;
  const int b = blockIdx.z;
  if (i >= ldr) return;
  const size_t o = ((size_t)b * nj + jl) * ldr + i;
  const float4 dv = *reinterpret_cast<const float4*>(d + o);
  const float db = dbar[(size_t)b * nj + jl];
  const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
  float r[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) r[u] = i + u < rows ? __fdiv_rn(dd[u], db) : 0.f;
  if (Wh == nullptr) {
    *reinterpret_cast<float4*>(d + o) = make_float4(r[0], r[1], r[2], r[3]);
    return;
  }
  for (int t = 0; t < T; ++t) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = i + u < rows && !(exclude_self && i + u == j);
      split(ok ? expf(__fmul_rn(th.neg[t], r[u])) : 0.f, h[u], l[u]);
    }
    const size_t w = (((size_t)b * T + t) * nj + jl) * ldr + i;
    *reinterpret_cast<uint4*>(Wh + w) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(Wl + w) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A_i[p] of the design matrix: 1 for p = 0, else x[i + (p-1)τ].
__device__ __forceinline__ float design(const float* x, int i, int p,
                                        int tau) {
  return p == 0 ? 1.f : x[i + (p - 1) * tau];
}

// 2. Rt[b, c, i] = column c of R at library point i (0 for i ≥ rows), or
// with Rh != nullptr (the wide product) as TF32 pairs Rh, Rl.
// grid (C, ⌈ldr/256⌉, B).
__global__ void smap_rhs_kernel(const float* __restrict__ X, int L,
                                const float* __restrict__ Y,
                                long long y_lib_stride, int E, int tau,
                                int Tp, int rows, int ldr, int C,
                                float* __restrict__ Rt,
                                uint32_t* __restrict__ Rh,
                                uint32_t* __restrict__ Rl) {
  const int c = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const int b = blockIdx.z;
  if (i >= ldr) return;
  const int E1 = E + 1;
  const int GG = E1 * E1;
  // Column c is f · A_i[q]: f = A_i[p] for a Gram column (p, q), f = y_n at
  // i + off for a moment column (n, q).
  const bool gram = c < GG;
  const int p = gram ? c / E1 : (c - GG) / E1;
  const int q = gram ? c - p * E1 : (c - GG) - p * E1;
  const float* x = X + (size_t)b * L;
  float v = 0.f;
  if (i < rows) {
    const float f =
        gram ? design(x, i, p, tau)
             : Y[(size_t)b * y_lib_stride + (size_t)p * L + i +
                 (E - 1) * tau + Tp];
    v = __fmul_rn(f, design(x, i, q, tau));
  }
  const size_t o = ((size_t)b * C + c) * ldr + i;
  if (Rh == nullptr)
    Rt[o] = v;
  else
    split(v, Rh[o], Rl[o]);
}


// d += a · b, one m16n8k8 TF32 tensor-core product with float32 sums.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three products of the split into three partial sums (independent
// tensor-core chains): p[0] += lo·hi, p[1] += hi·lo, p[2] += hi·hi.
__device__ __forceinline__ void mma3(float (&p)[3][4], const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma(p[0], al, bh);
  mma(p[1], ah, bl);
  mma(p[2], ah, bh);
}

// acc += (p[0] + p[1]) + p[2], one fixed order, and clear p.
__device__ __forceinline__ void fold(float* acc, float (&p)[3][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    acc[x] = __fadd_rn(acc[x], __fadd_rn(__fadd_rn(p[0][x], p[1][x]), p[2][x]));
    p[0][x] = p[1][x] = p[2][x] = 0.f;
  }
}

// 16 bytes global → shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// The B fragment (k rows kk + t4 and kk + t4 + 4 of column n) of a float32
// tile stored [column][k], split.
__device__ __forceinline__ void b_frag(const float* R, int n, int kk, int t4,
                                       uint32_t* bh, uint32_t* bl) {
  split(R[n * kLd + kk + t4], bh[0], bl[0]);
  split(R[n * kLd + kk + t4 + 4], bh[1], bl[1]);
}

// Write a warp's accumulator tiles acc[m][u] (rows j_base + r0 + 16m (+8
// for x ≥ 2) of the slice's nj, columns c0 + 8u + 2·t4 (+1 for odd x)) into
// G and M.
template <int kM, int kN>
__device__ __forceinline__ void store(const float (&acc)[kM][kN][4], int r0,
                                      int j_base, int nj, int c0, int nt,
                                      int rows, int C, int GG, int T, int b,
                                      int t, float* G, float* M) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int jl = r0 + m * 16 + g + (x >> 1) * 8;
      if (jl >= nj) continue;
      const size_t q = ((size_t)b * rows + j_base + jl) * T + t;  // (b, j, t)
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int col = c0 + 8 * u + 2 * t4 + (x & 1);
        if (u >= nt || col >= C) continue;
        if (col < GG)
          G[q * GG + col] = acc[m][u][x];
        else
          M[q * (C - GG) + (col - GG)] = acc[m][u][x];
      }
    }
}

// 3a. The wide product (C > 32 or one θ) on wgmma: grid (⌈C/64⌉, ⌈nj/128⌉,
// B·T) for the slice's nj query rows from j_base, so the column slabs of one
// row block run side by side and share its W tiles in L2; two warpgroups
// (256 threads) a block, each a 64 × 64 tile of C, the two sharing the
// block's R tiles. The operands come as TF32 hi and lo arrays (Wh, Wl: [b,
// t, j - j_base, i]; Rh, Rl: [b, c, i]); each step of 32 library points
// copies its tiles by cp.async into K-major shared tiles with the 128-byte
// swizzle (row r's 16-byte chunk c at c ^ (r % 8)), three steps ahead in a
// ring of four stages, and issues per 8 points the three products as
// m64n64k8 wgmma reading both operands from shared memory into a partial
// sum, added to the running sum in float32 after each step (folding while
// the next step's products run would make ptxas serialize the wgmma).
constexpr int kStages = 4, kAhead = 3;    // ring depth, copies ahead
constexpr int kWM = 128, kWN = 64;        // a block's tile of C
constexpr int kRowB = kBK * 4;            // bytes of one tile row (128)
constexpr int kWTile = kWM * kRowB;       // bytes of a W tile (hi or lo)
constexpr int kRTile = kWN * kRowB;       // bytes of an R tile
constexpr int kWStage = 2 * kWTile + 2 * kRTile;

// A shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (the leading offset is unused in this mode).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A · B for one m64n64k8 TF32 product; d is this thread's 32
// accumulators (the m16n8 layout, rows 16·warp + ..., per 8 columns).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

__global__ void __launch_bounds__(256, 1)
smap_gemm_wide_kernel(const uint32_t* __restrict__ Wh,
                      const uint32_t* __restrict__ Wl,
                      const uint32_t* __restrict__ Rh,
                      const uint32_t* __restrict__ Rl, int rows, int ldr,
                      int j_base, int nj, int C, int GG, int T,
                      float* __restrict__ G, float* __restrict__ M) {
  extern __shared__ uint8_t wsmem_raw[];
  // The swizzle repeats every 1024 bytes: align the ring to that.
  uint8_t* ring = wsmem_raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(
                                            wsmem_raw) & 1023)) & 1023);
  const int b = blockIdx.z / T;
  const int t = blockIdx.z - b * T;
  const int j0 = blockIdx.y * kWM;
  const int c0 = blockIdx.x * kWN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // this warp's warpgroup: rows j0 + 64·wg
  const uint32_t* wh = Wh + ((size_t)b * T + t) * nj * ldr;
  const uint32_t* wl = Wl + ((size_t)b * T + t) * nj * ldr;
  const uint32_t* rh = Rh + (size_t)b * C * ldr;
  const uint32_t* rl = Rl + (size_t)b * C * ldr;

  // Step s's tiles into stage s % kStages: 16-byte chunks (row, chunk)
  // = (idx >> 3, idx & 7), 12 a thread (W hi, W lo, then R hi, R lo);
  // zero past the rows, the columns and ldr.
  auto copy_step = [&](int s) {
    const int i0 = s * kBK;
    uint8_t* st = ring + (s % kStages) * kWStage;
#pragma unroll
    for (int q = 0; q < 2 * kWM * 8 / 256; ++q) {
      const int idx = tid + q * 256;
      const int hl = idx / (kWM * 8), r = (idx >> 3) % kWM, c = idx & 7;
      const int i = i0 + 4 * c;
      const bool ok = j0 + r < nj && i < ldr;
      const uint32_t* src = hl ? wl : wh;
      copy16(st + hl * kWTile + r * kRowB + ((c ^ (r & 7)) << 4),
             ok ? src + (size_t)(j0 + r) * ldr + i : src, ok);
    }
#pragma unroll
    for (int q = 0; q < 2 * kWN * 8 / 256; ++q) {
      const int idx = tid + q * 256;
      const int hl = idx / (kWN * 8), r = (idx >> 3) % kWN, c = idx & 7;
      const int i = i0 + 4 * c;
      const bool ok = c0 + r < C && i < ldr;
      const uint32_t* src = hl ? rl : rh;
      copy16(st + 2 * kWTile + hl * kRTile + r * kRowB +
                 ((c ^ (r & 7)) << 4),
             ok ? src + (size_t)(c0 + r) * ldr + i : src, ok);
    }
  };
  // Step s's twelve products into p; p is complete on return.
  float acc[32], p[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  const int steps = (rows + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) copy_step(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    // Step s has landed; the stage the copies now refill was last read by
    // step s - 1, whose products are done.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + kAhead < steps) copy_step(s + kAhead);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint8_t* st = ring + (s % kStages) * kWStage;
    const uint8_t* a = st + wg * (kWTile / 2);
    fence_regs(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // 8 points = 32 bytes a row
      const uint64_t ah = sw128_desc(a + kk * 32);
      const uint64_t al = sw128_desc(a + kWTile + kk * 32);
      const uint64_t bh = sw128_desc(st + 2 * kWTile + kk * 32);
      const uint64_t bl = sw128_desc(st + 2 * kWTile + kRTile + kk * 32);
      wgmma_tf32(p, al, bh, kk > 0);
      wgmma_tf32(p, ah, bl, 1);
      wgmma_tf32(p, ah, bh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(p);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = __fadd_rn(acc[x], p[x]);
  }

  // acc[4u + x]: row 64·wg + 16·(warp % 4) + g (+8 for x ≥ 2), column
  // 8u + 2·t4 (+1 for odd x) of the block's tile.
  const int g = lane >> 2, t4 = lane & 3;
  const int NE1 = C - GG;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int jl = j0 + 64 * wg + 16 * (warp & 3) + g + (x >> 1) * 8;
    if (jl >= nj) continue;
    const size_t q = ((size_t)b * rows + j_base + jl) * T + t;  // (b, j, t)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = c0 + 8 * u + 2 * t4 + (x & 1);
      if (col >= C) continue;
      if (col < GG)
        G[q * GG + col] = acc[4 * u + x];
      else
        M[q * NE1 + (col - GG)] = acc[4 * u + x];
    }
  }
}

// 3b. The narrow product (C ≤ 32, several θ): grid (⌈T/2⌉, ⌈nj/64⌉, B) for
// the slice's nj query rows from j_base (ratios [b, j - j_base, i]),
// 8 warps as 2 (rows) × 2 (θ) × 2 (columns) of 32 × 16. The W tile is
// formed from the ratios as it is staged (expf, 0 on the diagonal and past
// the rows, split into TF32 pairs); the R tile arrives by cp.async. Two
// stages, one barrier per step: the next step's copies and ratio loads are
// in flight during the products.
constexpr int kTM = 64;

__global__ void __launch_bounds__(kThreads, 2)
smap_gemm_theta_kernel(const float* __restrict__ ratio,
                       const float* __restrict__ Rt, int rows, int ldr,
                       int j_base, int nj, int C, int GG, Thetas th, int T,
                       int exclude_self, float* __restrict__ G,
                       float* __restrict__ M) {
  constexpr int kW = 2 * kTM * kLd;  // uint2 pairs of W per stage (2 θ)
  constexpr int kR = 32 * kLd;       // floats of R per stage
  extern __shared__ uint2 smem2[];  // [2]: W pairs [2][kTM][kLd]; then [2]: R
  float* rs = reinterpret_cast<float*>(smem2 + 2 * kW);
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * 2;
  const int j0 = blockIdx.y * kTM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, tl = (warp >> 1) & 1, wn = warp >> 2;
  const int nt = min(2, max(0, (C - 16 * wn + 7) >> 3));  // its n-tiles
  const bool active = nt > 0 && t0 + tl < T;
  const float* rat = ratio + (size_t)b * nj * ldr;
  const float* rt = Rt + (size_t)b * C * ldr;

  // Ratios: quads (r, kq) = (idx >> 3, idx & 7), two per thread; R: one
  // 16-byte copy (c, kq) a thread.
  float4 pw[2];
  auto load = [&](int i0, float* R) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = tid + s * kThreads;
      const int j = j0 + (idx >> 3), i = i0 + 4 * (idx & 7);
      pw[s] = j < nj && i < ldr
                  ? *reinterpret_cast<const float4*>(rat + (size_t)j * ldr + i)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int c = tid >> 3, i = i0 + 4 * (tid & 7);
    const bool ok = c < C && i < ldr;
    copy16(R + c * kLd + 4 * (tid & 7), ok ? rt + (size_t)c * ldr + i : rt,
           ok);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto form_w = [&](int i0, uint2* W) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = tid + s * kThreads;
      const int r = idx >> 3, k = 4 * (idx & 7);
      const int j = j0 + r;
      const float rv[4] = {pw[s].x, pw[s].y, pw[s].z, pw[s].w};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (t0 + q >= T) break;
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + k + e;
          const bool ok =
              j < nj && i < rows && !(exclude_self && i == j_base + j);
          split(ok ? expf(__fmul_rn(th.neg[t0 + q], rv[e])) : 0.f, h[e],
                l[e]);
        }
        uint4* dst = reinterpret_cast<uint4*>(W + (q * kTM + r) * kLd + k);
        dst[0] = make_uint4(h[0], l[0], h[1], l[1]);
        dst[1] = make_uint4(h[2], l[2], h[3], l[3]);
      }
    }
  };

  float acc[2][2][4] = {};
  load(0, rs);
  form_w(0, smem2);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  int stage = 0;
  for (int i0 = 0; i0 < rows; i0 += kBK, stage ^= 1) {
    const uint2* W = smem2 + stage * kW;
    const float* R = rs + stage * kR;
    const bool next = i0 + kBK < rows;
    if (next) load(i0 + kBK, rs + (stage ^ 1) * kR);
    if (active) {
      float part[2][2][3][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int o = (tl * kTM + wm * 32 + m * 16 + g) * kLd + kk + t4;
          const uint2 a0 = W[o], a1 = W[o + 8 * kLd], a2 = W[o + 4],
                      a3 = W[o + 8 * kLd + 4];
          ah[m][0] = a0.x; ah[m][1] = a1.x; ah[m][2] = a2.x; ah[m][3] = a3.x;
          al[m][0] = a0.y; al[m][1] = a1.y; al[m][2] = a2.y; al[m][3] = a3.y;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u >= nt) break;
          uint32_t bh[2], bl[2];
          b_frag(R, 16 * wn + 8 * u + g, kk, t4, bh, bl);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(part[m][u], ah[m], al[m], bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) fold(acc[m][u], part[m][u]);
    }
    if (next) form_w(i0 + kBK, smem2 + (stage ^ 1) * kW);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  if (active)
    store(acc, j0 + wm * 32, j_base, nj, 16 * wn, nt, rows, C, GG, T, b,
          t0 + tl, G, M);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// X: (B, L) float32 library series. Y: targets, (N, L) float32 for
// y_lib_stride = 0 or (B, N, L) for y_lib_stride = N·L. thetas: T host
// floats. The libraries go through in slices of `slice`, each slice's query
// rows in slices of `row_slice` (nj): R is built once per slice of
// libraries, the other four kernels run per slice of rows, all reusing the
// scratch. scratch: slice · (2C · ldr + (1 + 2T) · nj · ldr) + slice · nj4
// 4-byte words for the wide product (C > 32 or T = 1), slice · (C + nj) ·
// ldr + slice · nj4 for the narrow one, C = (E+1)² + N(E+1), ldr = rows and
// nj4 = nj, each rounded up to a multiple of 4: R's transpose (as TF32 pairs
// for the wide product), the distances (ratios in place for the narrow
// product), d̄, then the wide product's weights as TF32 pairs. G: (B, rows,
// T, E+1, E+1), M: (B, rows, T, N, E+1), float32, rows = L - (E-1)·tau - Tp.
// Returns the first nonzero cudaError_t, or 0.
extern "C" int smap_gram_launch(const float* X, int B, int L, const float* Y,
                                long long y_lib_stride, int N,
                                const float* thetas, int T, int E, int tau,
                                int Tp, int exclude_self, float* scratch,
                                int slice, int row_slice, float* G, float* M,
                                void* stream) {
  const int rows = L - (E - 1) * tau - Tp;
  if (B < 1 || N < 1 || E < 1 || tau < 1 || Tp < 0 || rows <= 0 || T < 1 ||
      T > kMaxThetas || slice < 1 || row_slice < 1)
    return (int)cudaErrorInvalidValue;
  Thetas th;
  for (int t = 0; t < T; ++t) th.neg[t] = -thetas[t];
  cudaStream_t s = (cudaStream_t)stream;
  const int ldr = (rows + 3) / 4 * 4;
  const int GG = (E + 1) * (E + 1);
  const int C = GG + N * (E + 1);
  const bool wide = C > 32 || T == 1;
  const int nj_max = row_slice < rows ? row_slice : rows;
  const size_t wide_smem = (size_t)kStages * kWStage + 1024;  // + alignment
  const size_t theta_smem = (size_t)2 * (2 * kTM * kLd * 8 + 32 * kLd * 4);
  const size_t dist_smem = (size_t)(E + 1024 + (E - 1) * tau) * 4;
  cudaError_t err = set_smem(smap_dist_kernel, dist_smem);
  if (err == cudaSuccess)
    err = wide ? set_smem(smap_gemm_wide_kernel, wide_smem)
               : set_smem(smap_gemm_theta_kernel, theta_smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += slice) {
    const int nb = B - b0 < slice ? B - b0 : slice;
    const size_t rn = (size_t)nb * C * ldr;
    float* Rt = scratch;
    uint32_t* Rh = reinterpret_cast<uint32_t*>(scratch);
    uint32_t* Rl = Rh + rn;
    float* dist = scratch + (wide ? 2 : 1) * rn;
    const float* Xb = X + (size_t)b0 * L;
    smap_rhs_kernel<<<dim3(C, (ldr + 255) / 256, nb), 256, 0, s>>>(
        Xb, L, Y + (size_t)b0 * y_lib_stride, y_lib_stride, E, tau, Tp, rows,
        ldr, C, Rt, wide ? Rh : nullptr, wide ? Rl : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* Gb = G + (size_t)b0 * rows * T * GG;
    float* Mb = M + (size_t)b0 * rows * T * (C - GG);
    for (int j_base = 0; j_base < rows; j_base += nj_max) {
      const int nj = rows - j_base < nj_max ? rows - j_base : nj_max;
      // This slice's distances (nb · nj · ldr), d̄ (nb · nj, padded to 4),
      // then the wide product's weights Wh, Wl (T · nb · nj · ldr each).
      const size_t dn = (size_t)nb * nj * ldr;
      float* dbar = dist + dn;
      uint32_t* Wh =
          reinterpret_cast<uint32_t*>(dbar + ((size_t)nb * nj + 3) / 4 * 4);
      uint32_t* Wl = Wh + (size_t)T * dn;
      const dim3 grid_ji((ldr + 1023) / 1024, nj, nb);
      smap_dist_kernel<<<grid_ji, 256, dist_smem, s>>>(Xb, L, rows, ldr, E,
                                                       tau, j_base, nj, dist);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      smap_dbar_kernel<<<dim3((nj + 7) / 8, nb), 256, 0, s>>>(dist, rows, ldr,
                                                              nj, dbar);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      smap_weights_kernel<<<grid_ji, 256, 0, s>>>(
          dist, dbar, rows, ldr, j_base, nj, th, T, exclude_self,
          wide ? Wh : nullptr, wide ? Wl : nullptr);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      if (wide)
        smap_gemm_wide_kernel<<<dim3((C + kWN - 1) / kWN,
                                     (nj + kWM - 1) / kWM, nb * T),
                                256, wide_smem, s>>>(
            Wh, Wl, Rh, Rl, rows, ldr, j_base, nj, C, GG, T, Gb, Mb);
      else
        smap_gemm_theta_kernel<<<dim3((T + 1) / 2, (nj + kTM - 1) / kTM, nb),
                                 kThreads, theta_smem, s>>>(
            dist, Rt, rows, ldr, j_base, nj, C, GG, th, T, exclude_self, Gb,
            Mb);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
