// k smallest entries per row of a square squared-distance matrix, under one
// column cap or under every cap of an ascending list in one launch.
//
// Replaces two Pallas TPU kernels of repro/kernels/topk.py:
//   - _kernel (wrapper topk_select): k passes of (min, first argmin, retire)
//     per row block, self and columns past a dynamic max_idx masked;
//   - _sizes_kernel with _merge_kbest (wrapper topk_select_sizes): one
//     column-tiled pass that snapshots the running k-best at every cap of
//     a CCM convergence sweep.
// Both emit Euclidean distances (sqrt of the squared value, after the
// selection) and int32 column indices, ascending in (value, index) order,
// the tie order of lax.top_k in the reference.
//   - topk_select: every column enters; self and columns > mx enter as +inf
//     with their real index, which reproduces lax.top_k's fill on rows with
//     fewer than k valid candidates.
//   - topk_select_sizes: level s is the k-best of columns 0..caps[s], self
//     never entering and no column past last = caps[S-1] read (the wrapper
//     clips the caps to Lp - 1); a finite slot is written as (sqrt(d), idx),
//     any other as (inf, -1).
//
// What bounds it on the H100: reading D, 4·Lp² bytes for topk_select (10.2
// MB at Lp = 1598, ≈3 µs at 3.35 TB/s; the matrix usually sits in L2 right
// after the distance kernel), 4·Lp·(last + 1) for topk_select_sizes; the
// tables are Lp·k·8 bytes a level. Beside the reads, each column costs a
// comparison with a threshold, and the candidates that pass must be sorted.
//
// Two designs, picked by the wrapper (topk.route); both bit-equal to the
// plain versions, and to each other, because a (value, index)-ordered
// selection does not depend on the order in which candidates arrive.
//  topk_select32_kernel<kSizes> (k ≤ 32, S ≤ kbest::kMaxLevels). The first
//  design gave one warp one row and 50 dependent 32-column steps at the
//  path's Lp, each a load that waited a full round trip, a read of the
//  list's last slot and a vote, and a warp-wide walk down the list for
//  every candidate that beat it, which the first columns of a row almost
//  always do; the sizes kernel also stopped at every cap to write a level.
//  The work here is a chain of latencies a warp waits out, so the design
//  cuts that chain (measured with clock marks on the card):
//   - one warp a row (splitting a row over 2, 4 or 8 warps and merging
//     their k-bests was slower at each length timed, 518 to 1598: the
//     lists and merges cost more than the shorter walks saved), over
//     columns 0..last in chunks of 512 copied into shared memory
//     (cp.async, 16 bytes a lane where the row is aligned so) while the
//     chunk before is worked;
//   - the first chunk, and a segment after a cap when fewer than kSeen
//     columns lie behind it, takes a bound: each lane's smallest value
//     over the chunk's columns up to the next cap, and the k-th smallest
//     of the 32 (one warp sort of values) — k keys of that level lie at or
//     below it;
//   - 4 groups of 32 columns are read and voted on at once against the
//     threshold, the tighter of that bound and the k-th key of the last
//     compaction (marking candidates lane by lane and voting only where a
//     lane marked one, with a reduction, was slower); the keys that
//     precede it go to a 192-slot buffer by one vote and popc a group, and
//     a buffer past 64 is sorted and cut to its k first (only over as many
//     lanes as it holds keys). A later chunk first cuts the buffer once,
//     so that its k-th key bounds every column after it; then about k keys
//     a chunk pass (counted on the CPU by topk._emulate at the path's
//     shapes);
//   - at a cap the warp's k first keys so far are that level, written out
//     at once. topk_select is the case of one level, at the last column,
//     with its own masking.
//  A bound is valid for a column of level g's segment when it is the k-th
//  key of some set of columns ≤ caps[g]: then no key behind it can be among
//  the k first of level g or of any later level. Every bound here comes
//  from the row's columns up to the current segment's cap, so it is
//  valid; keys equal to it in value but not in index are compared as
//  (value, index) keys (kbest::before) everywhere.
//  topk_select_kernel, topk_sizes_kernel (any k; the shapes the first does
//  not take): one warp owns one row and walks its columns 32 at a time,
//  offering each lane's value to the row's k-best list in shared memory
//  (kbest::warp_offer); the sizes kernel writes level s after column
//  caps[s], splitting a 32-column batch that straddles a cap.
#include <limits.h>
#include <stdint.h>

#include "kbest.cuh"
#include "smem_grant.cuh"
#include "warp_select.cuh"

namespace {

__device__ __forceinline__ float root(float v) {
  return __fsqrt_rn(fmaxf(v, 0.f));
}

// Ascending inclusive caps, by value: S ≤ kbest::kMaxLevels of them; a
// longer list is read from a device array.
struct Caps {
  int c[kbest::kMaxLevels];
};

// ------------------------------------------------ the insertion kernels

// This warp's row list: k distances then k indices per warp, W warps.
struct Lists {
  float* d;
  int* ix;
};

__device__ __forceinline__ Lists warp_lists(int k) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(smem);
  return {base + warp * k, reinterpret_cast<int*>(base + W * k) + warp * k};
}

__global__ void topk_select_kernel(const float* __restrict__ D, int Lp, int k,
                                   int mx, int exclude_self,
                                   float* __restrict__ out_d,
                                   int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= Lp) return;  // whole warp: no block-wide barrier below
  const Lists l = warp_lists(k);
  const float* row = D + (size_t)i * Lp;
  kbest::warp_init(l.d, l.ix, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const float v = live ? __ldg(row + j) : INFINITY;
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(l.d, l.ix, k, live, masked ? INFINITY : v, j);
  }
  const size_t base = (size_t)i * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = root(l.d[q]);
    out_i[base + q] = l.ix[q];
  }
}

// Level s of row i from the running list: finite slots rooted, others
// (inf, -1).
__device__ __forceinline__ void snapshot(const Lists& l, int k, int Lp, int i,
                                         int s, float* out_d, int* out_i) {
  const size_t base = ((size_t)s * Lp + i) * k;
  for (int q = threadIdx.x & 31; q < k; q += 32) {
    const float v = l.d[q];
    const bool ok = isfinite(v);
    out_d[base + q] = ok ? root(v) : INFINITY;
    out_i[base + q] = ok ? l.ix[q] : -1;
  }
  __syncwarp();
}

__global__ void topk_sizes_kernel(const float* __restrict__ D, int Lp, int k,
                                  const __grid_constant__ Caps caps,
                                  const int* __restrict__ caps_dev, int S,
                                  int last, int exclude_self,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= Lp) return;
  const Lists l = warp_lists(k);
  const float* row = D + (size_t)i * Lp;
  kbest::warp_init(l.d, l.ix, k);
  int s = 0;
  for (int jb = 0; jb <= last; jb += 32) {
    const int j = jb + lane;
    const bool enters = j <= last && !(exclude_self && j == i);
    const float v = j <= last ? __ldg(row + j) : INFINITY;
    int lo = jb;  // lanes below lo were offered already
    for (; s < S; ++s) {
      // The same for every lane.
      const int c = S <= kbest::kMaxLevels ? caps.c[s] : __ldg(caps_dev + s);
      if (c >= jb + 32) break;
      kbest::warp_offer(l.d, l.ix, k, enters && j >= lo && j <= c, v, j);
      snapshot(l, k, Lp, i, s, out_d, out_i);
      lo = max(lo, c + 1);
    }
    kbest::warp_offer(l.d, l.ix, k, enters && j >= lo, v, j);
  }
  for (; s < S; ++s) snapshot(l, k, Lp, i, s, out_d, out_i);
}

SmemGrant g_select, g_sizes;

// ------------------------------------------------ the selection kernels

constexpr int kWarps = 8;             // warps a block
constexpr int kSlots = 16;            // columns a lane copies of a chunk
constexpr int kChunk = 32 * kSlots;   // columns a chunk
constexpr int kQuad = 4;              // groups of 32 columns voted at once
constexpr int kSeen = 128;            // columns behind a running bound
constexpr int kBuf = 64 + 32 * kQuad; // buffer slots a warp

// Shared memory a block: each warp's buffer (kBuf values, kBuf indices)
// and its two chunk halves (2·kChunk floats).
constexpr size_t kSelectSmem = (size_t)kWarps * (kBuf * 8 + 2 * kChunk * 4);
static_assert(kSelectSmem <= 48 * 1024,
              "within the default dynamic shared memory: no attribute call");

// The smallest power of two ≥ n (n ≤ 32).
__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// Sort one key per lane ascending over lanes [0, kN) (the first stages of
// wsel::sort32, unrolled); lanes past kN hold empty keys.
template <int kN>
__device__ __forceinline__ void sort_first(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= kN; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      wsel::exchange(v, i, stride,
                     ((lane & stride) == 0) == ((lane & size) == 0));
}

// The same over lanes [0, n), n a power of two ≤ 32: one straight-line
// network per size.
__device__ __forceinline__ void sort_upto(float& v, int& i, int n) {
  switch (n) {
    case 1: break;
    case 2: sort_first<2>(v, i); break;
    case 4: sort_first<4>(v, i); break;
    case 8: sort_first<8>(v, i); break;
    case 16: sort_first<16>(v, i); break;
    default: sort_first<32>(v, i); break;
  }
}

// wsel::compact, sorting only as many lanes as the buffer holds keys: its
// 32 first keys sorted into slots 0..31, the k-th returned.
__device__ __forceinline__ wsel::Key compact_small(float* bufv, int* bufi,
                                                   int cnt, int k) {
  if (cnt > 32) return wsel::compact(bufv, bufi, cnt, k);
  const int lane = threadIdx.x & 31;
  float a = lane < cnt ? bufv[lane] : INFINITY;
  int ai = lane < cnt ? bufi[lane] : kbest::kEmpty;
  sort_upto(a, ai, pow2_at_least(cnt));
  __syncwarp();  // every lane has read the buffer
  bufv[lane] = a;
  bufi[lane] = ai;
  __syncwarp();
  return {__shfl_sync(kbest::kFull, a, k - 1),
          __shfl_sync(kbest::kFull, ai, k - 1)};
}

// The k-th smallest (k ≤ 32) of one value a lane.
__device__ __forceinline__ float kth_of_32(float v, int k) {
  wsel::sort32_v(v);
  return __shfl_sync(kbest::kFull, v, k - 1);
}

// Column j (value x) of row i as the selection sees it: NaN past `end`
// and, for the sizes kernel, at self (NaN passes no threshold and raises
// no bound); +inf, for topk_select, at self and past mx.
template <bool kSizes>
__device__ __forceinline__ float masked(float x, int j, int end, int i,
                                        int mx, int exclude_self) {
  const bool self = exclude_self && j == i;
  if (kSizes) return j > end || self ? NAN : x;
  return j > end ? NAN : self || j > mx ? INFINITY : x;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Level s of row i from one key a lane (lanes < k): rooted; for the sizes
// kernel, a slot without a finite key as (inf, -1).
template <bool kSizes>
__device__ __forceinline__ void put_level(float v, int ix, int s, int i,
                                          int Lp, int k, float* out_d,
                                          int* out_i) {
  const int lane = threadIdx.x & 31;
  if (lane < k) {
    const size_t o = ((size_t)s * Lp + i) * k + lane;
    const bool ok = !kSizes || isfinite(v);
    out_d[o] = ok ? root(v) : INFINITY;
    out_i[o] = ok ? ix : -1;
  }
}

// kSizes: topk_select_sizes (self never enters, S caps, slots without a
// finite key written as (inf, -1)); else topk_select (one level at
// last = Lp - 1; self and columns past mx enter as +inf). One warp a row,
// over columns 0..last; k ≤ 32.
template <bool kSizes>
__global__ void __launch_bounds__(kWarps * 32, 4)
topk_select32_kernel(const float* __restrict__ D, int Lp, int k, int mx,
                     int exclude_self, const __grid_constant__ Caps caps,
                     int S, int last, float* __restrict__ out_d,
                     int* __restrict__ out_i) {
  extern __shared__ float sel_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= Lp) return;  // whole warp: no block-wide barrier below
  float* bufv = sel_smem + warp * kBuf;
  int* bufi = reinterpret_cast<int*>(sel_smem + kWarps * kBuf) + warp * kBuf;
  float* chunk = sel_smem + 2 * kWarps * kBuf + warp * 2 * kChunk;
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  const float* row = D + (size_t)i * Lp;
  auto cap = [&](int q) { return kSizes ? caps.c[q] : last; };

  // The running key (the k-th of the buffer's last compaction) and the
  // bound of the chunks so far; the threshold is the tighter of the two.
  float rv = INFINITY, sv = INFINITY, tv = INFINITY;
  int ri = kbest::kEmpty, ti = kbest::kEmpty;
  int cnt = 0;          // the buffer's fill (the same in every lane)
  bool sorted = false;  // the buffer is compacted and nothing was added
  auto tighten = [&]() {
    const bool run = kbest::before(rv, ri, sv, kbest::kEmpty);
    tv = run ? rv : sv;
    ti = run ? ri : kbest::kEmpty;
  };
  auto flush = [&]() {
    __syncwarp();
    const wsel::Key key = compact_small(bufv, bufi, cnt, k);
    rv = key.v;
    ri = key.i;
    cnt = min(cnt, k);  // keys past the k-th can no longer be chosen
    sorted = true;
    tighten();
  };
  // The lanes that take their key (bal: the warp's vote) into the
  // buffer; the caller keeps room for them.
  auto append = [&](bool take, unsigned bal, float x, int j) {
    if (take) {
      const int q = cnt + __popc(bal & lt);
      bufv[q] = x;
      bufi[q] = j;
    }
    cnt += __popc(bal);
    sorted = false;
  };
  auto offer = [&](float x, int j, bool in) {
    const bool take = in && kbest::before(x, j, tv, ti);
    const unsigned bal = __ballot_sync(kbest::kFull, take);
    if (bal != 0) append(take, bal, x, j);
  };
  // Columns 0..last in chunks of kChunk, each copied into shared memory
  // (cp.async) while the one before it is worked: 4 columns a lane at a
  // time when the row starts on 16 bytes (a chunk starts on a multiple of
  // 32 columns), else one.
  const bool wide = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  auto fetch = [&](int pos, float* dst) {
    const int end = min(last, pos + kChunk - 1);
    if (wide) {
#pragma unroll
      for (int u = 0; u < kSlots / 4; ++u) {
        const int c = u * 128 + lane * 4;  // the block's first column
        if (pos + c + 3 <= end) {
          cp_async16(dst + c, row + pos + c);
        } else {
          for (int e = c; e < c + 4 && pos + e <= end; ++e)
            cp_async4(dst + e, row + pos + e);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int j = pos + u * 32 + lane;
        if (j <= end) cp_async4(dst + u * 32 + lane, row + j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(0, chunk);
  int s = 0;  // the next level
  for (int pos = 0, half = 0; pos <= last; pos += kChunk, half ^= 1) {
    const int end = min(last, pos + kChunk - 1);
    if (end < last) {
      fetch(pos + kChunk, chunk + (half ^ 1) * kChunk);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    // This lane's column pos + 32u as the selection sees it (selects, no
    // branch: a branch around each read serialized the reads).
    const float* cv = chunk + half * kChunk;
    const int clean = kSizes ? end : min(end, mx);  // no mask up to here
    auto col = [&](int u) {
      return masked<kSizes>(cv[u * 32 + lane], pos + u * 32 + lane, end, i,
                            mx, exclude_self);
    };
    // The bound of the segment from here: the k-th of the lanes'
    // smallest values over the chunk's columns up to its cap, or up to
    // the chunk's end (k keys of that level lie at or below it).
    // Columns pos..c hold no self and none past mx: no mask.
    auto plain_to = [&](int c) {
      return c <= clean && !(exclude_self && pos <= i && i <= c);
    };
    auto bound = [&](int q) {
      const int c = q < S && cap(q) <= end ? cap(q) : end;
      const bool plain = plain_to(c);
      float m = INFINITY;
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const float x = plain ? cv[u * 32 + lane] : col(u);
        m = fminf(m, pos + u * 32 + lane <= c ? x : NAN);
      }
      sv = fminf(sv, kth_of_32(m, k));
      tighten();
    };
    // The first chunk takes a bound; until the buffer has a k-th key, a
    // later one first cuts the buffer to its k first (whose k-th key
    // bounds every later column) and takes a bound if that found none.
    if (pos > 0 && !(rv < INFINITY) && !sorted) flush();
    if (pos == 0 || !(rv < INFINITY)) bound(s);
    int next = s < S ? cap(s) : INT_MAX;  // the next level's cap
    const int groups = ((end - pos) >> 5) + 1;
    for (int u = 0; u < groups;) {
      if (cnt > kBuf - 32 * kQuad) flush();  // room for kQuad groups
      const int g0 = pos + u * 32;
      if (u + kQuad <= groups && next >= g0 + 32 * kQuad) {
        // Most of the row: kQuad groups with no cap, their reads and
        // votes side by side.
        float x[kQuad];
        bool take[kQuad];
        unsigned bal[kQuad], any = 0;
        // A run of kQuad groups up to `clean` without self needs no
        // mask (one test for the run).
        if (g0 + 32 * kQuad - 1 <= clean &&
            !(exclude_self && g0 <= i && i < g0 + 32 * kQuad)) {
#pragma unroll
          for (int q = 0; q < kQuad; ++q) x[q] = cv[(u + q) * 32 + lane];
        } else {
#pragma unroll
          for (int q = 0; q < kQuad; ++q) x[q] = col(u + q);
        }
#pragma unroll
        for (int q = 0; q < kQuad; ++q) {
          take[q] = kbest::before(x[q], g0 + q * 32 + lane, tv, ti);
          bal[q] = __ballot_sync(kbest::kFull, take[q]);
          any |= bal[q];
        }
        if (any != 0) {
#pragma unroll
          for (int q = 0; q < kQuad; ++q)
            if (bal[q] != 0)
              append(take[q], bal[q], x[q], g0 + q * 32 + lane);
        }
        u += kQuad;
        continue;
      }
      const int j = g0 + lane;
      const float x = col(u++);
      int lo = g0;  // lanes below lo were offered already
      for (; next < g0 + 32; next = ++s < S ? cap(s) : INT_MAX) {
        offer(x, j, j >= lo && j <= next);
        if (!sorted) flush();
        put_level<kSizes>(bufv[lane], bufi[lane], s, i, Lp, k, out_d, out_i);
        __syncwarp();  // read before the next appends overwrite the buffer
        // The next segment's bound: the k-th key so far when kSeen
        // columns or more lie behind it (a bound as tight), else one from
        // the chunk.
        if (next < end && !(rv < INFINITY && next >= kSeen)) bound(s + 1);
        lo = next + 1;
      }
      offer(x, j, j >= lo);
    }
    __syncwarp();  // (no lane reads the half the next fetch refills)
  }
}

template <bool kSizes>
cudaError_t launch_select32(const float* D, int Lp, int k, int mx,
                            int exclude_self, const Caps& caps, int S,
                            int last, float* out_d, int* out_i,
                            cudaStream_t stream) {
  if (k < 1 || k > 32 || k > Lp || S < 1 || S > kbest::kMaxLevels ||
      last < 0 || last >= Lp)
    return cudaErrorInvalidValue;
  topk_select32_kernel<kSizes>
      <<<(Lp + kWarps - 1) / kWarps, kWarps * 32, kSelectSmem, stream>>>(
          D, Lp, k, mx, exclude_self, caps, S, last, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// D: (Lp, Lp) float32 row-major. out_d, out_i: (Lp, k). mx: inclusive column
// cap. The insertion kernel: one warp per row, warps_per_block rows per
// block. Returns the launch's cudaGetLastError().
extern "C" int topk_select_launch(const float* D, int Lp, int k, int mx,
                                  int exclude_self, int warps_per_block,
                                  float* out_d, int* out_i, void* stream) {
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err =
      grant_smem((const void*)topk_select_kernel, g_select, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  topk_select_kernel<<<blocks, warps_per_block * 32, smem,
                       (cudaStream_t)stream>>>(D, Lp, k, mx, exclude_self,
                                               out_d, out_i);
  return (int)cudaGetLastError();
}

// The same for the selection kernel (k ≤ 32): one warp a row.
extern "C" int topk_select32_launch(const float* D, int Lp, int k, int mx,
                                    int exclude_self, float* out_d,
                                    int* out_i, void* stream) {
  Caps caps;
  caps.c[0] = Lp - 1;
  return (int)launch_select32<false>(D, Lp, k, mx, exclude_self, caps, 1,
                                     Lp - 1, out_d, out_i,
                                     (cudaStream_t)stream);
}

// D: (Lp, Lp) float32 row-major. caps: S ascending inclusive caps, each
// ≤ Lp - 1, on the host (passed by value for S ≤ kbest::kMaxLevels) and,
// for longer lists, caps_dev on the device. out_d, out_i: (S, Lp, k). The
// insertion kernel: one warp per row, warps_per_block rows per block.
// Returns the launch's cudaGetLastError().
extern "C" int topk_sizes_launch(const float* D, int Lp, int k,
                                 const int* caps, const int* caps_dev, int S,
                                 int exclude_self, int warps_per_block,
                                 float* out_d, int* out_i, void* stream) {
  if (S < 1 || (S > kbest::kMaxLevels && caps_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  Caps cv;
  for (int s = 0; s < S && s < kbest::kMaxLevels; ++s) cv.c[s] = caps[s];
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = grant_smem((const void*)topk_sizes_kernel, g_sizes, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  topk_sizes_kernel<<<blocks, warps_per_block * 32, smem,
                      (cudaStream_t)stream>>>(D, Lp, k, cv, caps_dev, S,
                                              caps[S - 1], exclude_self,
                                              out_d, out_i);
  return (int)cudaGetLastError();
}

// The same for the selection kernel: k ≤ 32, S ≤ kbest::kMaxLevels caps on
// the host; one warp a row.
extern "C" int topk_sizes32_launch(const float* D, int Lp, int k,
                                   const int* caps, int S, int exclude_self,
                                   float* out_d, int* out_i, void* stream) {
  if (S < 1 || S > kbest::kMaxLevels) return (int)cudaErrorInvalidValue;
  Caps cv;
  for (int s = 0; s < S; ++s) cv.c[s] = caps[s];
  return (int)launch_select32<true>(D, Lp, k, Lp - 1, exclude_self, cv, S,
                                    caps[S - 1], out_d, out_i,
                                    (cudaStream_t)stream);
}
