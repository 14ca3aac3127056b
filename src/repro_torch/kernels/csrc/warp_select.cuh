// Warp-wide bitonic sorting, merging and buffered k-selection of
// (value, index) keys for k ≤ 32. Included by knn_multi_e.cu (its
// selection kernel), knn_append.cu (the walk over new rows), knn_fused.cu
// (its selection kernel) and topk.cu (the selection kernels for k ≤ 32).
//
// Keys are ordered by (value ascending, index ascending), as kbest::before,
// so a selection that keeps the k first keys of everything offered gives
// the same bits as kbest::warp_offer's insertion one candidate at a time,
// whatever the order in which the candidates came and however they were
// buffered.
//
// A warp holds 32 keys one per lane. sort32 sorts them across the lanes
// (15 compare-exchange steps of two shuffles each); merge32 merges two
// sorted sets of 32 and keeps the first 32 (the reversed second set
// against the first, the smaller of each pair, then the five half-cleaners
// of a bitonic merge). The _v forms do the same for values alone.
//
// compact() is the buffer's flush: a per-(warp, level) buffer of up to 96
// keys in shared memory, sorted in 32s and merged, leaves its 32 first keys
// sorted in its first 32 slots and returns the k-th as the new threshold.
#pragma once

#include "kbest.cuh"

namespace wsel {

struct Key {
  float v;
  int i;
};

// Compare-exchange with the lane `stride` away: this lane keeps the first
// of the two keys if keep_first, else the second.
__device__ __forceinline__ void exchange(float& v, int& i, int stride,
                                         bool keep_first) {
  const float ov = __shfl_xor_sync(kbest::kFull, v, stride);
  const int oi = __shfl_xor_sync(kbest::kFull, i, stride);
  if (kbest::before(ov, oi, v, i) == keep_first) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void exchange_v(float& v, int stride,
                                           bool keep_first) {
  const float ov = __shfl_xor_sync(kbest::kFull, v, stride);
  v = keep_first ? fminf(v, ov) : fmaxf(v, ov);
}

// Sort one key per lane ascending across the warp (bitonic).
__device__ __forceinline__ void sort32(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(v, i, stride,
               ((lane & stride) == 0) == ((lane & size) == 0));
}

__device__ __forceinline__ void sort32_v(float& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange_v(v, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// (v, i) and (w, j): two sets sorted across the lanes. Leaves in (v, i)
// the 32 first keys of both, sorted.
__device__ __forceinline__ void merge32(float& v, int& i, float w, int j) {
  const int lane = threadIdx.x & 31;
  const float rw = __shfl_sync(kbest::kFull, w, 31 - lane);
  const int rj = __shfl_sync(kbest::kFull, j, 31 - lane);
  if (kbest::before(rw, rj, v, i)) {  // a bitonic sequence of the 32 first
    v = rw;
    i = rj;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(v, i, stride, (lane & stride) == 0);
}

__device__ __forceinline__ void merge32_v(float& v, float w) {
  const int lane = threadIdx.x & 31;
  v = fminf(v, __shfl_sync(kbest::kFull, w, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange_v(v, stride, (lane & stride) == 0);
}

// The k-th smallest (k ≤ 32) of the 64 values a (lane) and b (lane).
__device__ __forceinline__ float kth_of_64(float a, float b, int k) {
  sort32_v(a);
  sort32_v(b);
  merge32_v(a, b);
  return __shfl_sync(kbest::kFull, a, k - 1);
}

// Flush a buffer of cnt ≤ 96 keys (bufv/bufi, written by any lane of the
// warp before a __syncwarp): its 32 first keys, sorted, go back to slots
// 0..31 (slots past cnt as empty keys), and the k-th (k ≤ 32) is returned.
// Out of line: one copy serves every level.
__device__ __noinline__ Key compact(float* bufv, int* bufi, int cnt, int k) {
  const int lane = threadIdx.x & 31;
  float a = lane < cnt ? bufv[lane] : INFINITY;
  int ai = lane < cnt ? bufi[lane] : kbest::kEmpty;
  sort32(a, ai);
  for (int h = 32; h < cnt; h += 32) {
    float b = lane + h < cnt ? bufv[lane + h] : INFINITY;
    int bi = lane + h < cnt ? bufi[lane + h] : kbest::kEmpty;
    sort32(b, bi);
    merge32(a, ai, b, bi);
  }
  __syncwarp();  // every lane has read the buffer
  bufv[lane] = a;
  bufi[lane] = ai;
  __syncwarp();
  return {__shfl_sync(kbest::kFull, a, k - 1),
          __shfl_sync(kbest::kFull, ai, k - 1)};
}

}  // namespace wsel
