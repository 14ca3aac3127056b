// A kernel's dynamic shared-memory ceiling, raised once per size.
// Included by topk.cu, pairwise_dist.cu and pairwise_mxu.cu (host code
// only).
//
// A launch above the default 48 KB needs
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize)
// first. The attribute stays set per (kernel, device), so grant_smem calls it
// only when no earlier launch on the current device asked for as much:
// once per kernel and size, not at every launch, and never within 48 KB.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

struct SmemGrant {
  std::mutex m;
  size_t granted[64] = {};  // per device ordinal
};

inline cudaError_t grant_smem(const void* kernel, SmemGrant& g, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g.m);
  if (dev < 64 && g.granted[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) g.granted[dev] = smem;
  return err;
}
