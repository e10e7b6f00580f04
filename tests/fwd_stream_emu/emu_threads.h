// The host's model of a CUDA block's threads, shared by the harnesses
// (harness.cpp, bwd_harness.cpp): each CUDA thread is a std::thread, the
// block's barrier (g_block, made by the harness for its block size) is
// __syncthreads, each warp's (g_warp) __syncwarp, and a warp shuffle goes
// through a per-warp buffer. Function definitions: one harness includes it.
#pragma once
#include "cuda_runtime.h"

#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

thread_local dim3x threadIdx, blockIdx, blockDim;
static std::barrier<>* g_block;
static std::barrier<>* g_warp[32];
static double g_lane[32][32];
static std::mutex g_atomic;

void __syncthreads() { g_block->arrive_and_wait(); }
void __syncwarp(unsigned) { g_warp[threadIdx.x / 32]->arrive_and_wait(); }
template <class V> static V shfl_down(V v, int offset) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lane[w][l] = v;
  g_warp[w]->arrive_and_wait();
  const V r = l + offset < 32 ? (V)g_lane[w][l + offset] : v;
  g_warp[w]->arrive_and_wait();
  return r;
}
float __shfl_down_sync(unsigned, float v, int offset) { return shfl_down(v, offset); }
double __shfl_down_sync(unsigned, double v, int offset) { return shfl_down(v, offset); }
double __shfl_xor_sync(unsigned, double v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lane[w][l] = v;
  g_warp[w]->arrive_and_wait();
  const double r = g_lane[w][l ^ lane_mask];
  g_warp[w]->arrive_and_wait();
  return r;
}
float __shfl_sync(unsigned, float v, int src_lane) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lane[w][l] = v;
  g_warp[w]->arrive_and_wait();
  const float r = (float)g_lane[w][src_lane & 31];
  g_warp[w]->arrive_and_wait();
  return r;
}
unsigned atomicOr(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lock(g_atomic);
  const unsigned old = *p;
  *p |= v;
  return old;
}

// Runs kernel() once per block of nblocks, blocks one after another, each
// with nthreads std::threads.
template <class K> void run_blocks(int nblocks, int nthreads, K&& kernel) {
  g_block = new std::barrier<>(nthreads);
  for (auto& w : g_warp) w = new std::barrier<>(32);
  for (int blk = 0; blk < nblocks; ++blk) {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t, blk] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)blk, 0, 0};
        blockDim = {(unsigned)nthreads, 1, 1};
        kernel();
      });
    }
    for (auto& t : threads) t.join();
  }
}
