// The host's model of a CUDA block's threads, shared by the harnesses
// (harness.cpp, bwd_harness.cpp): each CUDA thread is a std::thread, the
// block's barrier (g_block, made by the harness for its block size) is
// __syncthreads, each warp's (g_warp) __syncwarp, and a warp shuffle goes
// through a per-warp buffer. Function definitions: one harness includes it.
#pragma once
#include "cuda_runtime.h"

#include <barrier>
#include <cstring>
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

// A block's shared memory, as CUDA leaves it uninitialised: an arena that
// run_blocks fills with 0xff bytes (NaN in f32 and f64) before each block.
// A source whose __shared__ arrays the test has rewritten as
// emu_shared(bytes) takes them from its first kEmuStatic bytes, in the
// order each thread declares them (the same in every thread, so the same
// addresses), and its dynamic shared memory from emu_dynamic_shared().
constexpr size_t kEmuStatic = 1 << 17, kEmuDynamic = 1 << 18;
alignas(16) static unsigned char g_shared_arena[kEmuStatic + kEmuDynamic];
static thread_local size_t g_shared_used;
void* emu_shared(size_t bytes) {
  const size_t at = (g_shared_used + 15) & ~size_t(15);
  g_shared_used = at + bytes;
  if (g_shared_used > kEmuStatic) {
    fprintf(stderr, "the block's static shared memory exceeds the arena\n");
    exit(1);
  }
  return g_shared_arena + at;
}
unsigned char* emu_dynamic_shared() { return g_shared_arena + kEmuStatic; }

// Runs kernel() once per block of nblocks, blocks one after another, each
// with nthreads std::threads, its shared memory NaN first.
template <class K> void run_blocks(int nblocks, int nthreads, K&& kernel) {
  g_block = new std::barrier<>(nthreads);
  for (auto& w : g_warp) w = new std::barrier<>(32);
  for (int blk = 0; blk < nblocks; ++blk) {
    std::memset(g_shared_arena, 0xff, sizeof(g_shared_arena));
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t, blk] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)blk, 0, 0};
        blockDim = {(unsigned)nthreads, 1, 1};
        g_shared_used = 0;
        kernel();
      });
    }
    for (auto& t : threads) t.join();
  }
}
