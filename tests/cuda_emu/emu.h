// A CPU stand-in for the few CUDA features the segmentation-DP kernels use,
// so their source can be compiled by a host C++20 compiler and checked
// without a GPU (tests/test_torch_segdp_emulated.py).
//
// One std::thread per CUDA thread; __syncthreads is a block-wide
// std::barrier; a named barrier (group_sync, PTX bar.sync id, n) is one
// std::barrier per (id, thread count), at which group_arrive (bar.arrive)
// arrives without waiting; atomicAdd is a fetch_add and setmaxnreg a
// no-op; __shfl_xor_sync exchanges through
// per-warp slots between two warp barriers, and so do the fragments of the
// tensor-core step (mma_m16n8k32_s8); cp.async copies at once. Blocks run
// one after another (so the first block that draws from a work queue
// drains it), and function-static arrays (what __shared__ becomes here) serve as shared memory, and the
// dynamic shared memory is one global buffer filled with garbage before
// every block, as the card leaves it.
#pragma once

#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define CUDA_EMU 1

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return int2{a, b}; }
struct uint2 {
  unsigned x, y;
};

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline unsigned char emu_dyn_smem[256 * 1024];

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  long long slot[32];
  unsigned frag_a[32][4];
  unsigned frag_b[32][2];
};
inline std::unique_ptr<std::barrier<>> emu_block_bar;
inline EmuWarp emu_warps[32];

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }

inline std::mutex emu_named_mu;
inline std::map<std::pair<int, int>, std::unique_ptr<std::barrier<>>> emu_named;

// EMU_STALL="id:ms" in the environment makes every thread sleep ms
// milliseconds before each group_sync on barrier id: a way to run one
// group of warps far behind another and so to walk a hand-off through the
// schedules a fast group never shows. Read at each launch.
inline int emu_stall_id = -1, emu_stall_ms = 0;

// The barrier that `nthreads` threads share under `id`; the map is cleared
// before each launch.
inline std::barrier<>* emu_named_barrier(int id, int nthreads) {
  std::lock_guard<std::mutex> lock(emu_named_mu);
  auto& slot = emu_named[{id, nthreads}];
  if (!slot) slot = std::make_unique<std::barrier<>>(nthreads);
  return slot.get();
}

// bar.sync id, nthreads: waits until nthreads threads have arrived at
// barrier id, by group_sync or group_arrive.
inline void group_sync(int id, int nthreads) {
  if (id == emu_stall_id) std::this_thread::sleep_for(std::chrono::milliseconds(emu_stall_ms));
  emu_named_barrier(id, nthreads)->arrive_and_wait();
}

// bar.arrive id, nthreads: counts as one arrival and goes on. An arrival
// releases what the thread wrote before, as the kernel's fence does.
inline void group_arrive(int id, int nthreads) {
  (void)emu_named_barrier(id, nthreads)->arrive();
}

// setmaxnreg moves registers between warpgroups: nothing to do here.
template <int N>
void reg_release() {}
template <int N>
void reg_take() {}

// atomicAdd on an int in global memory: the old value.
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int tid = threadIdx.x;
  EmuWarp& w = emu_warps[tid / 32];
  const int lane = tid & 31;
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.bar->arrive_and_wait();  // the previous exchange has been read
  w.slot[lane] = bits;
  w.bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &w.slot[lane ^ lane_mask], sizeof(T));
  return out;
}

// cp.async: the copy is done at once, so groups have nothing to wait for.
inline void cp_async_8(void* smem, const void* gmem) { std::memcpy(smem, gmem, 8); }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}

// mma.sync.m16n8k32 s8 x s8 -> s32 with the fragment layout documented in
// segdp_kernels.cuh: the warp's lanes publish their A and B registers,
// then each lane sums its own four outputs from the assembled tiles.
inline void mma_m16n8k32_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const int tid = threadIdx.x;
  EmuWarp& w = emu_warps[tid / 32];
  const int lane = tid & 31;
  w.bar->arrive_and_wait();  // the previous exchange has been read
  for (int i = 0; i < 4; ++i) w.frag_a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.frag_b[lane][i] = b[i];
  w.bar->arrive_and_wait();
  auto byte_of = [](unsigned reg, int i) { return (int)(signed char)((reg >> (8 * i)) & 0xFF); };
  // A[row][col]: lane (row % 8) * 4 + (col % 16) / 4, register row / 8 + 2 * (col / 16).
  auto A = [&](int row, int col) {
    return byte_of(w.frag_a[(row % 8) * 4 + (col % 16) / 4][row / 8 + 2 * (col / 16)], col % 4);
  };
  // B[kk][n]: lane n * 4 + (kk % 16) / 4, register kk / 16.
  auto Bm = [&](int kk, int n) {
    return byte_of(w.frag_b[n * 4 + (kk % 16) / 4][kk / 16], kk % 4);
  };
  const int g = lane >> 2, t4 = lane & 3;
  for (int c = 0; c < 4; ++c) {
    const int row = g + 8 * (c >> 1), col = 2 * t4 + (c & 1);
    int sum = 0;
    for (int kk = 0; kk < 32; ++kk) sum += A(row, kk) * Bm(kk, col);
    d[c] += sum;
  }
}

// Runs body() as every thread of every block of `grid`, block by block:
// one std::thread per CUDA thread for the whole launch, with a block
// barrier before and after each block while thread 0 sets it up.
template <class F>
void emu_launch(dim3 grid, int threads, F body) {
  gridDim = grid;
  blockDim = dim3(threads);
  emu_block_bar = std::make_unique<std::barrier<>>(threads);
  emu_named.clear();
  if (const char* stall = std::getenv("EMU_STALL"))
    std::sscanf(stall, "%d:%d", &emu_stall_id, &emu_stall_ms);
  for (int w = 0; w < threads / 32; ++w)
    emu_warps[w].bar = std::make_unique<std::barrier<>>(32);
  std::vector<std::thread> ts;
  ts.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([t, grid, &body] {
      threadIdx = dim3(t);
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          if (t == 0) {
            blockIdx = dim3(bx, by);
            std::memset(emu_dyn_smem, 0xAB, sizeof(emu_dyn_smem));
          }
          emu_block_bar->arrive_and_wait();
          body();
          emu_block_bar->arrive_and_wait();
        }
      }
    });
  }
  for (auto& t : ts) t.join();
}
