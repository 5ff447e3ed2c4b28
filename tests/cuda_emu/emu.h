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
// tensor-core step (mma_m16n8k32_s8); cp.async copies at once.
//
// Thread-block clusters: emu_launch(..., concurrent, cluster = N) runs
// `concurrent` clusters at once, the N blocks of each (consecutive
// blockIdx.x) together, group c holding rank c % N of the running cluster
// c / N; cluster_sync is one std::barrier over every thread of the
// cluster; cluster_map maps a pointer into the block's dynamic shared
// memory to the same offset in rank r's. A block's dynamic shared memory
// is filled with garbage again when it exits, so that a block that reads
// or writes another's after that one has gone on shows. An mbarrier
// (mbar_init, mbar_arrive_cluster, mbar_wait) is its 8 bytes of shared
// memory, updated atomically: a tag, the phases completed, the arrivals
// the phase still needs and the count, so that an arrival on or a wait at
// a barrier that is garbage (never set up, or its block has exited)
// aborts, and so does a wait that sees no phase complete in 60 s.
//
// emu_launch runs `concurrent` blocks of a launch at once, each a group of
// threads with a state of its own (EmuBlock: its barriers, its warps'
// exchange slots, its shared memory); a group takes the blocks c, c + C,
// ... one after another. With one group the blocks run in turn, so the
// first block that draws from a work queue drains it; with as many groups
// as blocks, a persistent kernel's blocks all draw at once. The dynamic
// shared memory is a buffer of the block's, filled with garbage before
// every block, as the card leaves it; a static __shared__ array becomes a
// pointer into the block's state (emu_shared; the test that compiles the
// kernels rewrites the declaration).
#pragma once

#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
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
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
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

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  long long slot[32];
  unsigned frag_a[32][4];
  unsigned frag_b[32][2];
};

// What the threads of one running block share.
struct EmuBlock {
  static constexpr int kSharedArrays = 16, kSharedBytes = 512;
  std::unique_ptr<std::barrier<>> bar;
  EmuWarp warps[32];
  std::mutex named_mu;
  std::map<std::pair<int, int>, std::unique_ptr<std::barrier<>>> named;
  alignas(16) unsigned char dyn_smem[256 * 1024];
  alignas(16) unsigned char static_smem[kSharedArrays][kSharedBytes];
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_block;
inline thread_local unsigned char* emu_dyn_smem;

// The block's copy of the static __shared__ array declared at site `id`
// (one __COUNTER__ value per declaration), n elements of T.
template <class T>
T* emu_shared(int n, int id) {
  if (id >= EmuBlock::kSharedArrays || n * sizeof(T) > EmuBlock::kSharedBytes) {
    std::fprintf(stderr, "emu_shared: array %d of %d elements does not fit\n", id, n);
    std::abort();
  }
  return reinterpret_cast<T*>(emu_block->static_smem[id]);
}

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }

// EMU_STALL="id:ms" in the environment makes every thread sleep ms
// milliseconds before each group_sync on barrier id: a way to run one
// group of warps far behind another and so to walk a hand-off through the
// schedules a fast group never shows. Read at each launch.
inline int emu_stall_id = -1, emu_stall_ms = 0;

// The barrier that `nthreads` threads of the block share under `id`.
inline std::barrier<>* emu_named_barrier(int id, int nthreads) {
  std::lock_guard<std::mutex> lock(emu_block->named_mu);
  auto& slot = emu_block->named[{id, nthreads}];
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

// Clusters: the launch's blocks per cluster, every running block's state
// (the running clusters' ranks in turn), and per running cluster the
// barrier of all its threads; a thread's cluster starts at
// emu_cluster_base in emu_cluster_blocks.
inline int emu_cluster = 1;
inline std::vector<EmuBlock*> emu_cluster_blocks;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_cluster_bars;
inline thread_local int emu_cluster_base;
inline thread_local std::barrier<>* emu_cluster_bar;

inline int cluster_rank() { return (int)(blockIdx.x % emu_cluster); }
inline int cluster_nblocks() { return emu_cluster; }
inline void cluster_sync() { emu_cluster_bar->arrive_and_wait(); }

// mapa: p, which points into this block's dynamic shared memory, at the
// same offset in rank `rank`'s.
template <class T>
T* cluster_map(T* p, int rank) {
  const auto* c = reinterpret_cast<const unsigned char*>(p);
  const long off = c - emu_dyn_smem;
  if (off < 0 || off >= (long)sizeof(EmuBlock::dyn_smem) || rank < 0 || rank >= emu_cluster) {
    std::fprintf(stderr, "cluster_map: offset %ld, rank %d out of range\n", off, rank);
    std::abort();
  }
  return reinterpret_cast<T*>(emu_cluster_blocks[emu_cluster_base + rank]->dyn_smem + off);
}

// atomicAdd on an int in global memory: the old value.
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int tid = threadIdx.x;
  EmuWarp& w = emu_block->warps[tid / 32];
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
inline void cp_async_4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
// EMU_CLUSTER_SKEW=us: at each commit of asynchronous copies (once a step
// in the cluster wavefront), a thread of cluster rank r sleeps r*us
// microseconds, so that the ranks drift apart wherever no barrier holds
// them together. Read at each launch.
inline int emu_cluster_skew_us = 0;
inline void cp_async_commit() {
  if (emu_cluster > 1 && emu_cluster_skew_us > 0)
    std::this_thread::sleep_for(std::chrono::microseconds(cluster_rank() * emu_cluster_skew_us));
}
template <int N>
void cp_async_wait() {}

// mbarriers (see the top of the file), changed and waited on under one
// mutex whose condition variable every arrival wakes. EMU_CLUSTER_SKEW
// also delays each remote arrival by rank r's r*us microseconds.
constexpr unsigned long long kEmuMbarTag = 0x6D62ULL << 48;
inline std::mutex emu_mbar_mu;
inline std::condition_variable emu_mbar_cv;
inline void emu_mbar_check(unsigned long long v, const char* what) {
  if ((v >> 48) != (kEmuMbarTag >> 48)) {
    std::fprintf(stderr, "%s: not an mbarrier (never set up, or its block has exited)\n", what);
    std::abort();
  }
}
inline void mbar_init(unsigned long long* bar, int count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  *bar = kEmuMbarTag | ((unsigned long long)count << 16) | (unsigned long long)count;
}
inline void mbar_init_fence() {}
inline void mbar_arrive_cluster(unsigned long long* bar, int rank) {
  if (emu_cluster > 1 && emu_cluster_skew_us > 0)
    std::this_thread::sleep_for(std::chrono::microseconds(cluster_rank() * emu_cluster_skew_us));
  unsigned long long* p = cluster_map(bar, rank);
  {
    std::lock_guard<std::mutex> lock(emu_mbar_mu);
    const unsigned long long v = *p;
    emu_mbar_check(v, "mbar_arrive_cluster");
    const unsigned long long count = v & 0xFFFF, pending = (v >> 16) & 0xFFFF;
    const unsigned long long phase = (v >> 32) & 0xFFFF;
    *p = pending == 1 ? kEmuMbarTag | (((phase + 1) & 0xFFFF) << 32) | (count << 16) | count
                      : kEmuMbarTag | (phase << 32) | ((pending - 1) << 16) | count;
  }
  emu_mbar_cv.notify_all();
}
inline void mbar_wait(unsigned long long* bar, int parity) {
  std::unique_lock<std::mutex> lock(emu_mbar_mu);
  const auto deadline = std::chrono::steady_clock::now() + std::chrono::seconds(60);
  for (;;) {
    const unsigned long long v = *bar;
    emu_mbar_check(v, "mbar_wait");
    if ((int)((v >> 32) & 1) != parity) return;
    if (emu_mbar_cv.wait_until(lock, deadline) == std::cv_status::timeout) {
      std::fprintf(stderr, "mbar_wait: no phase of parity %d completed in 60 s\n", parity);
      std::abort();
    }
  }
}

// mma.sync.m16n8k32 s8 x s8 -> s32 with the fragment layout documented in
// segdp_kernels.cuh: the warp's lanes publish their A and B registers,
// then each lane sums its own four outputs from the assembled tiles.
inline void mma_m16n8k32_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const int tid = threadIdx.x;
  EmuWarp& w = emu_block->warps[tid / 32];
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

// Runs body() as every thread of every block of `grid`, `concurrent`
// blocks at once: one std::thread per CUDA thread of each group for the
// whole launch, with a block barrier before and after each block while
// thread 0 sets it up. With `cluster` > 1 the launch runs in clusters of
// that many blocks (grid.x a multiple of it), `concurrent` clusters at
// once, each cluster's blocks all together.
template <class F>
void emu_launch(dim3 grid, int threads, F body, int concurrent = 1, int cluster = 1) {
  if (cluster > 1) {
    if (grid.x % cluster != 0 || grid.y != 1) {
      std::fprintf(stderr, "emu_launch: grid %u is not made of clusters of %d\n", grid.x, cluster);
      std::abort();
    }
    concurrent *= cluster;
  }
  emu_cluster = cluster;
  emu_cluster_bars.clear();
  for (int i = 0; i < concurrent / cluster; ++i)
    emu_cluster_bars.push_back(std::make_unique<std::barrier<>>((std::ptrdiff_t)cluster * threads));
  emu_cluster_blocks.clear();
  gridDim = grid;
  blockDim = dim3(threads);
  if (const char* stall = std::getenv("EMU_STALL"))
    std::sscanf(stall, "%d:%d", &emu_stall_id, &emu_stall_ms);
  if (const char* skew = std::getenv("EMU_CLUSTER_SKEW")) emu_cluster_skew_us = std::atoi(skew);
  const unsigned blocks = grid.x * grid.y;
  std::vector<std::unique_ptr<EmuBlock>> groups;
  std::vector<std::thread> ts;
  ts.reserve((size_t)concurrent * threads);
  for (int c = 0; c < concurrent; ++c) {
    groups.push_back(std::make_unique<EmuBlock>());
    EmuBlock* blk = groups.back().get();
    emu_cluster_blocks.push_back(blk);
    blk->bar = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk->warps[w].bar = std::make_unique<std::barrier<>>(32);
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([t, c, cluster, concurrent, grid, blocks, blk, &body] {
        threadIdx = dim3(t);
        emu_block = blk;
        emu_cluster_base = c / cluster * cluster;
        emu_cluster_bar = emu_cluster_bars[c / cluster].get();
        emu_dyn_smem = blk->dyn_smem;
        for (unsigned lin = c; lin < blocks; lin += concurrent) {
          blockIdx = dim3(lin % grid.x, lin / grid.x);
          if (t == 0) std::memset(blk->dyn_smem, 0xAB, sizeof(blk->dyn_smem));
          blk->bar->arrive_and_wait();
          body();
          blk->bar->arrive_and_wait();
          if (t == 0) std::memset(blk->dyn_smem, 0xCD, sizeof(blk->dyn_smem));  // the block exited
        }
      });
    }
  }
  for (auto& t : ts) t.join();
}
