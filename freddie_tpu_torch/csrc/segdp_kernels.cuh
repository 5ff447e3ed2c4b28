// Segmentation breakpoint DP on Hopper: the device kernels.
//
// Computes what freddie_tpu/ops/segdp_pallas.py computes, and what its
// plain PyTorch twin freddie_tpu_torch/ops/segdp.py:_solve_batch_torch
// computes, bit for bit. Two phases:
//
//  - phase 1, the pair statistics, for one problem's middle index k.
//    Threshold compares of scale*(C[k]-C[p]) against the integer products
//    T_hi/T_lo give the yea/nay indicators; the pair contraction
//        O(j, k, k_) = sum_r W_r (yea(j,k,r) nay(k,k_,r) + nay(j,k,r) yea(k,k_,r))
//    is gated to -inf below read_support and written j-major,
//    OT[j][k][k_], so the wavefront reads contiguous planes. One body,
//    pair_stats_mma_body, serves both kernels: the contraction on the
//    tensor cores, only over the entries the wavefront reads (below).
//  - the wavefront (phases 2-3 and the chain walk): the backward sweep
//    over j is P strictly dependent steps, each a set of independent
//    masked row maxima (one warp per row, first-index tie-break) over the
//    OT plane j and H (P x P f32), touching only the rows that can be
//    valid (j < k < end). Then the top-level row-major first argmax
//    against the no-split baseline, and one thread follows the
//    backpointers from the top pair and writes the -1-terminated chain of
//    P+2 entries that the dispatch reads back, so no launch follows the
//    kernel (ops/segdp.py:_walk_chains is the plain version).
//
// K1 replaces freddie_tpu/ops/segdp_pallas.py:_kernel. The TPU kernel
// keeps one problem's (P, P, P) outside tensor in VMEM (1 MiB at P = 64);
// a Hopper block has at most 227 KB of shared memory, so K1 is two
// launches with the outside tensor in global memory: pair_stats_kernel,
// grid (P, B), one block per (problem, k); then the wavefront, in one of
// two kernels chosen by P (segdp_cuda.CLUSTER_MIN_P; routing by shape):
//  - wavefront_kernel, grid (B): wavefront_body on one block of 8 warps
//    per problem, H in its shared memory. Narrow buckets come in batches
//    of hundreds, which fill the card with one block each.
//  - wavefront_cluster_kernel, grid (N*B): a thread-block cluster of N
//    blocks per problem, for the wide buckets, whose batches hold a few
//    problems. What bounds the wavefront there is latency, not work: P
//    dependent steps, and in each a warp's walk along a row of up to P
//    columns. With one block per problem, each step's row walk waited on
//    its loads of the outside plane from device memory, one dependent
//    round trip per 32 columns (~40 ms at P = 512), on as many SMs as the
//    batch has problems. The cluster kernel cuts both: (1) block r owns
//    rows k = r, r+N, ... (cyclic, so the shrinking triangle stays even),
//    so a step's rows are spread over N SMs; (2) the outside planes do not
//    depend on the wavefront (phase 1 wrote all of them before), so each
//    thread copies the words of the rows it will walk -- the live part of
//    each, exactly the words it will read -- into shared memory with
//    cp.async ahead of the step that reads them, and a step reads only
//    shared memory; (3) each block keeps its rows of H in its own shared
//    memory, as triangles (row k holds columns k+1..P-1 only, which is all
//    the sweep touches), so every read of H is local; the one value a row
//    produces per step, H[j][k], goes to row j's owner by a DSMEM store.
//    One cluster barrier per step (arrive.release, wait.acquire) orders
//    those stores before the next step's reads. What is left per step is
//    the barrier's round trip across the cluster and the row walks in
//    shared memory; chip_smoke times the first alone. The copies go into
//    one of two rings, chosen by shape (segdp_cuda.row_ring_for; template
//    flag kRowRing): where it fits, a ring of two whole planes, each
//    block's rows of plane j-1 copied while step j runs; above that, each
//    warp's ring of kRingRows rows of P floats, which it fills in the
//    order it walks its rows, a row ahead and across the step barrier.
//    Two planes grow with P^2/N and stop fitting a block (P = 674 on 8
//    blocks, 948 on 16); the row ring grows with P, so the kernel takes
//    every P whose scratch fits the card. On one H100 the row ring took
//    1.10-1.15x the plane ring's launch time where both fit (PERF.md,
//    PR 10), hence both. H lives in the cluster's shared memory up to the
//    widest P whose triangle fits a block beside the ring of rows
//    (segdp_cuda.cluster_smem_max_p); above that the same kernel keeps
//    its rows in a (B, P, P) f32 plane in device memory (template flag
//    kSmemH false), and a cap of 0 forces that route at any P, which is
//    how the tests reach it at small shapes. The top level merges each
//    block's argmax in rank 0's shared memory through DSMEM, and rank 0
//    walks the chain from K in device memory.
// Phase 1 tiles any P, and its output is in device memory already, so
// nothing else changes with P. The wrapper solves the batch in groups
// whose scratch fits a budget, reusing one set of scratch buffers, so the
// (P, P, P) plane per problem (512 MiB at P = 512) never has to be held
// for the whole batch at once.
//
// Phase 1 on this card (pair_stats_mma_body; K1 runs one block per
// (problem, k), K2's producer group runs a problem's k in turn):
//  - Only live work. The wavefront reads outside(j, k, k_) only for
//    j < k < k_ <= end = n_cand-1, and inside(j, k) only for j < k <= end.
//    A block with k = 0 or k > end returns at once; the others build
//    rows j < k and columns k <= k_ <= end only, and every 16-row or
//    8-column sub-tile outside that range is skipped. Entries nobody
//    reads are never written.
//  - The contraction on the tensor cores, exact. The operands are built
//    in shared memory as s8: A[j][2r+h] = W_r * (h ? nay : yea)(j,k,r) and
//    B[k_][2r+h] = (h ? yea : nay)(k,k_,r), so one product over the 2R-deep
//    axis is the whole sum. Column k_ = k, which no pair uses, is set to
//    all ones: its product is sum_r W_r (yea + nay)(j,k,r), the inside
//    row sum, riding the same pass. Weights above 127 run one pass per
//    7-bit limb, highest first, the s32 sums shifted left by 7 between
//    passes (scores stay below 2^24, so that is exact, and four limbs
//    cover every weight below 2^28); the pass count comes from the
//    problem's largest weight. s8 x s8 -> s32 has no rounding mode:
//    allow_tf32 and the float32 matmul precision cannot touch it.
//  - mma.sync.m16n8k32 at every P, not wgmma. The live rectangle of
//    block k is k rows by end-k columns, at most 32 x 31 of a P = 64
//    problem and smaller at every other k: a 64-row wgmma tile would be
//    half padding at its best k and three quarters at P = 32, while
//    16 x 8 tiles follow the rectangle's edge. The product is also the
//    small part of the block's work (below), so wgmma's rate would not
//    show.
//  - One set of slots. Block k needs each candidate's row of C once: as
//    an output row (A operand) when the candidate lies below k, as an
//    output column (B operand) when it lies above. So a problem of
//    P <= 64 candidates keeps one set of 64 slots, slot s holding
//    candidate s, where separate row and column tiles would keep 128
//    half-empty ones: 53 KB of shared memory a block, four blocks an SM.
//    A wider problem is cut into 64 x 64 output tiles with a set of
//    slots each for the tile's rows and columns, and yea/nay(j,k,.) is
//    rebuilt per tile pass; at P <= 64 it is built once per (j,k).
//  - What bounds it: instruction issue in building the indicators,
//    (end+1)*R compares of 32-bit differences per block on the CUDA
//    cores. So the build is kept to a dozen instructions per slot and
//    pair of reps: a lane owns two reps of every slot of its warp, the
//    wrapper pads R to whole stages with zero weights (no rep needs a
//    bounds check), every branch depends on the slot alone (a warp never
//    diverges), the weight limbs are shifted into place once per stage,
//    and a fragment is fetched in 8-byte loads. The C values arrive by
//    8-byte cp.async into a two-stage buffer of 64 reps per stage --
//    every thread copies exactly the words it compares itself, so a
//    wait_group orders them and no barrier is needed -- and the operand
//    rows are double-buffered, so stage s+1's copies and indicator build
//    overlap stage s's product with one barrier per stage.
//
// K2, segdp_pipelined_kernel, replaces
// freddie_tpu/ops/segdp_pallas.py:_kernel_pipelined, which interleaves
// problem b's phase 1 with problem b-1's phases 2-3 inside one TPU grid
// step. Here that overlap is warp specialisation in one persistent
// launch of G blocks (as many as the card holds at once, at most B):
//  - The producer group, two warpgroups (8 warps), runs
//    pair_stats_mma_body for k = 1..end of one problem after another,
//    into the block's two scratch slots in global memory, OT (G, 2, P, P,
//    P) and INS (G, 2, P, P), in turn. It writes the live entries only,
//    and the consumer reads only entries that the same problem's producer
//    wrote (`end` is the same on both sides), so what an earlier occupant
//    left in a slot is never looked at.
//  - The consumer group, one warpgroup (4 warps), runs wavefront_body on
//    the slot that is full and writes K, best_j, best_k and the chain.
//  - The hand-off is per slot, through named barriers of all 12 warps:
//    "full" (the producers arrive with bar.arrive after a block-scope
//    fence, the consumers wait in bar.sync) and "free" (the reverse). No
//    block-wide barrier ends a step: the producer stalls only when both
//    slots are full, the consumer only when neither is. The problem a slot
//    holds travels with it in shared memory; a number >= B ends the
//    consumer. On leaving, the producer waits for the last "free", so
//    every arrival is matched by a wait.
//  - Work: block g starts with problem g and then takes the next problem
//    from a counter in global memory (atomicAdd by one thread, zeroed by
//    the wrapper), because problems differ several times in live work
//    (C(n_cand, 3) triples) and blocks that own g, g+G, ... wait for the
//    unluckiest. The results do not depend on the order.
//  - Shared memory, all dynamic: one PairSmem, then H, ys and four ints
//    of hand-off state: 70 KB at P <= 64, two blocks of 12 warps per SM;
//    a wider problem takes PairSmem<128> (105 KB), one block per SM, and
//    fits up to P = 176 (segdp_cuda.K2_SMEM_MAX_P). Above that cap (the
//    template's kSmemH false) the consumer's H is the block's own (P, P)
//    plane of a (G, P, P) f32 scratch in device memory, indexed by the
//    block and not by the problem: two blocks that run at once must never
//    share one. G is also bounded by the scratch the wrapper's budget
//    allows; the queue is right for every G >= 1.
//  - Registers are what stop a third block: two blocks of 384 threads
//    get 80 registers a thread, and the phase-1 body inside the step loop
//    spills at 80. The consumer needs 32, so at P <= 64 it releases the
//    rest (setmaxnreg) and the producers take 104 each. A third block
//    would leave 56 a thread and 16 KB of L1 beside 212 KB of shared
//    memory; it measured slower than two.
// What bounds it is what bounds phase 1 (the indicator build on the CUDA
// cores), now on 16 producer warps per SM where K1 has 32, too few to
// cover that loop's barriers and latencies as K1's four blocks do; the
// wavefront's P dependent steps hide under the next problem's phase 1. A
// block that gets one problem (B <= G, e.g. the segment stage's chunks of
// 64) runs its k in series and then the wavefront, with nothing to
// overlap: K1 is the kernel for those.
//
// K2 for wide problems, segdp_pipelined_cluster_kernel (the route by
// shape: segdp_cuda.K2_CLUSTER_MIN_P). A wide batch holds a few problems,
// so one block per problem put a whole problem's phase 1 on one SM and
// its wavefront on four warps with H in device memory: ~9,000x its bound.
// The cluster route gives each problem a thread-block cluster of N = 8 or
// 16 persistent blocks, each with K2's two groups:
//  - the producers of rank r run phase 1 for the middle indices k = r,
//    r+N, ... of the cluster's problem, so phase 1 runs on N SMs;
//  - the consumers run the cluster wavefront of K1
//    (wavefront_cluster_body): rank r owns rows k = r, r+N, ..., keeps
//    their H in its shared memory, streams their rows of the outside
//    planes ahead and stores H[j][k] into row j's owner.
//  - The ownership lines up: phase 1 for k writes row k of every outside
//    plane and inside(., k), which is what the owner of row k reads, so a
//    block's consumers read what its own producers wrote, but for
//    inside(k, end) (the H init) and the baseline inside(0, end).
//  - The hand-off is cluster-wide, through mbarriers in each block's
//    shared memory (thread q of each block arrives remotely on rank q's
//    barrier, with release at cluster scope; the waiters acquire):
//    a slot is "full" once all N producer groups are done with it and
//    "free" once all N consumer groups are; the consumers' step barrier is
//    a pair of mbarriers in turn, since barrier.cluster would also wait
//    for the producers, who are in the next problem's phase 1.
//  - Cluster c takes problems c, c+G, ... (G clusters, as many as are
//    resident at once and as the scratch budget allows, at most B), so
//    the clusters need share nothing; a wide batch rarely has more
//    problems than clusters, and then each cluster's next phase 1
//    overlaps its previous wavefront.
// Its block holds PairSmem<128>, the mbarriers and K1's cluster layout
// for its 4 consumer warps; H fits beside the ring of rows up to
// segdp_cuda.k2_cluster_smem_max_p(N) and is a (G, P, P) device-memory
// plane a cluster above, so the route takes every P whose scratch fits
// the card. The one-block route above runs by shape only below
// K2_CLUSTER_MIN_P; from there on it is reached only when forced, as the
// card tests' independent witness.
//
// -inf is only ever added to finite values or to -inf, so no NaN arises.

#pragma once

namespace segdp {

constexpr int kThreads = 256;  // the wavefront's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // pair-statistics output tile edge (rows j, columns k_)
constexpr int kMinSegLen = 5;  // segments shorter than 5 bp are forbidden
constexpr int kConsumerWarps = 4;  // K2's wavefront group
constexpr int kMmaStage = 64;  // reps per stage of phase 1: two per lane
constexpr int kMmaWarps = 8;  // warps of phase 1: K1's block, K2's producer group
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPipeThreads = kMmaThreads + 32 * kConsumerWarps;
constexpr int kProducerBar = 1;  // K2's named barriers; 0 is the whole block
constexpr int kConsumerBar = 2;
constexpr int kFullBar = 3;  // + slot: the slot's pair statistics are complete
constexpr int kFreeBar = 5;  // + slot: the slot's wavefront is done
// K2 at two blocks per SM starts with 80 registers a thread; the consumer
// warpgroup hands its surplus to the two producer warpgroups:
// 128 * 32 + 256 * 104 = 384 * 80.
constexpr int kConsumerRegs = 32;
constexpr int kProducerRegs = 104;
constexpr int kMmaNt = 32 / kMmaWarps;  // 8-column product tiles a warp owns
constexpr int kOpRow = 2 * kMmaStage + 32;  // bytes of one operand row of a stage, padded
constexpr int kConsumerThreads = 32 * kConsumerWarps;
// The cluster wavefront's rings: of whole outside planes, kOtStages
// triangles a block; or of rows, kRingRows row slots a warp
// (segdp_cuda.row_ring_for chooses by shape).
constexpr int kOtStages = 2;
constexpr int kRingRows = 2;
constexpr int kMaxCluster = 16;  // blocks a cluster may have (16 is non-portable)
// K2's cluster route: its mbarriers in each block, two of each kind (a
// ring, indexed by step or slot parity), and the bytes reserved for them.
constexpr int kStepMbar = 0;  // + step & 1: every block's consumers are done with the step
constexpr int kFullMbar = 2;  // + slot: every block's producers have filled the slot
constexpr int kFreeMbar = 4;  // + slot: every block's consumers are done with the slot
constexpr int kPipeMbars = 6;
constexpr int kPipeMbarBytes = 64;

#ifndef CUDA_EMU
// Barrier over the `nthreads` threads (whole warps) that use barrier `id`;
// memory accesses before it are visible to those threads after it. The
// CPU emulator (tests/cuda_emu/emu.h) supplies its own.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}
// Arrives at barrier `id` without waiting (PTX bar.arrive): the barrier
// completes once `nthreads` threads have arrived or wait in group_sync on
// it, and what this thread wrote before, to shared or global memory, is
// visible to the threads it releases.
__device__ __forceinline__ void group_arrive(int id, int nthreads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}
#endif

#ifndef CUDA_EMU
// setmaxnreg: a whole warpgroup gives registers back to its block's pool
// (reg_release) or takes them from it, waiting until they are there
// (reg_take); N a multiple of 8. The CPU emulator makes both no-ops.
template <int N>
__device__ __forceinline__ void reg_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
#endif

#ifndef CUDA_EMU
// Asynchronous 8-byte copy from global to shared memory (both addresses
// 8-byte aligned); the copies a thread has started since its last commit
// form one group, and cp_async_wait<N> returns once all but its N newest
// groups have landed.
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(gmem) : "memory");
}
// The same for 4 bytes (both addresses 4-byte aligned).
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The tensor-core step: D (16 x 8, s32) += A (16 x 32, s8) * B (32 x 8, s8),
// one call per warp, all 32 lanes together. With g = lane / 4 and
// t = lane % 4, each 32-bit register packs four consecutive s8 along the
// depth, lowest byte first:
//   a[0] = A[g    ][4t .. 4t+3]      a[1] = A[g + 8][4t .. 4t+3]
//   a[2] = A[g    ][16+4t .. 16+4t+3]  a[3] = A[g + 8][16+4t .. 16+4t+3]
//   b[0] = B[4t .. 4t+3][g]          b[1] = B[16+4t .. 16+4t+3][g]
//   d[0] = D[g][2t]   d[1] = D[g][2t+1]   d[2] = D[g+8][2t]   d[3] = D[g+8][2t+1]
// The CPU emulator (tests/cuda_emu/emu.h) implements the same layout in
// plain C++.
__device__ __forceinline__ void mma_m16n8k32_s8(int (&d)[4], const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

#ifndef CUDA_EMU
// Thread-block clusters. The block's rank in its cluster and the
// cluster's number of blocks.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_nblocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}
// The address of the variable at `p` (this block's shared memory) in the
// shared memory of the cluster's block `rank` (DSMEM): a generic address
// that plain loads and stores take.
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}
// Barrier over every thread of the cluster: what a thread wrote before it,
// to its own or another block's shared memory or to device memory, is
// visible to every thread of the cluster after it (arrive with release,
// wait with acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// mbarriers in shared memory, for K2's cluster route, where one group of
// warps has to wait for the same group in the cluster's other blocks
// while the rest of each block is elsewhere. mbar_init sets the barrier
// at `bar` (this block's shared memory, 8 bytes) to complete a phase
// after `count` arrivals; one thread calls it, and mbar_init_fence makes
// the initialisation visible to the cluster (a cluster barrier must
// follow before any other block arrives).
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// One arrival on the barrier at the same offset as `bar` in the shared
// memory of the cluster's block `rank`, with release at cluster scope:
// what this thread wrote before, and what the threads it passed a
// barrier with wrote before that, is visible to a thread whose
// mbar_wait sees the phase complete.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}
// Waits, with acquire at cluster scope, until the phase of this block's
// barrier `bar` whose parity is `parity` has completed (phases count
// from 0 at mbar_init).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
#endif

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Larger value wins; on a tie the smaller index (the first in scan order).
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_merge(v, i, ov, oi);
  }
}

// Shared memory of pair_stats_mma_body (dynamic: it passes 48 KB). A slot
// holds one row of C for the stage and the operand row built from it.
template <int kSlots>
struct PairSmem {
  int2 raw[2][kSlots][kMmaStage / 2];     // [stage][slot][lane]: scale*C of the lane's two reps
  unsigned char op[2][kSlots][kOpRow];    // [stage][slot][2*rep + half]: s8 operands
  int2 thr[kSlots];                       // (T_hi, T_lo) of the slot's pair with k
};

// What a slot is built into.
enum SlotKind { kDead = 0, kRowA = 1, kColOnes = 2, kColB = 3 };

// Slot s of the output tile at (j0, c0) for middle index k: its kind and
// the candidate (row of C) it is built from. With kSlots == kTile the
// problem is one tile (P <= kTile, j0 = c0 = 0) and candidate s is slot s:
// an output row below k, the all-ones column at k, an output column up to
// `end`, dead beyond. Otherwise slots 0..kTile-1 are the tile's rows and
// slots kTile.. its columns.
template <int kSlots>
__device__ __forceinline__ int slot_kind(int s, int j0, int c0, int k, int end, int& cand) {
  if (kSlots == kTile) {
    cand = s;
    return s < k ? kRowA : s == k ? kColOnes : s <= end ? kColB : kDead;
  }
  if (s < kTile) {
    cand = j0 + s;
    return cand < k ? kRowA : kDead;
  }
  cand = c0 + s - kTile;
  return (cand < k || cand > end) ? kDead : cand == k ? kColOnes : kColB;
}

// Phase 1 for middle index k of one problem, on kMmaThreads threads
// (tid 0..kMmaThreads-1) sharing barrier `bar`: the live part only, with the
// contraction on the tensor cores (design in the header). Cb: (P, R)
// scale*C; Thb/Tlb: (P, P) threshold products of the pair (row, column);
// Wb: (R,) integer weights, wsum their sum, wmax the largest; end =
// n_cand-1. R is a multiple of kMmaStage (the wrapper pads the reps with
// zero weights). Writes OTb[j][k][k_] = gated outside(j, k, k_) for
// j < k < k_ <= end and INb[j][k] = inside(j, k) for j < k <= end, and
// nothing else.
//
// A 64 x 64 output tile is cut into 16 x 8 products: warp w owns rows
// 16*(w%4).. and the kMmaNt 8-column tiles from column 8*kMmaNt*(w/4). A
// stage is kMmaStage = 64 reps, two per lane; warp w builds the operand
// rows of slots w, w + kMmaWarps, ... Every branch of the stage loop
// depends on the slot alone, so a warp never diverges in it. Operand rows
// are kOpRow = 160 bytes apart, so the four rows that one phase of an
// 8-byte fragment load touches fall into distinct banks. Rows and columns
// of a fragment that are not live hold whatever the slot holds; their
// sums are dropped in the epilogue. Weight limbs run from the highest
// down, the accumulators shifted left by 7 between passes, so one set of
// registers holds the sum.
template <int kSlots>
__device__ __forceinline__ void pair_stats_mma_body(
    const int* __restrict__ Cb, const int* __restrict__ Thb,
    const int* __restrict__ Tlb, const int* __restrict__ Wb, int wsum, int wmax,
    float* OTb, float* INb, int k, int end, int P, int R, int read_support,
    int tid, int bar, PairSmem<kSlots>* sm) {
  if (k <= 0 || k > end) return;  // no live row, or no live column

  constexpr int kPerWarp = kSlots / kMmaWarps;  // slots a warp builds per stage
  constexpr int kColBase = kSlots - kTile;  // slot of the tile's first column
  constexpr int kLaneStride = kMmaStage / 2;  // int2 per stage of one row
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rt = warp & 3;  // this warp's 16-row tile
  const int cg = warp >> 2;  // and its group of kMmaNt 8-column tiles
  const int n_stages = R / kMmaStage;
  const int2* Ck2 = reinterpret_cast<const int2*>(Cb + (long long)k * R) + lane;
  const int2* W2 = reinterpret_cast<const int2*>(Wb) + lane;
  int n_limbs = 1;
  while (n_limbs < 4 && (wmax >> (7 * n_limbs)) > 0) ++n_limbs;

  for (int j0 = 0; j0 < k; j0 += kTile) {
    for (int c0 = (k / kTile) * kTile; c0 <= end; c0 += kTile) {
      group_sync(bar, kMmaThreads);  // the previous tile's builds and products are done
      for (int s = tid; s < kSlots; s += kMmaThreads) {
        int cand;
        const int kind = slot_kind<kSlots>(s, j0, c0, k, end, cand);
        int2 t = make_int2(0, 0);
        if (kind == kRowA) {
          t = make_int2(Thb[(long long)cand * P + k], Tlb[(long long)cand * P + k]);
        } else if (kind == kColB) {
          t = make_int2(Thb[(long long)k * P + cand], Tlb[(long long)k * P + cand]);
        }
        sm->thr[s] = t;
      }
      group_sync(bar, kMmaThreads);

      const bool rows_live = j0 + 16 * rt < k;
      bool cols_live[kMmaNt];
#pragma unroll
      for (int nt = 0; nt < kMmaNt; ++nt) {
        const int qlo = c0 + 8 * kMmaNt * cg + 8 * nt;
        cols_live[nt] = qlo + 7 >= k && qlo <= end;
      }

      int acc[kMmaNt][4];
#pragma unroll
      for (int nt = 0; nt < kMmaNt; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][c] = 0;

      for (int limb = n_limbs - 1; limb >= 0; --limb) {
        if (limb != n_limbs - 1) {
          // The last product of the previous pass may still read the
          // operand buffer that this pass's first build writes.
          group_sync(bar, kMmaThreads);
#pragma unroll
          for (int nt = 0; nt < kMmaNt; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[nt][c] <<= 7;
        }

        int2 ck_next = make_int2(0, 0), w_next = make_int2(0, 0);
        // Starts stage s's copies into raw[s % 2]: this thread's own
        // words only (its warp's slots, its lane's two reps), so its
        // wait_group orders them for it and nobody else reads them.
        auto fetch = [&](int s) {
          ck_next = Ck2[s * kLaneStride];
          w_next = W2[s * kLaneStride];
#pragma unroll
          for (int i = 0; i < kPerWarp; ++i) {
            const int slot = warp + kMmaWarps * i;
            int cand;
            const int kind = slot_kind<kSlots>(slot, j0, c0, k, end, cand);
            if (kind == kRowA || kind == kColB) {
              cp_async_8(&sm->raw[s & 1][slot][lane],
                         reinterpret_cast<const int2*>(Cb + (long long)cand * R) +
                             s * kLaneStride + lane);
            }
          }
          cp_async_commit();
        };

        if (n_stages > 0) fetch(0);
        for (int s = 0; s < n_stages; ++s) {
          const int buf = s & 1;
          const int2 ck = ck_next;
          // The lane's two weights' limbs, placed at the four bytes of an
          // A operand word: (yea, nay) of the first rep, then of the second.
          const unsigned wl0 = (unsigned)(w_next.x >> (7 * limb)) & 127u;
          const unsigned wl1 = (unsigned)(w_next.y >> (7 * limb)) & 127u;
          const unsigned a0 = wl0, a1 = wl0 << 8, a2 = wl1 << 16, a3 = wl1 << 24;
          if (s + 1 < n_stages) {
            fetch(s + 1);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          // Build stage s's operands: four s8 per (slot, lane).
#pragma unroll
          for (int i = 0; i < kPerWarp; ++i) {
            const int slot = warp + kMmaWarps * i;
            int cand;
            const int kind = slot_kind<kSlots>(slot, j0, c0, k, end, cand);
            if (kind == kDead) continue;
            unsigned v = 0x01010101u;  // column k: all ones, the inside row sum
            if (kind != kColOnes) {
              const int2 c = sm->raw[buf][slot][lane];
              const int2 t = sm->thr[slot];
              if (kind == kRowA) {
                // W * yea(j,k,r), W * nay(j,k,r); d = scale*(C[k]-C[j])
                const int d0 = ck.x - c.x, d1 = ck.y - c.y;
                v = (d0 > t.x ? a0 : 0u) | (d0 < t.y ? a1 : 0u) |
                    (d1 > t.x ? a2 : 0u) | (d1 < t.y ? a3 : 0u);
              } else {
                // nay(k,q,r), yea(k,q,r); d = scale*(C[q]-C[k])
                const int d0 = c.x - ck.x, d1 = c.y - ck.y;
                v = (d0 < t.y ? 1u : 0u) | (d0 > t.x ? 0x100u : 0u) |
                    (d1 < t.y ? 0x10000u : 0u) | (d1 > t.x ? 0x1000000u : 0u);
              }
            }
            *reinterpret_cast<unsigned*>(&sm->op[buf][slot][4 * lane]) = v;
          }
          group_sync(bar, kMmaThreads);  // stage s's operands are complete
          if (rows_live) {
#pragma unroll
            for (int ks = 0; ks < 2 * kMmaStage / 32; ++ks) {
              // The sum runs over all 32 bytes of the step whatever their
              // order, and A and B rows are stored alike, so a lane takes
              // the 8 bytes at 8*t4 for its two depth registers in one
              // load where the layout names bytes 4*t4 and 16 + 4*t4.
              const unsigned char* ar = &sm->op[buf][16 * rt + g][32 * ks + 8 * t4];
              const uint2 a_lo = *reinterpret_cast<const uint2*>(ar);
              const uint2 a_hi = *reinterpret_cast<const uint2*>(ar + 8 * kOpRow);
              const unsigned a[4] = {a_lo.x, a_hi.x, a_lo.y, a_hi.y};
#pragma unroll
              for (int nt = 0; nt < kMmaNt; ++nt) {
                if (!cols_live[nt]) continue;
                const uint2 b2 = *reinterpret_cast<const uint2*>(
                    &sm->op[buf][kColBase + 8 * kMmaNt * cg + 8 * nt + g][32 * ks + 8 * t4]);
                const unsigned b[2] = {b2.x, b2.y};
                mma_m16n8k32_s8(acc[nt], a, b);
              }
            }
          }
        }
      }

      // Gate and convert straight from the s32 sums.
      if (rows_live) {
#pragma unroll
        for (int nt = 0; nt < kMmaNt; ++nt) {
          if (!cols_live[nt]) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 16 * rt + g + 8 * (c >> 1);
            const int q = c0 + 8 * kMmaNt * cg + 8 * nt + 2 * t4 + (c & 1);
            if (j >= k) continue;
            const int v = acc[nt][c];
            if (q == k) {
              // inside(j, k) = -(w_sum - sum_r W*yea - sum_r W*nay)
              INb[(long long)j * P + k] = (float)(v - wsum);
            } else if (q > k && q <= end) {
              OTb[((long long)j * P + k) * P + q] =
                  v < read_support ? -INFINITY : (float)v;
            }
          }
        }
      }
    }
  }
}

// Phases 2-3 of one problem, on `nwarps` warps (tid 0..32*nwarps-1, at
// most kWarps) sharing barrier `bar`. Reads OTb/INb as phase 1 wrote them,
// yb: (P,) positions, n_cand; H: P*P floats of shared memory or of device
// memory that only this group reads and writes (K2's consumer above its
// shared-memory cap: the group_sync step barrier orders a row's writes
// before the next step's reads in either memory); ys: P ints of shared
// memory. Writes Kb: (P, P)
// backpointers (rows 0..P-2; row P-1 holds best_j, best_k in columns 0
// and 1, -1 elsewhere, as the TPU kernel stores them) and *bj, *bk; and,
// when `chain` is not null, the P+2
// entries of the breakpoint chain: best_j, best_k, then K[j][k] followed
// from the top pair while it is >= 0, -1 from there on (all -1 when no
// segmentation won). Only entries that phase 1 writes are read.
__device__ __forceinline__ void wavefront_body(
    const float* OTb, const float* INb, const int* __restrict__ yb, int n_cand,
    int* Kb, int* bj_out, int* bk_out, int* chain, int P, float* H, int* ys,
    int tid, int nwarps, int bar) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int nthreads = 32 * nwarps;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int PP = P * P;
  const int end = n_cand - 1;
  const float neg = -INFINITY;

  for (int i = tid; i < P; i += nthreads) ys[i] = yb[i];
  // H init: column `end` holds inside(j, end) for j < end, -inf elsewhere.
  for (int idx = tid; idx < PP; idx += nthreads) {
    const int a = idx / P;
    const int c = idx - a * P;
    H[idx] = (c == end && a < end) ? INb[a * P + end] : neg;
    Kb[idx] = -1;
  }
  group_sync(bar, nthreads);

  // Backward wavefront: H[j][k] = inside(j,k) + max_{k_} (outside(j,k,k_)
  // + H[k][k_]) over k_ in (k, end] with !small(k, k_), for the k in
  // (j, end) with !small(j, k) whose max is finite; every other entry of
  // row j keeps its initial value, exactly as the masked row update of
  // the JAX and TPU kernels leaves it. Row j is written while rows > j
  // are read, so one barrier per step suffices.
  for (int j = P - 2; j >= 0; --j) {
    const float* O = OTb + (long long)j * PP;  // O[k*P + k_] = outside(j, k, k_)
    for (int k = j + 1 + warp; k < end; k += nwarps) {
      if (ys[k] - ys[j] < kMinSegLen) continue;  // small(j, k): row invalid
      float bv = neg;
      int bi = P;
      for (int q = k + 1 + lane; q <= end; q += 32) {
        if (ys[q] - ys[k] < kMinSegLen) continue;  // small(k, k_)
        const float v = O[k * P + q] + H[k * P + q];
        if (v > bv) {
          bv = v;
          bi = q;
        }
      }
      warp_argmax(bv, bi);
      if (lane == 0 && bv > neg) {
        H[j * P + k] = INb[j * P + k] + bv;
        Kb[j * P + k] = bi;
      }
    }
    group_sync(bar, nthreads);
  }

  // Top level: D0[j][k] = inside(0,j) + outside(0,j,k) + H[j][k] over
  // 0 < j < end, j < k <= end, !small(0,j), !small(j,k); row-major first
  // argmax, kept only when strictly above inside(0, end).
  float bv = neg;
  int bi = PP;
  for (int idx = tid; idx < PP; idx += nthreads) {
    const int jj = idx / P;
    const int kk = idx - jj * P;
    if (jj > 0 && jj < end && kk > jj && kk <= end &&
        ys[jj] - ys[0] >= kMinSegLen && ys[kk] - ys[jj] >= kMinSegLen) {
      const float v = (INb[jj] + OTb[idx]) + H[idx];
      if (v > bv) {
        bv = v;
        bi = idx;
      }
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  group_sync(bar, nthreads);
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w) argmax_merge(bv, bi, red_v[w], red_i[w]);
    const bool ok = bv > INb[end];  // baseline: inside(0, end)
    const int bj = ok ? bi / P : -1;
    const int bk = ok ? bi - (bi / P) * P : -1;
    *bj_out = bj;
    *bk_out = bk;
    Kb[(P - 1) * P] = bj;
    if (P > 1) Kb[(P - 1) * P + 1] = bk;
    if (chain != nullptr) {
      // Every step depends on the one before, so one thread walks; the
      // backpointers it reads were written before the barriers above.
      chain[0] = bj;
      chain[1] = bk;
      int j = bj, kk = bk;
      bool alive = ok;
      for (int i = 0; i < P; ++i) {
        int nxt = -1;
        if (alive) {
          nxt = Kb[j * P + kk];
          alive = nxt >= 0;
        }
        chain[2 + i] = alive ? nxt : -1;
        if (alive) {
          j = kk;
          kk = nxt;
        }
      }
    }
  }
}

// K1, launch 1, grid (P, B), kMmaThreads threads. Cs: (B, P, R) scale*C
// with R a multiple of kMmaStage; Thi/Tlo: (B, P, P); Wt: (B, R); wsum,
// wmax, n_cand: (B,). kSlots is kTile when P <= kTile and 2*kTile
// otherwise. Writes the live entries of OT: (B, P, P, P) and INS:
// (B, P, P). Dynamic shared memory: one PairSmem<kSlots>.
template <int kSlots>
__global__ void __launch_bounds__(kMmaThreads, kSlots == kTile ? 4 : 1)
pair_stats_kernel(const int* __restrict__ Cs, const int* __restrict__ Thi,
                  const int* __restrict__ Tlo, const int* __restrict__ Wt,
                  const int* __restrict__ wsum, const int* __restrict__ wmax,
                  const int* __restrict__ n_cand, float* __restrict__ OT,
                  float* __restrict__ INS, int P, int R, int read_support) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  const int b = blockIdx.y;
  const long long PP = (long long)P * P;
  pair_stats_mma_body<kSlots>(
      Cs + (long long)b * P * R, Thi + b * PP, Tlo + b * PP, Wt + (long long)b * R,
      wsum[b], wmax[b], OT + b * PP * P, INS + b * PP, blockIdx.x, n_cand[b] - 1, P,
      R, read_support, threadIdx.x, 0, reinterpret_cast<PairSmem<kSlots>*>(segdp_dyn_smem));
}

// K1, launch 2, grid (B). Reads OT/INS from launch 1, y: (B, P), n_cand:
// (B,). Writes K: (B, P, P), best_j/best_k: (B,) and chains: (B, P+2).
// Dynamic shared memory: P*P floats + P ints.
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const float* __restrict__ OT, const float* __restrict__ INS,
                 const int* __restrict__ y, const int* __restrict__ n_cand,
                 int* K, int* __restrict__ best_j, int* __restrict__ best_k,
                 int* __restrict__ chains, int P) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  float* H = reinterpret_cast<float*>(segdp_dyn_smem);
  int* ys = reinterpret_cast<int*>(H + P * P);
  const int b = blockIdx.x;
  const long long PP = (long long)P * P;
  wavefront_body(OT + b * PP * P, INS + b * PP, y + (long long)b * P, n_cand[b],
                 K + b * PP, best_j + b, best_k + b, chains + (long long)b * (P + 2),
                 P, H, ys, threadIdx.x, kWarps, 0);
}

// Offset, in floats, of row li of cluster block r's packed triangle: the
// block owns rows k = r + li*N (cyclic), and row k keeps only its columns
// k+1..P-1, the ones the wavefront reads or writes (H[k][q] and
// outside(j, k, q) for q > k). Row li starts at sum_{l < li} (P-1-(r+l*N)).
__host__ __device__ __forceinline__ int tri_row_off(int li, int r, int N, int P) {
  return li * (P - 1 - r) - N * (li * (li - 1) / 2);
}
// Floats of block r's whole triangle; rank 0's is the largest, and every
// block of a cluster lays its shared memory out by rank 0's sizes, so an
// offset means the same in all of them.
__host__ __device__ __forceinline__ int tri_floats(int r, int N, int P) {
  return r < P ? tri_row_off((P - 1 - r) / N + 1, r, N, P) : 0;
}

// Dynamic shared memory of wavefront_cluster_body at width P with N
// blocks a cluster on nwarps warps: H's triangle when it lives there, the
// ring -- each warp's kRingRows rows of P floats when row_ring, else
// kOtStages triangles of outside planes --, ys, and the cluster's argmax
// slots.
__host__ __device__ __forceinline__ int cluster_smem_bytes(int P, int N, bool smem_h, int nwarps,
                                                           bool row_ring) {
  const int tri = tri_floats(0, N, P);
  const int ring = row_ring ? nwarps * kRingRows * P : kOtStages * tri;
  return 4 * ((smem_h ? tri : 0) + ring + P) + 8 * kMaxCluster;
}

// The cluster wavefront of one problem, on `nwarps` warps (tid
// 0..32*nwarps-1, at most kWarps) of each block of a cluster of N blocks;
// K1's wavefront_cluster_kernel runs it on whole blocks, K2's
// segdp_pipelined_cluster_kernel on each block's consumer group. The
// design and what bounds it are in the header. The block of rank r owns
// rows k = r, r+N, ... of H and computes H[j][k], K[j][k] for those k at
// every step j, from its own rows of H and from outside plane j, which
// its warps walk row by row: warp w takes rows li = first_row(j) + w,
// + nwarps, ... (k = r + li*N). Each word of a row is copied into shared
// memory ahead of the step by the thread that reads it, so that thread's
// cp.async wait orders it, into one of two rings (segdp_cuda.row_ring_for
// chooses by shape):
//  - !kRowRing, the ring of whole planes: at step j each thread copies
//    its words of plane j-1's rows into ring stage (j-1) % kOtStages, a
//    triangle laid out as H's, one commit group a plane; the stage is
//    rewritten only after the step barrier that ends its last reads. Two
//    triangles a block grow with P^2/N, so this ring is taken where it
//    fits (P up to 774 on 16 blocks with H beside it, 550 on 8).
//  - kRowRing, each warp's ring of kRingRows rows of P floats: the warp
//    streams its rows into it in the order it walks them, kRingRows-1
//    rows ahead of its walk and across the step barrier (the outside
//    planes do not change during the wavefront), one commit group a row;
//    lane l owns a slot's words l, l+32, ... whatever
//    the row, and a slot is refilled only after a __syncwarp that follows
//    every lane's reads of it, so no block- or cluster-wide barrier frees
//    a slot. It grows with P, not P^2: any P whose scratch fits the card.
// H[j][k] goes to row j's owner: through DSMEM when H is in shared memory
// (kSmemH), into Hgb: (P, P) f32 in device memory otherwise (written and
// read by the cluster, so neither const nor __restrict__). `smem` is the
// body's shared memory, laid out alike in every block
// (cluster_smem_bytes with the same nwarps and ring). step_sync() is the step barrier over the body's threads in
// every block of the cluster: what they wrote before it (to shared memory,
// theirs or another block's, and to device memory) is visible to all of
// them after it. It orders the initialisation before the first step, step
// j's writes before the reads of step j-1, and the merge below before rank
// 0 reads it; `bar` (with the body's thread count) is a barrier over the
// body's threads of this block alone. The top level: each block's first
// argmax over its rows, merged in rank 0's slots through DSMEM under
// (value desc, index asc); the step barrier after the merge writes is the
// body's last access to another block's shared memory. Rank 0's thread 0
// then walks the chain from K in device memory. OTb, INb, yb, n_cand, Kb,
// bj_out, bk_out and chain as wavefront_body's.
template <bool kSmemH, bool kRowRing, class StepSync>
__device__ __forceinline__ void wavefront_cluster_body(
    const float* OTb, const float* INb, const int* __restrict__ yb, int n_cand, float* Hgb,
    int* Kb, int* bj_out, int* bk_out, int* chain, int P, unsigned char* smem,
    int tid, int nwarps, int bar, StepSync step_sync) {
  __shared__ float wred_v[kWarps];
  __shared__ int wred_i[kWarps];

  const int N = cluster_nblocks();
  const int r = cluster_rank();
  const int nthreads = 32 * nwarps;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long PP = (long long)P * P;
  const int end = n_cand - 1;
  const float neg = -INFINITY;

  const int tri = tri_floats(0, N, P);
  float* Hs = reinterpret_cast<float*>(smem);  // kSmemH: this block's rows of H
  // kRowRing: [warp][slot][P]; else [stage][triangle]
  float* ring = Hs + (kSmemH ? tri : 0);
  int* ys = reinterpret_cast<int*>(ring + (kRowRing ? nwarps * kRingRows * P : kOtStages * tri));
  float* merge_v = reinterpret_cast<float*>(ys + P);  // [rank]: the blocks' argmaxes, in rank 0
  int* merge_i = reinterpret_cast<int*>(merge_v + kMaxCluster);

  // Row k (owned by this block, k = r + li*N) of H: row[q] = H[k][q], q > k.
  auto h_row = [&](int li, int k) -> float* {
    return kSmemH ? Hs + tri_row_off(li, r, N, P) - (k + 1) : Hgb + (long long)k * P;
  };
  // The first row this block owns below... above j: the least li with k > j.
  auto first_row = [&](int j) { return j < r ? 0 : (j - r) / N + 1; };
  // Step j for row k = r + li*N, from O[q] = outside(j, k, q): H[j][k] =
  // inside(j, k) + the first-index max over q of O[q] + H[k][q] (masked
  // by small(k, q)), stored into row j's owner when finite; K[j][k] its q.
  auto walk = [&](int j, int li, int k, const float* O) {
    const float* Hr = h_row(li, k);
    float bv = neg;
    int bi = P;
    for (int q = k + 1 + lane; q <= end; q += 32) {
      if (ys[q] - ys[k] < kMinSegLen) continue;  // small(k, k_)
      const float v = O[q] + Hr[q];
      if (v > bv) {
        bv = v;
        bi = q;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0 && bv > neg) {
      const float h = INb[(long long)j * P + k] + bv;
      const int owner = j % N;
      if (kSmemH)
        cluster_map(Hs, owner)[tri_row_off(j / N, owner, N, P) + (k - j - 1)] = h;
      else
        Hgb[(long long)j * P + k] = h;
      Kb[(long long)j * P + k] = bi;
    }
  };

  for (int i = tid; i < P; i += nthreads) ys[i] = yb[i];
  // H init of the rows this block owns: column `end` holds inside(k, end)
  // for k < end, -inf elsewhere; K's rows all -1.
  for (int li = 0, k = r; k < P; ++li, k += N) {
    float* row = h_row(li, k);
    for (int q = k + 1 + tid; q < P; q += nthreads)
      row[q] = (q == end && k < end) ? INb[(long long)k * P + end] : neg;
    for (int q = tid; q < P; q += nthreads) Kb[(long long)k * P + q] = -1;
  }

  if constexpr (kRowRing) {
    ring += warp * kRingRows * P;  // this warp's
    // This warp's stream of rows, in the order it walks them: step j's
    // live rows (j < k < end, !small(j, k)) li = first_row(j) + warp,
    // + nwarps, ..., then step j-1's, down to step 0. seek moves the
    // cursor (j, li) to the first of them at or after it; j < 0 once none
    // is left.
    auto seek = [&](int& j, int& li) {
      while (j >= 0) {
        for (int k = r + li * N; k < end; li += nwarps, k += nwarps * N)
          if (ys[k] - ys[j] >= kMinSegLen) return;
        if (--j >= 0) li = first_row(j) + warp;
      }
    };
    // The fetch's cursor (fj, fli) runs kRingRows-1 rows ahead of the walk's
    // (wj, wli): fetch starts the copies of its row's live columns
    // k < q <= end into slot fslot (word q-k-1 by lane (q-k-1) % 32) and
    // commits them as one group, an empty one past the stream's end.
    int fj = P - 2, fli = first_row(P - 2) + warp, fslot = 0;
    auto fetch = [&] {
      if (fj >= 0) {
        const int k = r + fli * N;
        const float* src = OTb + (long long)fj * PP + (long long)k * P + (k + 1);
        float* dst = ring + fslot * P;
        for (int c = lane; c < end - k; c += 32) cp_async_4(dst + c, src + c);
        fli += nwarps;
        seek(fj, fli);
      }
      cp_async_commit();
      fslot = fslot + 1 == kRingRows ? 0 : fslot + 1;
    };

    step_sync();  // every block's rows and ys initialised before any step writes to them
    seek(fj, fli);
    int wj = fj, wli = fli, wslot = 0;
    for (int i = 1; i < kRingRows; ++i) fetch();
    for (int j = P - 2; j >= 0; --j) {
      for (; wj == j; wli += nwarps, seek(wj, wli), wslot = wslot + 1 == kRingRows ? 0 : wslot + 1) {
        __syncwarp();  // every lane is done with the slot that fetch refills (the last row's)
        fetch();
        cp_async_wait<kRingRows - 1>();  // this lane's copies of the walk's row have landed
        const int k = r + wli * N;
        walk(j, wli, k, ring + wslot * P - (k + 1));
      }
      step_sync();  // step j's writes before step j-1's reads
    }
  } else {
    // Starts the copies of plane j's live rows that this block owns (rows
    // j < k < end with !small(j, k), columns k < q <= end) into ring stage
    // j % kOtStages, each by the thread that reads it at step j; one
    // commit group per plane, empty past plane 0.
    auto fetch = [&](int j) {
      if (j >= 0) {
        float* st = ring + (j % kOtStages) * tri;
        const float* O = OTb + (long long)j * PP;
        for (int li = first_row(j) + warp, k = r + li * N; k < end;
             li += nwarps, k += nwarps * N) {
          if (ys[k] - ys[j] < kMinSegLen) continue;
          float* dst = st + tri_row_off(li, r, N, P) - (k + 1);
          for (int q = k + 1 + lane; q <= end; q += 32)
            cp_async_4(dst + q, O + (long long)k * P + q);
        }
      }
      cp_async_commit();
    };

    step_sync();  // every block's rows and ys initialised before any step writes to them
    fetch(P - 2);
    for (int j = P - 2; j >= 0; --j) {
      fetch(j - 1);  // the next step's plane, in flight during this one
      cp_async_wait<kOtStages - 1>();  // this thread's copies of plane j have landed
      const float* st = ring + (j % kOtStages) * tri;
      for (int li = first_row(j) + warp, k = r + li * N; k < end; li += nwarps, k += nwarps * N) {
        if (ys[k] - ys[j] < kMinSegLen) continue;  // small(j, k): row invalid
        walk(j, li, k, st + tri_row_off(li, r, N, P) - (k + 1));
      }
      step_sync();  // step j's writes before step j-1's reads; the stage is free again
    }
  }

  // Top level over the rows this block owns: D0[j][k] = inside(0,j) +
  // outside(0,j,k) + H[j][k] over 0 < j < end, j < k <= end, !small(0,j),
  // !small(j,k); the first argmax in row-major order.
  float bv = neg;
  int bi = P * P;
  for (int li = 0, jj = r; jj < end; ++li, jj += N) {
    if (jj == 0 || ys[jj] - ys[0] < kMinSegLen) continue;
    const float* Hr = h_row(li, jj);
    for (int kk = jj + 1 + tid; kk <= end; kk += nthreads) {
      if (ys[kk] - ys[jj] < kMinSegLen) continue;
      const int idx = jj * P + kk;
      argmax_merge(bv, bi, (INb[jj] + OTb[idx]) + Hr[kk], idx);
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) {
    wred_v[warp] = bv;
    wred_i[warp] = bi;
  }
  group_sync(bar, nthreads);
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w) argmax_merge(bv, bi, wred_v[w], wred_i[w]);
    cluster_map(merge_v, 0)[r] = bv;
    cluster_map(merge_i, 0)[r] = bi;
  }
  // The body's last access to another block's shared memory is above.
  step_sync();
  if (r != 0 || tid != 0) return;
  bv = merge_v[0];
  bi = merge_i[0];
  for (int s = 1; s < N; ++s) argmax_merge(bv, bi, merge_v[s], merge_i[s]);
  const bool ok = bv > INb[end];  // baseline: inside(0, end)
  const int bj = ok ? bi / P : -1;
  const int bk = ok ? bi - (bi / P) * P : -1;
  *bj_out = bj;
  *bk_out = bk;
  Kb[(P - 1) * P] = bj;
  if (P > 1) Kb[(P - 1) * P + 1] = bk;
  chain[0] = bj;
  chain[1] = bk;
  int j = bj, kk = bk;
  bool alive = ok;
  for (int i = 0; i < P; ++i) {
    int nxt = -1;
    if (alive) {
      nxt = Kb[(long long)j * P + kk];
      alive = nxt >= 0;
    }
    chain[2 + i] = alive ? nxt : -1;
    if (alive) {
      j = kk;
      kk = nxt;
    }
  }
}

// K1, launch 2, on a thread-block cluster of N blocks per problem (grid
// N*B, cluster (N)): wavefront_cluster_body on every thread of the
// cluster, the step barrier the cluster barrier (release then acquire),
// which every block also passes after the merge, its last access to
// another block's shared memory, before it exits. Hg: (B, P, P) f32, the
// problems' H planes when H is in device memory (not kSmemH). Inputs and
// outputs as wavefront_kernel's. Dynamic shared memory:
// cluster_smem_bytes(P, N, kSmemH, kWarps, kRowRing).
template <bool kSmemH, bool kRowRing>
__global__ void __launch_bounds__(kThreads)
wavefront_cluster_kernel(const float* __restrict__ OT, const float* __restrict__ INS,
                         const int* __restrict__ y, const int* __restrict__ n_cand, float* Hg,
                         int* K, int* __restrict__ best_j, int* __restrict__ best_k,
                         int* __restrict__ chains, int P) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  const int b = blockIdx.x / cluster_nblocks();
  const long long PP = (long long)P * P;
  wavefront_cluster_body<kSmemH, kRowRing>(
      OT + b * PP * P, INS + b * PP, y + (long long)b * P, n_cand[b], Hg + b * PP, K + b * PP,
      best_j + b, best_k + b, chains + (long long)b * (P + 2), P, segdp_dyn_smem,
      threadIdx.x, kWarps, 0, [] { cluster_sync(); });
}

// The wavefront's latency floor: `steps` rounds of the cluster barrier
// and nothing else, on clusters of N blocks (grid N*B, cluster (N)).
__global__ void __launch_bounds__(kThreads) cluster_barrier_kernel(int steps) {
  for (int s = 0; s < steps; ++s) cluster_sync();
}

// K2, grid (G) with G <= B, kPipeThreads threads: threads below
// kMmaThreads produce, the rest consume (design in the header). Inputs and
// outputs as K1's; OT: (G, 2, P, P, P) and INS: (G, 2, P, P) are per-block
// scratch slots (not restrict: written and read within the launch, so no
// load of them may take the non-coherent path). queue: one int at zero
// from which the blocks draw problems G, G+1, ... kSlots as for K1's
// launch 1. kSmemH: H in shared memory; otherwise Hg: (G, P, P) f32, the
// plane of block g for block g (not restrict, for the reason OT is not;
// ignored when kSmemH). Dynamic shared memory: one PairSmem<kSlots>, P*P
// floats when kSmemH, P ints, 4 ints.
template <int kSlots, bool kSmemH>
__global__ void __launch_bounds__(kPipeThreads, kSlots == kTile ? 2 : 1)
segdp_pipelined_kernel(const int* __restrict__ Cs, const int* __restrict__ Thi,
                       const int* __restrict__ Tlo, const int* __restrict__ Wt,
                       const int* __restrict__ wsum, const int* __restrict__ wmax,
                       const int* __restrict__ y, const int* __restrict__ n_cand,
                       float* OT, float* INS, float* Hg, int* K, int* __restrict__ best_j,
                       int* __restrict__ best_k, int* __restrict__ chains, int* queue,
                       int B, int P, int R, int read_support) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  PairSmem<kSlots>* pair = reinterpret_cast<PairSmem<kSlots>*>(segdp_dyn_smem);
  unsigned char* after_pair = segdp_dyn_smem + sizeof(PairSmem<kSlots>);
  const int g = blockIdx.x;
  float* H = kSmemH ? reinterpret_cast<float*>(after_pair) : Hg + (long long)g * P * P;
  int* ys = kSmemH ? reinterpret_cast<int*>(H + P * P) : reinterpret_cast<int*>(after_pair);
  volatile int* prob = ys + P;    // [slot]: the problem the slot holds, or >= B: the end
  volatile int* next = prob + 2;  // [slot]: thread 0's draw from the queue
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const long long PP = (long long)P * P;
  const long long PPP = PP * P;

  if (tid < kMmaThreads) {
    if (kSlots == kTile) reg_take<kProducerRegs>();
    // Producer. Step t puts problem b into slot t % 2; the step that finds
    // no problem left puts the end marker there.
    int b = g, t = 0;
    for (;; ++t) {
      const int s = t & 1;
      if (t >= 2) group_sync(kFreeBar + s, kPipeThreads);  // step t-2's problem has left
      if (tid == 0) prob[s] = b;
      if (b >= B) break;
      const long long slot = 2LL * g + s;
      const int end = n_cand[b] - 1;
      const int ws = wsum[b], wm = wmax[b];
      for (int k = 1; k <= end; ++k)
        pair_stats_mma_body<kSlots>(Cs + (long long)b * P * R, Thi + b * PP, Tlo + b * PP,
                                    Wt + (long long)b * R, ws, wm, OT + slot * PPP,
                                    INS + slot * PP, k, end, P, R, read_support, tid,
                                    kProducerBar, pair);
      if (tid == 0) next[s] = G + atomicAdd(queue, 1);
      // next[s] is written again two steps on, past the next step's barrier
      group_sync(kProducerBar, kMmaThreads);
      b = next[s];
      group_arrive(kFullBar + s, kPipeThreads);
    }
    group_arrive(kFullBar + (t & 1), kPipeThreads);
    // The consumer arrives at "free" after every problem; the step loop
    // waited for all but the last.
    if (t >= 1) group_sync(kFreeBar + ((t - 1) & 1), kPipeThreads);
  } else {
    if (kSlots == kTile) reg_release<kConsumerRegs>();
    for (int t = 0;; ++t) {
      const int s = t & 1;
      group_sync(kFullBar + s, kPipeThreads);
      const int b = prob[s];
      if (b >= B) break;
      const long long slot = 2LL * g + s;
      wavefront_body(OT + slot * PPP, INS + slot * PP, y + (long long)b * P, n_cand[b],
                     K + b * PP, best_j + b, best_k + b, chains + (long long)b * (P + 2),
                     P, H, ys, tid - kMmaThreads, kConsumerWarps, kConsumerBar);
      group_arrive(kFreeBar + s, kPipeThreads);
    }
  }
}

// Dynamic shared memory of a block of K2's cluster route at width P on N
// blocks a cluster, its consumers' ring of rows when row_ring: the
// producers' PairSmem<128>, the mbarriers, and the consumers' cluster
// wavefront (cluster_smem_bytes), in that order.
__host__ __device__ __forceinline__ int pipelined_cluster_smem_bytes(int P, int N, bool smem_h,
                                                                     bool row_ring) {
  return (int)sizeof(PairSmem<2 * kTile>) + kPipeMbarBytes +
         cluster_smem_bytes(P, N, smem_h, kConsumerWarps, row_ring);
}

// K2's route for wide problems, grid (N*G) in G thread-block clusters of N
// blocks, kPipeThreads threads a block: threads below kMmaThreads produce,
// the rest consume (design in the header). Cluster c solves problems c,
// c+G, c+2G, ... in turn, into its two scratch slots OT: (G, 2, P, P, P)
// and INS: (G, 2, P, P) (not restrict: written and read within the
// launch). The producers of the block of rank r run pair_stats_mma_body
// for the middle indices k = r, r+N, ... of the cluster's problem: exactly
// the rows of the outside planes and the columns of inside that this
// block's consumers read, but for inside(k, end), which the block that
// owns `end` writes. So a slot is full when every block's producers are
// done with it, and free when every block's consumers are: each block
// keeps one "full" and one "free" mbarrier per slot, and after its group's
// named barrier thread q of each block's producers (consumers) arrives on
// rank q's, N arrivals a phase, the N remote arrivals (each a release at
// cluster scope) side by side. The consumers run wavefront_cluster_body on
// the full slot, with H in the cluster's shared memory (kSmemH) or in Hg:
// (G, P, P) f32, cluster c's plane (not restrict, as OT); their step
// barrier is a pair of mbarriers used in turn, on which the consumers
// arrive the same way after their group's named barrier, so that a block
// that is a step ahead never arrives on a barrier another block is still
// waiting on. Problem t of a cluster waits for phase t/2 of slot t%2's
// "full", and its producers for phase t/2-1 of the slot's "free". Every
// thread of the cluster passes one cluster barrier after the barriers'
// initialisation and one before it exits, so no block arrives on another's
// barriers before they exist or after it has gone.
// Dynamic shared memory: pipelined_cluster_smem_bytes.
template <bool kSmemH, bool kRowRing>
__global__ void __launch_bounds__(kPipeThreads, 1)
segdp_pipelined_cluster_kernel(const int* __restrict__ Cs, const int* __restrict__ Thi,
                               const int* __restrict__ Tlo, const int* __restrict__ Wt,
                               const int* __restrict__ wsum, const int* __restrict__ wmax,
                               const int* __restrict__ y, const int* __restrict__ n_cand,
                               float* OT, float* INS, float* Hg, int* K,
                               int* __restrict__ best_j, int* __restrict__ best_k,
                               int* __restrict__ chains, int B, int P, int R,
                               int read_support) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  auto* pair = reinterpret_cast<PairSmem<2 * kTile>*>(segdp_dyn_smem);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(segdp_dyn_smem + sizeof(PairSmem<2 * kTile>));
  unsigned char* wave = segdp_dyn_smem + sizeof(PairSmem<2 * kTile>) + kPipeMbarBytes;
  const int N = cluster_nblocks();
  const int r = cluster_rank();
  const int c = blockIdx.x / N;
  const int G = gridDim.x / N;
  const int tid = threadIdx.x;
  const long long PP = (long long)P * P;
  const long long PPP = PP * P;

  if (tid == 0)
    for (int i = 0; i < kPipeMbars; ++i) mbar_init(&bars[i], N);
  mbar_init_fence();
  cluster_sync();  // every block's barriers are set up before any arrival

  if (tid < kMmaThreads) {
    for (int t = 0, b = c; b < B; ++t, b += G) {
      const int s = t & 1;
      if (t >= 2) mbar_wait(&bars[kFreeMbar + s], ((t >> 1) - 1) & 1);  // problem t-2 has left
      const long long slot = 2LL * c + s;
      const int end = n_cand[b] - 1;
      const int ws = wsum[b], wm = wmax[b];
      for (int k = r; k <= end; k += N)
        pair_stats_mma_body<2 * kTile>(Cs + (long long)b * P * R, Thi + b * PP, Tlo + b * PP,
                                       Wt + (long long)b * R, ws, wm, OT + slot * PPP,
                                       INS + slot * PP, k, end, P, R, read_support, tid,
                                       kProducerBar, pair);
      group_sync(kProducerBar, kMmaThreads);  // this block's part of the slot is written
      if (tid < N) mbar_arrive_cluster(&bars[kFullMbar + s], tid);
    }
  } else {
    const int ctid = tid - kMmaThreads;
    int step = 0;
    auto step_sync = [&] {
      group_sync(kConsumerBar, kConsumerThreads);  // this block's consumers are done
      unsigned long long* bar = &bars[kStepMbar + (step & 1)];
      if (ctid < N) mbar_arrive_cluster(bar, ctid);
      mbar_wait(bar, (step >> 1) & 1);
      ++step;
    };
    for (int t = 0, b = c; b < B; ++t, b += G) {
      const int s = t & 1;
      mbar_wait(&bars[kFullMbar + s], (t >> 1) & 1);
      const long long slot = 2LL * c + s;
      wavefront_cluster_body<kSmemH, kRowRing>(
          OT + slot * PPP, INS + slot * PP, y + (long long)b * P, n_cand[b], Hg + c * PP,
          K + b * PP, best_j + b, best_k + b, chains + (long long)b * (P + 2), P, wave,
          ctid, kConsumerWarps, kConsumerBar, step_sync);
      group_sync(kConsumerBar, kConsumerThreads);  // rank 0's chain walk included
      if (ctid < N) mbar_arrive_cluster(&bars[kFreeMbar + s], ctid);
    }
  }
  cluster_sync();  // no block exits while another may still arrive on its barriers
}

}  // namespace segdp
