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
//    OT[j][k][k_], so the wavefront reads contiguous planes. It exists in
//    two bodies that compute the same integers:
//      pair_stats_mma_body (K1): the contraction on the tensor cores, only
//        over the entries the wavefront reads (below);
//      pair_stats_body (K2): every entry, as a register-tiled int32
//        product on the CUDA cores.
//  - wavefront_body (phases 2-3 and the chain walk), one problem on a
//    group of warps. H (P x P f32) lives in shared memory; the backward
//    wavefront over j is P strictly dependent steps, each a set of
//    independent masked row maxima (one warp per row, first-index
//    tie-break) read from the OT plane j, touching only the rows that can
//    be valid (j < k < end). Then the top-level row-major first argmax
//    against the no-split baseline, and (K1) one thread follows the
//    backpointers from the top pair and writes the -1-terminated chain of
//    P+2 entries that the dispatch reads back, so no launch follows the
//    kernel (ops/segdp.py:_walk_chains is the plain version).
//
// K1 replaces freddie_tpu/ops/segdp_pallas.py:_kernel. The TPU kernel
// keeps one problem's (P, P, P) outside tensor in VMEM (1 MiB at P = 64);
// a Hopper block has at most 227 KB of shared memory, so K1 is two
// launches with the outside tensor in global memory: pair_stats_kernel,
// grid (P, B), one block per (problem, k); then wavefront_kernel, grid
// (B), one block per problem.
//
// K1's phase 1 on this card (pair_stats_mma_body):
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
// launch: block g of G owns problems g, g+G, ... and runs one step more
// than it owns problems; at step t a producer group of 8 warps computes
// problem t's pair statistics into scratch slot t mod 2 while a consumer
// group of 4 warps runs problem t-1's wavefront and argmax from the
// other slot, and a block-wide barrier ends the step. What bounds it:
// phase 1 (pair_stats_body: ~2 P^3 R int32 multiply-adds per problem on
// the CUDA cores), now on one block per problem instead of P, so G x 8
// warps carry all of it (G is the number of blocks the card holds at
// once); the wavefront's P dependent steps are hidden under the next
// problem's phase 1 when a block owns two problems or more. A block
// owning one problem (B <= G, e.g. the segment stage's chunks of 64) gets
// no overlap: its consumer waits a whole step for the producer.
//
// -inf is only ever added to finite values or to -inf, so no NaN arises.

#pragma once

namespace segdp {

constexpr int kThreads = 256;  // the wavefront's blocks; K2's producer group
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // pair-statistics output tile edge (rows j, columns k_)
constexpr int kStage = 32;  // reps per shared-memory stage: one per lane
constexpr int kMinSegLen = 5;  // segments shorter than 5 bp are forbidden
constexpr int kConsumerWarps = 4;  // K2's wavefront group
constexpr int kPipeThreads = kThreads + 32 * kConsumerWarps;
constexpr int kProducerBar = 1;  // K2's named barriers; 0 is the whole block
constexpr int kConsumerBar = 2;
constexpr int kMmaStage = 64;  // reps per stage of K1's phase 1: two per lane
constexpr int kMmaWarps = 8;  // warps of a block of K1's phase 1
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaNt = 32 / kMmaWarps;  // 8-column product tiles a warp owns
constexpr int kOpRow = 2 * kMmaStage + 32;  // bytes of one operand row of a stage, padded

#ifndef CUDA_EMU
// Barrier over the `nthreads` threads (whole warps) that use barrier `id`;
// memory accesses before it are visible to those threads after it. The
// CPU emulator (tests/cuda_emu/emu.h) supplies its own.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
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

// Phase 1 of K1 for middle index k of one problem, on kMmaThreads threads
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

// Phase 1 of K2 for middle index k of one problem, on kThreads threads (tid
// 0..kThreads-1) sharing barrier `bar`. Cb: (P, R) scale*C; Thb/Tlb: (P, P)
// threshold products of the pair (row, column); Wb: (R,) integer weights;
// wsum: their sum. Writes OTb[j][k][k_] = gated outside(j, k, k_) for all
// j, k_ and INb[j][k] = inside(j, k).
__device__ __forceinline__ void pair_stats_body(
    const int* __restrict__ Cb, const int* __restrict__ Thb,
    const int* __restrict__ Tlb, const int* __restrict__ Wb, int wsum,
    float* OTb, float* INb, int k, int P, int R, int read_support, int tid,
    int bar) {
  // (W*yea(j,k), W*nay(j,k)) for the tile's rows j, and
  // (nay(k,k_), yea(k,k_)) for its columns k_; one row per rep of the
  // stage, padded by one pair against bank conflicts.
  __shared__ int2 A[kStage][kTile + 1];
  __shared__ int2 F[kStage][kTile + 1];
  __shared__ int ck[kStage];
  __shared__ int wr[kStage];
  __shared__ int t_to[2][kTile];    // T_hi, T_lo of the pair (j, k)
  __shared__ int t_from[2][kTile];  // T_hi, T_lo of the pair (k, k_)
  __shared__ int rowsum[kTile];

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int j0 = 0; j0 < P; j0 += kTile) {
    for (int c0 = 0; c0 < P; c0 += kTile) {
      const bool with_inside = (c0 == 0);
      group_sync(bar, kThreads);  // the previous tile is done with t_to/t_from/rowsum
      if (tid < kTile) {
        const int j = j0 + tid;
        t_to[0][tid] = j < P ? Thb[(long long)j * P + k] : 0;
        t_to[1][tid] = j < P ? Tlb[(long long)j * P + k] : 0;
        rowsum[tid] = 0;
      } else if (tid < 2 * kTile) {
        const int q = c0 + tid - kTile;
        t_from[0][tid - kTile] = q < P ? Thb[(long long)k * P + q] : 0;
        t_from[1][tid - kTile] = q < P ? Tlb[(long long)k * P + q] : 0;
      }

      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0;

      for (int r0 = 0; r0 < R; r0 += kStage) {
        group_sync(bar, kThreads);  // A/F are free, t_to/t_from are visible
        if (tid < kStage) {
          const int r = r0 + tid;
          ck[tid] = r < R ? Cb[(long long)k * R + r] : 0;
          wr[tid] = r < R ? Wb[r] : 0;
        }
        group_sync(bar, kThreads);
        const int r = r0 + lane;
        const bool r_in = r < R;
        const int ckr = ck[lane];
        const int w = wr[lane];
        for (int p = warp; p < kTile; p += kWarps) {
          const int j = j0 + p;
          int2 a = make_int2(0, 0);
          if (j < P && r_in) {
            const int d = ckr - Cb[(long long)j * R + r];  // scale*(C[k]-C[j])
            a.x = d > t_to[0][p] ? w : 0;
            a.y = d < t_to[1][p] ? w : 0;
          }
          A[lane][p] = a;
          if (with_inside) {
            const int s = warp_sum(a.x + a.y);
            if (lane == 0) rowsum[p] += s;
          }
          const int q = c0 + p;
          int2 f = make_int2(0, 0);
          if (q < P && r_in) {
            const int d = Cb[(long long)q * R + r] - ckr;  // scale*(C[q]-C[k])
            f.x = d < t_from[1][p] ? 1 : 0;  // nay(k, q)
            f.y = d > t_from[0][p] ? 1 : 0;  // yea(k, q)
          }
          F[lane][p] = f;
        }
        group_sync(bar, kThreads);
#pragma unroll 4
        for (int s = 0; s < kStage; ++s) {
          int2 a[4], f[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = A[s][ty + 16 * i];
#pragma unroll
          for (int c = 0; c < 4; ++c) f[c] = F[s][tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (j0 + 16 * i >= P) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c0 + 16 * c >= P) continue;
              acc[i][c] += a[i].x * f[c].x + a[i].y * f[c].y;
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + ty + 16 * i;
        if (j >= P) continue;
        float* row = OTb + ((long long)j * P + k) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = c0 + tx + 16 * c;
          if (q >= P) continue;
          const int v = acc[i][c];
          row[q] = v < read_support ? -INFINITY : (float)v;
        }
      }
      if (with_inside && tid < kTile && j0 + tid < P) {
        // inside(j, k) = -(w_sum - sum_r W*yea - sum_r W*nay)
        INb[(long long)(j0 + tid) * P + k] = (float)(rowsum[tid] - wsum);
      }
    }
  }
}

// Phases 2-3 of one problem, on `nwarps` warps (tid 0..32*nwarps-1, at
// most kWarps) sharing barrier `bar`. Reads OTb/INb as phase 1 wrote them,
// yb: (P,) positions, n_cand; H: P*P floats and ys: P ints of shared
// memory. Writes Kb: (P, P) backpointers (rows 0..P-2; row P-1 holds
// best_j, best_k in columns 0 and 1, -1 elsewhere, as the TPU kernel
// stores them) and *bj, *bk; and, when `chain` is not null, the P+2
// entries of the breakpoint chain: best_j, best_k, then K[j][k] followed
// from the top pair while it is >= 0, -1 from there on (all -1 when no
// segmentation won). Only entries that phase 1 of K1 writes are read.
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

// K2, grid (G) with G <= B, kPipeThreads threads. Inputs and outputs as
// K1's; OT: (G, 2, P, P, P) and INS: (G, 2, P, P) are per-block scratch
// slots (not restrict: written and read within the launch). Dynamic shared
// memory: P*P floats + P ints.
__global__ void __launch_bounds__(kPipeThreads)
segdp_pipelined_kernel(const int* __restrict__ Cs, const int* __restrict__ Thi,
                       const int* __restrict__ Tlo, const int* __restrict__ Wt,
                       const int* __restrict__ wsum, const int* __restrict__ y,
                       const int* __restrict__ n_cand, float* OT, float* INS,
                       int* K, int* __restrict__ best_j,
                       int* __restrict__ best_k, int B, int P, int R,
                       int read_support) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  float* H = reinterpret_cast<float*>(segdp_dyn_smem);
  int* ys = reinterpret_cast<int*>(H + P * P);
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int owned = (B - g + G - 1) / G;  // problems g, g+G, g+2G, ...
  const int tid = threadIdx.x;
  const long long PP = (long long)P * P;
  const long long PPP = PP * P;

  for (int t = 0; t <= owned; ++t) {
    if (tid < kThreads) {
      if (t < owned) {  // producer: problem t's phase 1 into slot t % 2
        const long long b = g + (long long)t * G;
        const long long slot = 2LL * g + (t & 1);
        for (int k = 0; k < P; ++k)
          pair_stats_body(Cs + b * P * R, Thi + b * PP, Tlo + b * PP, Wt + b * R,
                          wsum[b], OT + slot * PPP, INS + slot * PP, k, P, R,
                          read_support, tid, kProducerBar);
      }
    } else if (t > 0) {  // consumer: problem t-1's phases 2-3 from the other slot
      const long long b = g + (long long)(t - 1) * G;
      const long long slot = 2LL * g + ((t - 1) & 1);
      wavefront_body(OT + slot * PPP, INS + slot * PP, y + b * P, n_cand[b],
                     K + b * PP, best_j + b, best_k + b, nullptr, P, H, ys,
                     tid - kThreads, kConsumerWarps, kConsumerBar);
    }
    __syncthreads();  // slot t % 2 is complete; slot (t-1) % 2 is free
  }
}

}  // namespace segdp
