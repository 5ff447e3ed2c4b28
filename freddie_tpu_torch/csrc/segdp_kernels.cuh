// Segmentation breakpoint DP on Hopper: the device kernels.
//
// Computes what freddie_tpu/ops/segdp_pallas.py computes, and what its
// plain PyTorch twin freddie_tpu_torch/ops/segdp.py:_solve_batch_torch
// computes, bit for bit. Two phases, each written once as a __device__
// body that runs on a group of threads with its own barrier, so that both
// kernel designs below run the same arithmetic:
//
//  - pair_stats_body (phase 1), one problem's middle index k on 256
//    threads. Threshold compares of scale*(C[k]-C[p]) against the integer
//    products T_hi/T_lo give the yea/nay indicators; the pair contraction
//        O(j, k, k_) = sum_r W_r (yea(j,k,r) nay(k,k_,r) + nay(j,k,r) yea(k,k_,r))
//    runs as a register-tiled int32 product over rep stages of 32 in
//    shared memory, exact for every weight (no 7-bit split needed: that
//    answered a bf16 MXU limit on the TPU). The result is gated to -inf
//    below read_support and written j-major, OT[j][k][k_], so the
//    wavefront reads contiguous planes (the TPU kernel's phase-1.5
//    transpose). Inside rows ride the same pass as warp sums. Each thread
//    keeps a 4x4 output tile in registers so every shared-memory load
//    feeds 4 multiply-adds, and the 16-byte-per-pair operand layout keeps
//    the loads free of bank conflicts.
//  - wavefront_body (phases 2-3), one problem on a group of warps. H
//    (P x P f32) lives in shared memory; the backward wavefront over j is
//    P strictly dependent steps, each a set of independent masked row
//    maxima (one warp per row, first-index tie-break) read from the OT
//    plane j, touching only the rows that can be valid (j < k < end).
//    Then the top-level row-major first argmax against the no-split
//    baseline.
//
// K1 replaces freddie_tpu/ops/segdp_pallas.py:_kernel. The TPU kernel
// keeps one problem's (P, P, P) outside tensor in VMEM (1 MiB at P = 64);
// a Hopper block has at most 227 KB of shared memory, so K1 is two
// launches with the outside tensor in global memory (L2-resident for the
// stage's chunks of 64 problems at P = 64: 64 MiB): pair_stats_kernel,
// grid (P, B), one block per (problem, k); then wavefront_kernel, grid
// (B), one block per problem. Bound on the H100: phase 1's ~2 P^3 R
// int32 multiply-adds per problem on CUDA cores (the int32 pipe runs at
// half the f32 rate).
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
// phase 1, now on one block per problem instead of P, so G x 8 warps
// carry all of it (G is the number of blocks the card holds at once);
// the wavefront's P dependent steps are hidden under the next problem's
// phase 1 when a block owns two problems or more. A block owning one
// problem (B <= G, e.g. the segment stage's chunks of 64) gets no
// overlap: its consumer waits a whole step for the producer.
//
// -inf is only ever added to finite values or to -inf, so no NaN arises.

#pragma once

namespace segdp {

constexpr int kThreads = 256;  // K1's blocks; K2's producer group
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // pair-statistics output tile edge (rows j, columns k_)
constexpr int kStage = 32;  // reps per shared-memory stage: one per lane
constexpr int kMinSegLen = 5;  // segments shorter than 5 bp are forbidden
constexpr int kConsumerWarps = 4;  // K2's wavefront group
constexpr int kPipeThreads = kThreads + 32 * kConsumerWarps;
constexpr int kProducerBar = 1;  // K2's named barriers; 0 is the whole block
constexpr int kConsumerBar = 2;

#ifndef CUDA_EMU
// Barrier over the `nthreads` threads (whole warps) that use barrier `id`;
// memory accesses before it are visible to those threads after it. The
// CPU emulator (tests/cuda_emu/emu.h) supplies its own.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
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

// Phase 1 for middle index k of one problem, on kThreads threads (tid
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
// stores them) and *bj, *bk.
__device__ __forceinline__ void wavefront_body(
    const float* OTb, const float* INb, const int* __restrict__ yb, int n_cand,
    int* __restrict__ Kb, int* bj_out, int* bk_out, int P, float* H, int* ys,
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
  }
}

// K1, launch 1, grid (P, B). Cs: (B, P, R) scale*C; Thi/Tlo: (B, P, P);
// Wt: (B, R); wsum: (B,). Writes OT: (B, P, P, P) and INS: (B, P, P).
__global__ void __launch_bounds__(kThreads)
pair_stats_kernel(const int* __restrict__ Cs, const int* __restrict__ Thi,
                  const int* __restrict__ Tlo, const int* __restrict__ Wt,
                  const int* __restrict__ wsum, float* __restrict__ OT,
                  float* __restrict__ INS, int P, int R, int read_support) {
  const int b = blockIdx.y;
  const long long PP = (long long)P * P;
  pair_stats_body(Cs + (long long)b * P * R, Thi + b * PP, Tlo + b * PP,
                  Wt + (long long)b * R, wsum[b], OT + b * PP * P,
                  INS + b * PP, blockIdx.x, P, R, read_support, threadIdx.x, 0);
}

// K1, launch 2, grid (B). Reads OT/INS from launch 1, y: (B, P), n_cand:
// (B,). Writes K: (B, P, P), best_j/best_k: (B,). Dynamic shared memory:
// P*P floats + P ints.
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const float* __restrict__ OT, const float* __restrict__ INS,
                 const int* __restrict__ y, const int* __restrict__ n_cand,
                 int* __restrict__ K, int* __restrict__ best_j,
                 int* __restrict__ best_k, int P) {
  extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];
  float* H = reinterpret_cast<float*>(segdp_dyn_smem);
  int* ys = reinterpret_cast<int*>(H + P * P);
  const int b = blockIdx.x;
  const long long PP = (long long)P * P;
  wavefront_body(OT + b * PP * P, INS + b * PP, y + (long long)b * P, n_cand[b],
                 K + b * PP, best_j + b, best_k + b, P, H, ys, threadIdx.x,
                 kWarps, 0);
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
                       int* __restrict__ K, int* __restrict__ best_j,
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
                     K + b * PP, best_j + b, best_k + b, P, H, ys,
                     tid - kThreads, kConsumerWarps, kConsumerBar);
    }
    __syncthreads();  // slot t % 2 is complete; slot (t-1) % 2 is free
  }
}

}  // namespace segdp
