// Host entries of the segmentation DP kernels (segdp_kernels.cuh), with a
// plain C interface so the library builds in seconds with nvcc alone and
// binds through ctypes (freddie_tpu_torch/ops/segdp_cuda.py). The caller
// allocates every buffer; every launch goes on the caller's stream and
// nothing here synchronises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsegdp.so segdp.cu

#include <cuda_runtime.h>
#include <math.h>

#include "segdp_kernels.cuh"

namespace {

// Dynamic shared memory of wavefront_body (K1's one-block wavefront, and
// part of K2): H and ys when H lives in shared memory, ys alone when it
// lives in device memory.
size_t dyn_smem(int P, bool smem_h) {
  return (smem_h ? (size_t)P * P * sizeof(float) : 0) + (size_t)P * sizeof(int);
}

// Lets `kernel` take `bytes` of dynamic shared memory when its static and
// dynamic shared memory together pass the 48 KB default.
template <class Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1's launch 1 with kSlots operand slots per block: one set shared by the
// tile's rows and columns (P <= kTile), or a set each.
template <int kSlots>
cudaError_t launch_pair_stats(const int* Cs, const int* Thi, const int* Tlo, const int* W,
                              const int* wsum, const int* wmax, const int* n_cand,
                              float* OT, float* INS, int B, int P, int R, int read_support,
                              cudaStream_t s) {
  const size_t smem = sizeof(segdp::PairSmem<kSlots>);
  cudaError_t err = opt_in_smem(segdp::pair_stats_kernel<kSlots>, smem);
  if (err != cudaSuccess) return err;
  segdp::pair_stats_kernel<kSlots><<<dim3(P, B), segdp::kMmaThreads, smem, s>>>(
      Cs, Thi, Tlo, W, wsum, wmax, n_cand, OT, INS, P, R, read_support);
  return cudaGetLastError();
}

// The launch of `kernel` on B clusters of N blocks of `threads` threads
// with `smem` bytes of dynamic shared memory each, into *cfg (its
// attribute array *attr); a cluster of more than 8 blocks allowed.
cudaError_t grid_of_clusters(const void* kernel, int B, int N, size_t smem, cudaStream_t s,
                             cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                             int threads = segdp::kThreads) {
  if (N > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(N * B);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = N;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The instantiation of a cluster kernel for H's home and the ring's kind.
template <class Kernel>
Kernel pick(bool smem_h, bool row_ring, Kernel plane_smem, Kernel plane_dev, Kernel rows_smem,
            Kernel rows_dev) {
  if (row_ring) return smem_h ? rows_smem : rows_dev;
  return smem_h ? plane_smem : plane_dev;
}

// K1's cluster wavefront at width P, H in shared memory when smem_h, on
// clusters of N blocks with each warp's ring of rows when row_ring, else
// the ring of whole planes: the kernel, with its shared memory opted in
// (and a cluster of more than 8 blocks allowed), and the launch's
// configuration in *cfg, whose attribute array is *attr.
using ClusterKernel = decltype(&segdp::wavefront_cluster_kernel<true, true>);
cudaError_t cluster_config(int B, int P, int N, bool smem_h, bool row_ring, cudaStream_t s,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           ClusterKernel* kernel) {
  if (N < 1 || N > segdp::kMaxCluster) return cudaErrorInvalidValue;
  *kernel = pick<ClusterKernel>(smem_h, row_ring, &segdp::wavefront_cluster_kernel<true, false>,
                                &segdp::wavefront_cluster_kernel<false, false>,
                                &segdp::wavefront_cluster_kernel<true, true>,
                                &segdp::wavefront_cluster_kernel<false, true>);
  const size_t smem = segdp::cluster_smem_bytes(P, N, smem_h, segdp::kWarps, row_ring);
  cudaError_t err = opt_in_smem(*kernel, smem);
  if (err != cudaSuccess) return err;
  return grid_of_clusters(reinterpret_cast<const void*>(*kernel), B, N, smem, s, cfg, attr);
}

// K2 at width P, one instantiation per PairSmem size as for K1's launch
// 1 and per home of H (shared memory when smem_h), and in *dyn the
// dynamic shared memory it takes: the pair statistics' slots, the
// wavefront's H (when smem_h) and ys, and the four ints of hand-off state.
using PipeKernel = decltype(&segdp::segdp_pipelined_kernel<segdp::kTile, true>);
PipeKernel pipe_kernel(int P, bool smem_h, size_t* dyn) {
  const bool one_set = P <= segdp::kTile;
  *dyn = (one_set ? sizeof(segdp::PairSmem<segdp::kTile>)
                  : sizeof(segdp::PairSmem<2 * segdp::kTile>)) +
         dyn_smem(P, smem_h) + 4 * sizeof(int);
  if (one_set)
    return smem_h ? &segdp::segdp_pipelined_kernel<segdp::kTile, true>
                  : &segdp::segdp_pipelined_kernel<segdp::kTile, false>;
  return smem_h ? &segdp::segdp_pipelined_kernel<2 * segdp::kTile, true>
                : &segdp::segdp_pipelined_kernel<2 * segdp::kTile, false>;
}

// K2's cluster route at width P, H in shared memory when smem_h, on G
// clusters of N blocks, the consumers' ring of rows when row_ring: as
// cluster_config for K1's cluster wavefront.
using PipeClusterKernel = decltype(&segdp::segdp_pipelined_cluster_kernel<true, true>);
cudaError_t pipe_cluster_config(int G, int P, int N, bool smem_h, bool row_ring,
                                cudaStream_t s, cudaLaunchConfig_t* cfg,
                                cudaLaunchAttribute* attr, PipeClusterKernel* kernel) {
  if (N < 1 || N > segdp::kMaxCluster) return cudaErrorInvalidValue;
  *kernel = pick<PipeClusterKernel>(smem_h, row_ring,
                                    &segdp::segdp_pipelined_cluster_kernel<true, false>,
                                    &segdp::segdp_pipelined_cluster_kernel<false, false>,
                                    &segdp::segdp_pipelined_cluster_kernel<true, true>,
                                    &segdp::segdp_pipelined_cluster_kernel<false, true>);
  const size_t smem = segdp::pipelined_cluster_smem_bytes(P, N, smem_h, row_ring);
  cudaError_t err = opt_in_smem(*kernel, smem);
  if (err != cudaSuccess) return err;
  return grid_of_clusters(reinterpret_cast<const void*>(*kernel), G, N, smem, s, cfg, attr,
                          segdp::kPipeThreads);
}

// What the runtime reports for a cluster kernel configured in cfg (err:
// what its configuration returned): out[0] the clusters resident at once
// (cudaOccupancyMaxActiveClusters), out[1] the shared memory per block
// (static + dynamic), out[2] the registers per thread. Returns 0 or a
// cudaError_t.
int occupancy_of(cudaError_t err, const void* kernel, const cudaLaunchConfig_t& cfg, int* out) {
  int clusters = 0;
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = clusters;
  out[1] = (int)(fa.sharedSizeBytes + cfg.dynamicSmemBytes);
  out[2] = fa.numRegs;
  return 0;
}

}  // namespace

extern "C" {

// Solves B padded problems with K1 (two launches); R must be a multiple
// of kMmaStage (reps padded with zero weights); wmax: (B,) each problem's
// largest weight, chains: (B, P+2) the walked breakpoint chains. The
// wavefront is wavefront_kernel (one block a problem, H in its shared
// memory) when cluster_n is 0, and otherwise wavefront_cluster_kernel on
// clusters of cluster_n blocks with each warp's ring of rows when
// row_ring (else the ring of whole planes), with H
// in their shared memory when P <= smem_max_p and in H: (B, P, P) f32
// scratch in device memory above (H may be null when P <= smem_max_p).
// Returns 0 or the cudaError_t of the first launch the runtime refused
// (cudaGetLastError after each launch), a cluster that cannot be
// scheduled included.
int segdp_solve(const int* Cs, const int* Thi, const int* Tlo, const int* W,
                const int* wsum, const int* wmax, const int* y, const int* n_cand,
                float* OT, float* INS, float* H, int* K, int* best_j, int* best_k,
                int* chains, int B, int P, int R, int read_support, int smem_max_p,
                int cluster_n, int row_ring, void* stream) {
  const bool smem_h = P <= smem_max_p;
  if (B <= 0 || P <= 0 || R < 0 || R % segdp::kMmaStage != 0 || B > 65535 ||
      cluster_n < 0 || (!smem_h && (H == nullptr || cluster_n == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = P <= segdp::kTile
                        ? launch_pair_stats<segdp::kTile>(Cs, Thi, Tlo, W, wsum, wmax, n_cand,
                                                          OT, INS, B, P, R, read_support, s)
                        : launch_pair_stats<2 * segdp::kTile>(Cs, Thi, Tlo, W, wsum, wmax,
                                                              n_cand, OT, INS, B, P, R,
                                                              read_support, s);
  if (err != cudaSuccess) return (int)err;

  if (cluster_n == 0) {
    const size_t smem = dyn_smem(P, true);
    err = opt_in_smem(segdp::wavefront_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    segdp::wavefront_kernel<<<B, segdp::kThreads, smem, s>>>(
        OT, INS, y, n_cand, K, best_j, best_k, chains, P);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterKernel kernel = nullptr;
  err = cluster_config(B, P, cluster_n, smem_h, row_ring != 0, s, &cfg, &attr, &kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, OT, INS, y, n_cand, H, K, best_j, best_k, chains, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the runtime reports for K1's cluster wavefront at width P on
// clusters of N blocks (H in shared memory when smem_h, the ring of rows
// when row_ring) on the current device, as occupancy_of says.
int segdp_cluster_occupancy(int P, int N, int smem_h, int row_ring, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterKernel kernel = nullptr;
  const cudaError_t err =
      cluster_config(1, P, N, smem_h != 0, row_ring != 0, nullptr, &cfg, &attr, &kernel);
  return occupancy_of(err, reinterpret_cast<const void*>(kernel), cfg, out);
}

// `steps` rounds of the cluster barrier alone on B clusters of N blocks:
// the cluster wavefront's latency floor at P = steps + 1. Returns 0 or
// the cudaError_t of the refused launch.
int segdp_cluster_barrier_probe(int B, int N, int steps, void* stream) {
  if (B <= 0 || N < 1 || N > segdp::kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      grid_of_clusters(reinterpret_cast<const void*>(&segdp::cluster_barrier_kernel), B, N, 0,
                       static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, segdp::cluster_barrier_kernel, steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the runtime reports for K2 at width P on the current device, H in
// shared memory when P <= smem_max_p: out[0] the SMs, out[1] the blocks
// of K2 an SM holds at once, out[2] the registers per thread, out[3] the
// shared memory per block (static + dynamic). Returns 0 or a cudaError_t.
int segdp_pipelined_occupancy(int P, int smem_max_p, int* out) {
  size_t dyn = 0;
  PipeKernel kernel = pipe_kernel(P, P <= smem_max_p, &dyn);
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = opt_in_smem(kernel, dyn);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        segdp::kPipeThreads, dyn);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = sms;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = (int)(attr.sharedSizeBytes + dyn);
  return 0;
}

// Solves B padded problems with K2 in one launch of G blocks (1 <= G <=
// B); R a multiple of kMmaStage, wmax and chains as for segdp_solve. OT:
// (G, 2, P, P, P) and INS: (G, 2, P, P) scratch; H: (G, P, P) scratch,
// used when P > smem_max_p (may be null otherwise). queue: one int at
// zero, from which the blocks draw their problems. Returns 0 or the
// cudaError_t of the refused launch.
int segdp_solve_pipelined(const int* Cs, const int* Thi, const int* Tlo,
                          const int* W, const int* wsum, const int* wmax,
                          const int* y, const int* n_cand, float* OT, float* INS, float* H,
                          int* K, int* best_j, int* best_k, int* chains, int* queue,
                          int B, int P, int R, int read_support, int G, int smem_max_p,
                          void* stream) {
  const bool smem_h = P <= smem_max_p;
  if (B <= 0 || P <= 0 || R < 0 || R % segdp::kMmaStage != 0 || G <= 0 || G > B ||
      (!smem_h && H == nullptr))
    return (int)cudaErrorInvalidValue;
  size_t dyn = 0;
  PipeKernel kernel = pipe_kernel(P, smem_h, &dyn);
  cudaError_t err = opt_in_smem(kernel, dyn);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, segdp::kPipeThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      Cs, Thi, Tlo, W, wsum, wmax, y, n_cand, OT, INS, H, K, best_j, best_k, chains, queue,
      B, P, R, read_support);
  return (int)cudaGetLastError();
}

// The same for K2's cluster route.
int segdp_pipelined_cluster_occupancy(int P, int N, int smem_h, int row_ring, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  PipeClusterKernel kernel = nullptr;
  const cudaError_t err =
      pipe_cluster_config(1, P, N, smem_h != 0, row_ring != 0, nullptr, &cfg, &attr, &kernel);
  return occupancy_of(err, reinterpret_cast<const void*>(kernel), cfg, out);
}

// Solves B padded problems with K2's cluster route in one launch of G
// clusters of cluster_n blocks (1 <= G <= B), the ring (row_ring) as for
// segdp_solve; R, wmax and chains as for segdp_solve. OT: (G, 2, P, P,
// P) and INS: (G, 2, P, P) scratch; H: (G, P, P) scratch, used when P >
// smem_max_p (may be null otherwise).
// Returns 0 or the cudaError_t of the refused launch.
int segdp_solve_pipelined_cluster(const int* Cs, const int* Thi, const int* Tlo, const int* W,
                                  const int* wsum, const int* wmax, const int* y,
                                  const int* n_cand, float* OT, float* INS, float* H, int* K,
                                  int* best_j, int* best_k, int* chains, int B, int P, int R,
                                  int read_support, int G, int cluster_n, int smem_max_p,
                                  int row_ring, void* stream) {
  const bool smem_h = P <= smem_max_p;
  if (B <= 0 || P <= 0 || R < 0 || R % segdp::kMmaStage != 0 || G <= 0 || G > B ||
      (!smem_h && H == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  PipeClusterKernel kernel = nullptr;
  cudaError_t err = pipe_cluster_config(G, P, cluster_n, smem_h, row_ring != 0,
                                        static_cast<cudaStream_t>(stream), &cfg, &attr, &kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, Cs, Thi, Tlo, W, wsum, wmax, y, n_cand, OT, INS, H, K,
                           best_j, best_k, chains, B, P, R, read_support);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* segdp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
