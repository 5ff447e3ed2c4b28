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

// Dynamic shared memory of the wavefront (K1's launch 2 and K2): H and ys.
size_t dyn_smem(int P) {
  return (size_t)P * P * sizeof(float) + (size_t)P * sizeof(int);
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

}  // namespace

extern "C" {

// Dynamic shared memory the wavefront launch needs at width P.
size_t segdp_wavefront_smem(int P) { return dyn_smem(P); }

// Solves B padded problems with K1 (two launches). Returns 0 or the
// cudaError_t of the first launch the runtime refused (cudaGetLastError
// after each launch).
int segdp_solve(const int* Cs, const int* Thi, const int* Tlo, const int* W,
                const int* wsum, const int* y, const int* n_cand, float* OT,
                float* INS, int* K, int* best_j, int* best_k, int B, int P,
                int R, int read_support, void* stream) {
  if (B <= 0 || P <= 0 || R < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  dim3 grid1(P, B);
  segdp::pair_stats_kernel<<<grid1, segdp::kThreads, 0, s>>>(
      Cs, Thi, Tlo, W, wsum, OT, INS, P, R, read_support);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = dyn_smem(P);
  err = opt_in_smem(segdp::wavefront_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  segdp::wavefront_kernel<<<B, segdp::kThreads, smem, s>>>(
      OT, INS, y, n_cand, K, best_j, best_k, P);
  return (int)cudaGetLastError();
}

// Shared memory (static + dynamic) one block of K2 takes at width P, or 0
// when the runtime cannot say.
size_t segdp_pipelined_smem(int P) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, segdp::segdp_pipelined_kernel) != cudaSuccess) return 0;
  return attr.sharedSizeBytes + dyn_smem(P);
}

// How many K2 blocks of width P the current device holds at once (SMs x
// resident blocks per SM): K2's grid is this, or B when smaller. Writes
// it to *blocks; returns 0 or a cudaError_t.
int segdp_pipelined_blocks(int P, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = opt_in_smem(segdp::segdp_pipelined_kernel, dyn_smem(P));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segdp::segdp_pipelined_kernel, segdp::kPipeThreads, dyn_smem(P));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// Solves B padded problems with K2 in one launch of G blocks (1 <= G <=
// B). OT: (G, 2, P, P, P) and INS: (G, 2, P, P) scratch. Returns 0 or the
// cudaError_t of the refused launch.
int segdp_solve_pipelined(const int* Cs, const int* Thi, const int* Tlo,
                          const int* W, const int* wsum, const int* y,
                          const int* n_cand, float* OT, float* INS, int* K,
                          int* best_j, int* best_k, int B, int P, int R,
                          int read_support, int G, void* stream) {
  if (B <= 0 || P <= 0 || R < 0 || G <= 0 || G > B) return (int)cudaErrorInvalidValue;
  const size_t smem = dyn_smem(P);
  cudaError_t err = opt_in_smem(segdp::segdp_pipelined_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  segdp::segdp_pipelined_kernel<<<G, segdp::kPipeThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      Cs, Thi, Tlo, W, wsum, y, n_cand, OT, INS, K, best_j, best_k, B, P, R,
      read_support);
  return (int)cudaGetLastError();
}

const char* segdp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
