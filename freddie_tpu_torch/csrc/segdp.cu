// Host entry of the segmentation DP kernels (segdp_kernels.cuh), with a
// plain C interface so the library builds in seconds with nvcc alone and
// binds through ctypes (freddie_tpu_torch/ops/segdp_cuda.py). The caller
// allocates every buffer; both launches go on the caller's stream and
// nothing here synchronises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsegdp.so segdp.cu

#include <cuda_runtime.h>
#include <math.h>

#include "segdp_kernels.cuh"

extern "C" {

// Dynamic shared memory the wavefront launch needs at width P.
size_t segdp_wavefront_smem(int P) {
  return (size_t)P * P * sizeof(float) + (size_t)P * sizeof(int);
}

// Solves B padded problems. Returns 0 or the cudaError_t of the first
// launch the runtime refused (cudaGetLastError after each launch).
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

  const size_t smem = segdp_wavefront_smem(P);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(segdp::wavefront_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  segdp::wavefront_kernel<<<B, segdp::kThreads, smem, s>>>(
      OT, INS, y, n_cand, K, best_j, best_k, P);
  return (int)cudaGetLastError();
}

const char* segdp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
