// Runs the segmentation-DP kernels under the CPU shim (emu.h) on a batch
// read from raw int32 files in the working directory, and writes K,
// best_j and best_k back (tests/test_torch_segdp_emulated.py): K1's two
// launches, its wavefront on one block a problem, or with "cN" on
// clusters of N blocks whose ring holds two whole outside planes a block,
// with "cNr" each warp's ring of rows (wavefront_cluster_kernel, the
// clusters in turn, each cluster's blocks at once); or with a grid size
// G, K2's one launch of G blocks, of which `at_once` run concurrently
// (default 1: in turn); or with "kN G" or "kNr G", K2's cluster route
// (segdp_pipelined_cluster_kernel) on G clusters of N blocks with the
// same rings, `at_once` clusters concurrently, each cluster's blocks
// together.
// As in segdp.cu, the wavefront keeps H in shared memory when P <= cap and
// in device memory (a scratch vector here: K1's (B, P, P), K2's (G, P,
// P)) above; a cap of 0 forces the device-memory route (K1: the cluster
// kernel's).
//
//   segdp_emu B P R read_support cap [cN[r] | G [at_once] | kN[r] G [at_once]]
//   segdp_emu smem P N smem_h row_ring   (prints the cluster kernels' shared memory)
//   in:  Cs.bin Thi.bin Tlo.bin W.bin wsum.bin wmax.bin y.bin n.bin
//   out: K.bin bj.bin bk.bin chains.bin; K1's OT.bin and INS.bin (its
//        scratch, of which only the live entries are defined); K2's
//        queue.bin (the work counter as the launch left it: every block
//        draws until it is handed a problem >= B, so B draws in all; not
//        written by the cluster route, which has no queue)
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "emu.h"
#include "segdp_kernels_emu.cuh"

template <class T>
static std::vector<T> load(const char* name, size_t count) {
  std::vector<T> v(count);
  FILE* f = std::fopen(name, "rb");
  if (!f || std::fread(v.data(), sizeof(T), count, f) != count) {
    std::fprintf(stderr, "cannot read %zu values from %s\n", count, name);
    std::exit(1);
  }
  std::fclose(f);
  return v;
}

template <class T>
static void store(const char* name, const std::vector<T>& v) {
  FILE* f = std::fopen(name, "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

int main(int argc, char** argv) {
  if (argc == 6 && std::strcmp(argv[1], "smem") == 0) {
    // segdp_emu smem P N smem_h row_ring: the dynamic shared memory of a
    // block of K1's cluster wavefront and of K2's cluster route, as the
    // launches ask for it (the wrapper counts the same bytes in Python).
    const int P = std::atoi(argv[2]), N = std::atoi(argv[3]);
    const bool h = std::atoi(argv[4]) != 0, rows = std::atoi(argv[5]) != 0;
    std::printf("%d %d\n", segdp::cluster_smem_bytes(P, N, h, segdp::kWarps, rows),
                segdp::pipelined_cluster_smem_bytes(P, N, h, rows));
    return 0;
  }
  if (argc < 6 || argc > 9) return 2;
  const int B = std::atoi(argv[1]), P = std::atoi(argv[2]);
  const int R = std::atoi(argv[3]), rs = std::atoi(argv[4]);
  const bool smem_h = P <= std::atoi(argv[5]);
  const bool cluster = argc >= 7 && argv[6][0] == 'c';  // K1 on clusters of N blocks
  const bool k2_cluster = argc >= 7 && argv[6][0] == 'k';  // K2 on G clusters of N blocks
  const int N = cluster || k2_cluster ? std::atoi(argv[6] + 1) : 0;
  const bool row_ring = (cluster || k2_cluster) && std::strchr(argv[6], 'r') != nullptr;
  const int grid_arg = k2_cluster ? 7 : 6;  // where G is
  const int G = argc > grid_arg && !cluster ? std::atoi(argv[grid_arg]) : 0;  // 0: K1
  const int at_once = argc == grid_arg + 2 ? std::atoi(argv[grid_arg + 1]) : 1;
  if (argc > grid_arg + 2 || G < 0 || G > B || at_once < 1 || at_once > (G ? G : 1)) return 2;
  if (cluster && (N < 1 || N > segdp::kMaxCluster || argc != 7)) return 2;
  if (k2_cluster && (N < 1 || N > segdp::kMaxCluster || G < 1)) return 2;
  if (!cluster && !smem_h && G == 0) return 2;  // K1's one-block wavefront keeps H in shared memory
  if (R % segdp::kMmaStage != 0) return 2;  // the wrapper pads the reps
  const size_t BP = (size_t)B * P, BPP = BP * P;
  auto Cs = load<int>("Cs.bin", BP * R);
  auto Thi = load<int>("Thi.bin", BPP);
  auto Tlo = load<int>("Tlo.bin", BPP);
  auto W = load<int>("W.bin", (size_t)B * R);
  auto wsum = load<int>("wsum.bin", B);
  auto wmax = load<int>("wmax.bin", B);
  auto y = load<int>("y.bin", BP);
  auto n = load<int>("n.bin", B);
  // Garbage in every output and scratch, as torch.empty leaves them.
  std::vector<int> K(BPP, 777), bj(B, 777), bk(B, 777), chains((size_t)B * (P + 2), 777);
  if (G == 0) {
    std::vector<float> OT(BPP * P, 12345.f), INS(BPP, 12345.f);
    emu_launch(dim3(P, B), segdp::kMmaThreads, [&] {
      if (P <= segdp::kTile)
        segdp::pair_stats_kernel<segdp::kTile>(Cs.data(), Thi.data(), Tlo.data(), W.data(),
                                               wsum.data(), wmax.data(), n.data(),
                                               OT.data(), INS.data(), P, R, rs);
      else
        segdp::pair_stats_kernel<2 * segdp::kTile>(Cs.data(), Thi.data(), Tlo.data(),
                                                   W.data(), wsum.data(), wmax.data(),
                                                   n.data(), OT.data(), INS.data(), P, R, rs);
    });
    std::vector<float> H(smem_h ? 0 : BPP, 12345.f);
    if (!cluster) {
      emu_launch(dim3(B), segdp::kThreads, [&] {
        segdp::wavefront_kernel(OT.data(), INS.data(), y.data(), n.data(), K.data(), bj.data(),
                                bk.data(), chains.data(), P);
      });
    } else {
      if (segdp::cluster_smem_bytes(P, N, smem_h, segdp::kWarps, row_ring) >
          (int)sizeof(EmuBlock::dyn_smem))
        return 2;
      // The instantiation segdp.cu's cluster_config picks.
      auto run = [&](auto kernel) {
        kernel(OT.data(), INS.data(), y.data(), n.data(), H.data(), K.data(), bj.data(),
               bk.data(), chains.data(), P);
      };
      emu_launch(dim3(N * B), segdp::kThreads, [&] {
        if (row_ring)
          smem_h ? run(segdp::wavefront_cluster_kernel<true, true>)
                 : run(segdp::wavefront_cluster_kernel<false, true>);
        else
          smem_h ? run(segdp::wavefront_cluster_kernel<true, false>)
                 : run(segdp::wavefront_cluster_kernel<false, false>);
      }, 1, N);
    }
    store("OT.bin", OT);
    store("INS.bin", INS);
  } else if (k2_cluster) {
    if (segdp::pipelined_cluster_smem_bytes(P, N, smem_h, row_ring) >
        (int)sizeof(EmuBlock::dyn_smem))
      return 2;
    const size_t slots = 2 * (size_t)G * P * P;
    std::vector<float> OT(slots * P, 12345.f), INS(slots, 12345.f);
    std::vector<float> H(smem_h ? 0 : (size_t)G * P * P, 12345.f);
    auto run = [&](auto kernel) {
      kernel(Cs.data(), Thi.data(), Tlo.data(), W.data(), wsum.data(), wmax.data(), y.data(),
             n.data(), OT.data(), INS.data(), H.data(), K.data(), bj.data(), bk.data(),
             chains.data(), B, P, R, rs);
    };
    emu_launch(dim3(N * G), segdp::kPipeThreads, [&] {
      if (row_ring)
        smem_h ? run(segdp::segdp_pipelined_cluster_kernel<true, true>)
               : run(segdp::segdp_pipelined_cluster_kernel<false, true>);
      else
        smem_h ? run(segdp::segdp_pipelined_cluster_kernel<true, false>)
               : run(segdp::segdp_pipelined_cluster_kernel<false, false>);
    }, at_once, N);
  } else {
    const size_t slots = 2 * (size_t)G * P * P;
    std::vector<float> OT(slots * P, 12345.f), INS(slots, 12345.f);
    std::vector<float> H(smem_h ? 0 : (size_t)G * P * P, 12345.f);
    int queue = 0;  // the blocks' work counter
    // The instantiation segdp.cu's pipe_kernel picks.
    auto run = [&](auto kernel) {
      kernel(Cs.data(), Thi.data(), Tlo.data(), W.data(), wsum.data(), wmax.data(), y.data(),
             n.data(), OT.data(), INS.data(), H.data(), K.data(), bj.data(), bk.data(),
             chains.data(), &queue, B, P, R, rs);
    };
    emu_launch(dim3(G), segdp::kPipeThreads, [&] {
      if (P <= segdp::kTile)
        smem_h ? run(segdp::segdp_pipelined_kernel<segdp::kTile, true>)
               : run(segdp::segdp_pipelined_kernel<segdp::kTile, false>);
      else
        smem_h ? run(segdp::segdp_pipelined_kernel<2 * segdp::kTile, true>)
               : run(segdp::segdp_pipelined_kernel<2 * segdp::kTile, false>);
    }, at_once);
    store("queue.bin", std::vector<int>{queue});
  }
  store("chains.bin", chains);
  store("K.bin", K);
  store("bj.bin", bj);
  store("bk.bin", bk);
  return 0;
}
