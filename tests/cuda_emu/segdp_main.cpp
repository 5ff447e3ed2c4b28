// Runs the segmentation-DP kernels under the CPU shim (emu.h) on a batch
// read from raw int32 files in the working directory, and writes K,
// best_j and best_k back (tests/test_torch_segdp_emulated.py): K1's two
// launches, or with a grid size G, K2's one launch of G blocks.
//
//   segdp_emu B P R read_support [G]
//   in:  Cs.bin Thi.bin Tlo.bin W.bin wsum.bin y.bin n.bin
//   out: K.bin bj.bin bk.bin
#include <cstdio>
#include <cstdlib>
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
  if (argc != 5 && argc != 6) return 2;
  const int B = std::atoi(argv[1]), P = std::atoi(argv[2]);
  const int R = std::atoi(argv[3]), rs = std::atoi(argv[4]);
  const int G = argc == 6 ? std::atoi(argv[5]) : 0;  // 0: K1
  if (G < 0 || G > B) return 2;
  const size_t BP = (size_t)B * P, BPP = BP * P;
  auto Cs = load<int>("Cs.bin", BP * R);
  auto Thi = load<int>("Thi.bin", BPP);
  auto Tlo = load<int>("Tlo.bin", BPP);
  auto W = load<int>("W.bin", (size_t)B * R);
  auto wsum = load<int>("wsum.bin", B);
  auto y = load<int>("y.bin", BP);
  auto n = load<int>("n.bin", B);
  // Garbage in every output and scratch, as torch.empty leaves them.
  std::vector<int> K(BPP, 777), bj(B, 777), bk(B, 777);
  if (G == 0) {
    std::vector<float> OT(BPP * P, 12345.f), INS(BPP, 12345.f);
    emu_launch(dim3(P, B), segdp::kThreads, [&] {
      segdp::pair_stats_kernel(Cs.data(), Thi.data(), Tlo.data(), W.data(),
                               wsum.data(), OT.data(), INS.data(), P, R, rs);
    });
    emu_launch(dim3(B), segdp::kThreads, [&] {
      segdp::wavefront_kernel(OT.data(), INS.data(), y.data(), n.data(),
                              K.data(), bj.data(), bk.data(), P);
    });
  } else {
    const size_t slots = 2 * (size_t)G * P * P;
    std::vector<float> OT(slots * P, 12345.f), INS(slots, 12345.f);
    emu_launch(dim3(G), segdp::kPipeThreads, [&] {
      segdp::segdp_pipelined_kernel(Cs.data(), Thi.data(), Tlo.data(), W.data(),
                                    wsum.data(), y.data(), n.data(), OT.data(),
                                    INS.data(), K.data(), bj.data(), bk.data(),
                                    B, P, R, rs);
    });
  }
  store("K.bin", K);
  store("bj.bin", bj);
  store("bk.bin", bk);
  return 0;
}
