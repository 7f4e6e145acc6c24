// The two-pass lab mode's instantiations of the sm90 attention kernel (L3,
// `lab_ok`: two passes over the keys at D = 40, 64 and 128; two or three
// consumers, three at D <= 64; 64- or 128-key tiles), in a translation
// unit of their own so that the build compiles them beside the other lab
// modes' (attention_sm90_lab.cu, which dispatches to them).
// attention_sm90.cuh holds the kernel and its notes.

#include "attention_sm90.cuh"

namespace pd_sm90 {
namespace {

template <int D>
int launch_tiles(int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const Params& p, int batch, cudaStream_t s) {
  constexpr int M = kTwoPass;
  if (nc == 2 && bk == 64) return launch_lab_at<D, 2, 64, M>(tq, tk, tv, nullptr, p, batch, s);
  if (nc == 2 && bk == 128) return launch_lab_at<D, 2, 128, M>(tq, tk, tv, nullptr, p, batch, s);
  if constexpr (D <= 64) {
    if (nc == 3 && bk == 64) return launch_lab_at<D, 3, 64, M>(tq, tk, tv, nullptr, p, batch, s);
    if (nc == 3 && bk == 128) return launch_lab_at<D, 3, 128, M>(tq, tk, tv, nullptr, p, batch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int launch_two_pass(int d, int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 40: return launch_tiles<40>(nc, bk, tq, tk, tv, p, batch, stream);
    case 64: return launch_tiles<64>(nc, bk, tq, tk, tv, p, batch, stream);
    case 128: return launch_tiles<128>(nc, bk, tq, tk, tv, p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pd_sm90
