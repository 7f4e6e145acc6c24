// The lab modes' instantiations of the sm90 attention kernel (`lab_ok`: L1,
// the online softmax at a chosen tile, at D = 40; L3, two passes over the
// keys, at D = 40, 64 and 128; two or three consumers, 64- or 128-key
// tiles), in a translation unit of their own so that the build compiles
// them beside K1's and K9's. attention_sm90.cuh holds the kernel and its
// notes.

#include "attention_sm90.cuh"

namespace pd_sm90 {
namespace {

// the tiles of one head dimension and mode: 64- and 128-key tiles on two
// consumers, and on three at D <= 64
template <int D, int MODE>
int launch_tiles(int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const Params& p, int batch, cudaStream_t stream) {
  if (nc == 2 && bk == 64) return launch_lab_at<D, 2, 64, MODE>(tq, tk, tv, p, batch, stream);
  if (nc == 2 && bk == 128) return launch_lab_at<D, 2, 128, MODE>(tq, tk, tv, p, batch, stream);
  if constexpr (D <= 64) {
    if (nc == 3 && bk == 64) return launch_lab_at<D, 3, 64, MODE>(tq, tk, tv, p, batch, stream);
    if (nc == 3 && bk == 128) return launch_lab_at<D, 3, 128, MODE>(tq, tk, tv, p, batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int launch_lab(int d, int mode, int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const Params& p, int batch, cudaStream_t stream) {
  if (mode == kOnline && d == 40) {
    return launch_tiles<40, kOnline>(nc, bk, tq, tk, tv, p, batch, stream);
  }
  if (mode == kTwoPass) {
    switch (d) {
      case 40: return launch_tiles<40, kTwoPass>(nc, bk, tq, tk, tv, p, batch, stream);
      case 64: return launch_tiles<64, kTwoPass>(nc, bk, tq, tk, tv, p, batch, stream);
      case 128: return launch_tiles<128, kTwoPass>(nc, bk, tq, tk, tv, p, batch, stream);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pd_sm90
