// The lab modes' instantiations of the sm90 attention kernel (`lab_ok`),
// but for L3's (attention_sm90_lab_two_pass.cu), in a translation unit of
// their own so that the build compiles them beside K1's, K9's and L3's: L1,
// the online softmax at a chosen tile, and L2, the no-softmax sum, at
// D = 40 on two or three consumers and 64- or 128-key tiles; L4, K9 with
// one K scale per key row, at D = 64 on K9's two plans. Also the lab's
// dispatch by mode. attention_sm90.cuh holds the kernel and its notes.

#include "attention_sm90.cuh"

namespace pd_sm90 {
namespace {

// the tiles of one bf16 mode at D = 40: 64- and 128-key tiles on two and
// three consumers
template <int MODE>
int launch_tiles_40(int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, const Params& p, int batch, cudaStream_t s) {
  if (nc == 2 && bk == 64) return launch_lab_at<40, 2, 64, MODE>(tq, tk, tv, nullptr, p, batch, s);
  if (nc == 2 && bk == 128) return launch_lab_at<40, 2, 128, MODE>(tq, tk, tv, nullptr, p, batch, s);
  if (nc == 3 && bk == 64) return launch_lab_at<40, 3, 64, MODE>(tq, tk, tv, nullptr, p, batch, s);
  if (nc == 3 && bk == 128) return launch_lab_at<40, 3, 128, MODE>(tq, tk, tv, nullptr, p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int launch_lab(int d, int mode, int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const CUtensorMap* tsk, const Params& p, int batch,
               cudaStream_t stream) {
  if (!lab_ok(d, mode, nc, bk)) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kOnline: return launch_tiles_40<kOnline>(nc, bk, tq, tk, tv, p, batch, stream);
    case kNoSoftmax: return launch_tiles_40<kNoSoftmax>(nc, bk, tq, tk, tv, p, batch, stream);
    case kTwoPass: return launch_two_pass(d, nc, bk, tq, tk, tv, p, batch, stream);
    case kRowK:
      if (tsk == nullptr) break;
      if (nc == 3) return launch_lab_at<64, 3, 112, kRowK>(tq, tk, tv, tsk, p, batch, stream);
      return launch_lab_at<64, 2, 128, kRowK>(tq, tk, tv, tsk, p, batch, stream);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pd_sm90
