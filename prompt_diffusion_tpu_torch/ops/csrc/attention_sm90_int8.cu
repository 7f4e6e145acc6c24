// The int8 instantiations of the sm90 attention kernel (K9 at D 32, 40, 64
// on three or two consumers, 80 and 128 on two), in a translation unit of their own
// so that the build compiles them beside the bf16 ones.
// attention_sm90.cuh holds the kernel and its notes.

#include "attention_sm90.cuh"

namespace pd_sm90 {

int launch_int8(int d, int nc, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const Params& p, int batch, cudaStream_t stream) {
  if (d == 32 && nc == 3) return launch<32, true, 3>(tq, tk, tv, p, batch, stream);
  if (d == 32 && nc == 2) return launch<32, true, 2>(tq, tk, tv, p, batch, stream);
  if (d == 40 && nc == 3) return launch<40, true, 3>(tq, tk, tv, p, batch, stream);
  if (d == 40 && nc == 2) return launch<40, true, 2>(tq, tk, tv, p, batch, stream);
  if (d == 64 && nc == 3) return launch<64, true, 3>(tq, tk, tv, p, batch, stream);
  if (d == 64 && nc == 2) return launch<64, true, 2>(tq, tk, tv, p, batch, stream);
  if (d == 80 && nc == 2) return launch<80, true, 2>(tq, tk, tv, p, batch, stream);
  if (d == 128 && nc == 2) return launch<128, true, 2>(tq, tk, tv, p, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pd_sm90
