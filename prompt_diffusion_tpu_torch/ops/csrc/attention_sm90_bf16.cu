// The bf16 instantiations of the sm90 attention kernel (K1 and K2 at D 40,
// 64, 80, 128), in a translation unit of their own so that the build
// compiles them beside the int8 ones. attention_sm90.cuh holds the kernel
// and its notes.

#include "attention_sm90.cuh"

namespace pd_sm90 {

int launch_bf16(int d, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 40: return launch<40, false, consumers(40)>(tq, tk, tv, p, batch, stream);
    case 64: return launch<64, false, consumers(64)>(tq, tk, tv, p, batch, stream);
    case 80: return launch<80, false, consumers(80)>(tq, tk, tv, p, batch, stream);
    case 128: return launch<128, false, consumers(128)>(tq, tk, tv, p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pd_sm90
