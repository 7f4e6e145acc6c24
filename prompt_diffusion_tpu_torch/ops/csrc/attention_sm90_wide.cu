// The C interface of the wide sm90 attention kernel (attention_sm90_wide.cuh
// holds the kernel and its notes): the checks, the TMA tensor maps built on
// the host per call, the launch, and the plan as built, for
// ops/flash_attention.py's checks.

#include "attention_sm90_wide.cuh"

using namespace pd_sm90;

// Launches K2 at D = 512 on `stream`; returns the launch's cudaError_t (0 =
// queued), cudaErrorInvalidValue for a shape or stride it does not take or a
// tensor map cuTensorMapEncodeTiled refuses. bf16 (B, N, H, 512) views with element
// strides (batch, row, head), a dense head dimension, 16-byte aligned bases
// and strides (checked by the Python wrapper).
extern "C" int pd_attention_sm90_wide_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int nq, int nk,
    int d, int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (d != WIDE_D || nq <= 0 || nk <= 0 || batch <= 0 ||
      heads <= 0 || static_cast<int64_t>(batch) * heads > 65535 || !(scale > 0.f)) {
    return bad;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, false, q, d, nq, heads, batch, q_sn, q_sh, q_sb, WIDE_ROWS) ||
      !encode(fn, &tk, false, k, d, nk, heads, batch, k_sn, k_sh, k_sb, WIDE_BK) ||
      !encode(fn, &tv, false, v, d, nk, heads, batch, v_sn, v_sh, v_sb, WIDE_BK)) {
    return bad;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sn = o_sn;
  p.o_sh = o_sh;
  p.sk = nullptr;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale = scale;
  return launch_wide(tq, tk, tv, p, batch, static_cast<cudaStream_t>(stream));
}

// The plan as built: query rows of a CTA (0), keys of a tile (1), dynamic
// shared memory of a CTA (2), stages (3), registers a thread of the
// producer (4) and of a consumer (5), consumer warpgroups (6); -1 for any
// other item.
extern "C" int pd_attention_sm90_wide_plan(int item) {
  switch (item) {
    case 0: return WIDE_ROWS;
    case 1: return WIDE_BK;
    case 2: return WidePlan::SMEM;
    case 3: return NS;
    case 4: return producer_regs(WIDE_NC);
    case 5: return consumer_regs(WIDE_NC);
    case 6: return WIDE_NC;
    default: return -1;
  }
}
