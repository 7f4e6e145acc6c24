// The C interface of the sm90 attention kernel (attention_sm90.cuh holds the
// kernel and its notes): the checks, the TMA tensor maps built on the host
// per call, and the launch of the instantiation (attention_sm90_bf16.cu,
// attention_sm90_int8.cu, attention_sm90_lab.cu, _lab_two_pass.cu); the
// plan as built, for ops/flash_attention.py's checks.

#include "attention_sm90.cuh"

using namespace pd_sm90;

// Launches the attention forward on `stream`; returns the launch's
// cudaError_t (0 = queued), cudaErrorInvalidValue for a shape, stride or
// consumer count it does not take or a tensor map cuTensorMapEncodeTiled
// refuses.
// (B, N, H, D) views with element strides (batch, row, head) and a dense
// head dimension, 16-byte aligned bases and strides (checked by the Python
// wrapper). bf16: D in {40, 64, 80, 128}; int8 (K9): `k` holds K9p's codes
// (element strides of the codes), `sk` its (B, H) scales, D in {32, 40,
// 64, 80, 128} (K's strides multiples of 16 bytes: at D = 40 K9p writes
// heads 48 bytes apart). `consumers`: warpgroups of 64 query rows, the
// plan's (`sm90_consumers`).
extern "C" int pd_attention_sm90_fwd(
    const void* q, const void* k, const void* sk, const void* v, void* o, int int8,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, int consumers, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool d_ok = int8 ? (d == 32 || d == 40 || d == 64 || d == 80 || d == 128)
                         : (d == 40 || d == 64 || d == 80 || d == 128);
  if (!d_ok || !consumers_ok(d, int8 != 0, consumers) || nq <= 0 || nk <= 0 || batch <= 0 ||
      heads <= 0 || static_cast<int64_t>(batch) * heads > 65535 || !(scale > 0.f) ||
      (int8 && sk == nullptr)) {
    return bad;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bk = block_k(int8 != 0, consumers);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, false, q, d, nq, heads, batch, q_sn, q_sh, q_sb, 64 * consumers) ||
      !encode(fn, &tk, int8 != 0, k, d, nk, heads, batch, k_sn, k_sh, k_sb, bk) ||
      !encode(fn, &tv, false, v, d, nk, heads, batch, v_sn, v_sh, v_sb, bk)) {
    return bad;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sn = o_sn;
  p.o_sh = o_sh;
  p.sk = static_cast<const float*>(sk);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? launch_int8(d, consumers, tq, tk, tv, p, batch, s)
              : launch_bf16(d, tq, tk, tv, p, batch, s);
}

// Launches a lab mode on `stream`: `mode` 0 (kOnline, L1), 1 (kNoSoftmax,
// L2) or 2 (kTwoPass, L3) over bf16 (B, N, H, D) views as
// pd_attention_sm90_fwd takes them, or 3 (kRowK, L4) with `k` the per-row
// prologue's int8 codes (element strides of the codes) and `sk` its fp32
// scales, (B, H) rows of nk scales `sk_pitch` floats apart (a multiple of
// 4); on `consumers` warpgroups of 64 query rows and `block_k`-key tiles.
// Returns the launch's cudaError_t (0 = queued), cudaErrorInvalidValue for
// a shape, stride, mode or tile not instantiated (`lab_ok`) or a tensor
// map cuTensorMapEncodeTiled refuses.
extern "C" int pd_attention_sm90_lab_fwd(
    const void* q, const void* k, const void* sk, int64_t sk_pitch, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d, int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sn, int64_t k_sh, int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh, float scale, int mode, int consumers, int block_k,
    void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool row_k = mode == kRowK;
  if (!lab_ok(d, mode, consumers, block_k) || nq <= 0 || nk <= 0 || batch <= 0 || heads <= 0 ||
      static_cast<int64_t>(batch) * heads > 65535 || !(scale > 0.f) ||
      (row_k && (sk == nullptr || sk_pitch < nk || sk_pitch % 4 != 0))) {
    return bad;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tsk;
  if (!encode(fn, &tq, false, q, d, nq, heads, batch, q_sn, q_sh, q_sb, 64 * consumers) ||
      !encode(fn, &tk, row_k, k, d, nk, heads, batch, k_sn, k_sh, k_sb, block_k) ||
      !encode(fn, &tv, false, v, d, nk, heads, batch, v_sn, v_sh, v_sb, block_k) ||
      (row_k && !encode_scales(fn, &tsk, sk, nk, batch * heads, sk_pitch, block_k))) {
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
  return launch_lab(d, mode, consumers, block_k, tq, tk, tv, row_k ? &tsk : nullptr, p, batch,
                    static_cast<cudaStream_t>(stream));
}

// A block's query rows, key tile and dynamic shared memory at head
// dimension d (int8: K9) on `consumers` warpgroups, as this build lays them
// out; -1 where not instantiated.
extern "C" int pd_attention_sm90_block_q(int d, int int8, int consumers) {
  return consumers_ok(d, int8 != 0, consumers) ? 64 * consumers : -1;
}

extern "C" int pd_attention_sm90_block_k(int d, int int8, int consumers) {
  return consumers_ok(d, int8 != 0, consumers) ? block_k(int8 != 0, consumers) : -1;
}

extern "C" int pd_attention_sm90_smem(int d, int int8, int consumers) {
  return consumers_ok(d, int8 != 0, consumers)
             ? smem_bytes(d, int8 != 0, consumers, block_k(int8 != 0, consumers))
             : -1;
}

// The dynamic shared memory of a lab mode's block as built (kRowK: int8 K
// tiles and the key scales' stages); -1 where not instantiated.
extern "C" int pd_attention_sm90_lab_smem(int d, int mode, int consumers, int block_k) {
  return lab_ok(d, mode, consumers, block_k)
             ? smem_bytes(d, mode == kRowK, consumers, block_k, mode == kRowK)
             : -1;
}
