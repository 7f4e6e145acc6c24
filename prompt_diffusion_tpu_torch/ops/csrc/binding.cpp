// Python binding of the port's CUDA kernels.
//
// Pointers and the stream arrive as integers (tensor.data_ptr(),
// torch.cuda.current_stream().cuda_stream); the Python wrappers check
// device, dtype, shape, strides and alignment before they call in. Only
// pybind11 is included here, not torch/extension.h, which keeps the build
// to seconds.

#include <pybind11/pybind11.h>

#include <cstdint>
#include <stdexcept>
#include <string>

extern "C" const char* pd_cuda_error_string(int err);
extern "C" int pd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, int mode, int block_q, int block_k, void* stream);
extern "C" int pd_conv3x3_int8(const void* x, const void* w, const void* s_a,
                               const void* s_w, const void* bias, void* out, void* ws,
                               int batch, int h, int wd, int cin, int cout, int out_bf16,
                               int vec, int block_m, int splits, int per_split, void* stream);
extern "C" int pd_conv3x3_int8_xshift(const void* x, const void* w, const void* s_a,
                                      const void* s_w, const void* bias, void* out, void* ws,
                                      int batch, int h, int wd, int cin, int cout,
                                      int out_bf16, int vec, int block_m, int splits,
                                      int per_split, void* stream);
extern "C" int pd_int8_quant_k_occupancy(int d, int threads);
extern "C" int pd_int8_quant_k_head(const void* k, int64_t k_sb, int64_t k_sn, int batch,
                                    int heads, int nk, int d, int rows, int threads, int bps,
                                    void* ws, void* sk, void* codes, int code_d, void* stream);
extern "C" int pd_int8_quant_k_rows(const void* k, int64_t k_sb, int64_t k_sn, int batch,
                                    int heads, int nk, int d, void* sk, int64_t sk_pitch,
                                    void* codes, void* stream);
extern "C" int pd_int8_attention_fwd(
    const void* q, const void* k, const void* sk, int row_k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
    int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
    float scale, int block_q, void* stream);
extern "C" int pd_attention_sm90_fwd(
    const void* q, const void* k, const void* sk, const void* v, void* o, int int8,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, int consumers, void* stream);
extern "C" int pd_attention_sm90_smem(int d, int int8, int consumers);
extern "C" int pd_attention_sm90_block_k(int d, int int8, int consumers);
extern "C" int pd_attention_sm90_block_q(int d, int int8, int consumers);
extern "C" int pd_attention_sm90_lab_fwd(
    const void* q, const void* k, const void* sk, int64_t sk_pitch, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d, int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sn, int64_t k_sh, int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh, float scale, int mode, int consumers, int block_k,
    void* stream);
extern "C" int pd_attention_sm90_lab_smem(int d, int mode, int consumers, int block_k);
extern "C" int pd_attention_sm90_wide_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int nq, int nk,
    int d, int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, void* stream);
extern "C" int pd_attention_sm90_wide_plan(int item);
extern "C" int pd_row_quant(int op, const void* x, int x_bf16, int64_t x_sb, int64_t x_sn,
                            int batch, int n, int c, const void* sc, int sc_bf16, int64_t sc_sb,
                            int64_t sc_sc, const void* sh, int sh_bf16, int64_t sh_sb,
                            int64_t sh_sc, float eps, int tpr, int vpt, int groups, int grid_x,
                            void* out, void* scales, void* stream);
extern "C" int pd_adaln_bwd_occupancy(int x_bf16, int vpt, int c);
extern "C" int pd_adaln_bwd(const void* x, int x_bf16, int64_t x_sb, int64_t x_sn, const void* g,
                            int64_t g_sb, int64_t g_sn, int batch, int n, int c, const void* sc,
                            int sc_bf16, int64_t sc_sb, int64_t sc_sc, float eps, int tpr,
                            int vpt, int groups, int bps, int merge_lanes, void* dx,
                            void* dscale, int dscale_bf16, void* dshift, int dshift_bf16,
                            void* ws, void* stream);
extern "C" int pd_gn_quant_occupancy(int x_bf16, int k, int silu, int threads, int smem);
extern "C" int pd_gn_quant(const void* x, int x_bf16, const void* gamma, const void* beta,
                           void* codes, void* scales, void* ws, int batch, int hw, int c,
                           int groups, float eps, int silu, int k, int rows, int threads,
                           int chunks, int bps, void* stream);
extern "C" int pd_gn_float_occupancy(int x_bf16, int k, int act, int threads, int smem);
extern "C" int pd_gn_float(const void* x, int x_bf16, const void* gamma, const void* beta,
                           void* y, void* ws, int batch, int hw, int c, int groups, float eps,
                           int act, int k, int rows, int threads, int chunks, int bps,
                           void* stream);

namespace {

void* ptr(uintptr_t p) { return reinterpret_cast<void*>(p); }

void flash_attention_fwd(uintptr_t q, uintptr_t k, uintptr_t v, uintptr_t o,
                         int batch, int heads, int nq, int nk, int d,
                         int64_t q_sb, int64_t q_sn, int64_t q_sh,
                         int64_t k_sb, int64_t k_sn, int64_t k_sh,
                         int64_t v_sb, int64_t v_sn, int64_t v_sh,
                         int64_t o_sb, int64_t o_sn, int64_t o_sh,
                         double scale, int mode, int block_q, int block_k, uintptr_t stream) {
  const int err = pd_flash_attention_fwd(
      ptr(q), ptr(k), ptr(v), ptr(o), batch, heads, nq, nk, d,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh,
      static_cast<float>(scale), mode, block_q, block_k, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("flash_attention_fwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void conv3x3_int8(uintptr_t x, uintptr_t w, uintptr_t s_a, uintptr_t s_w, uintptr_t bias,
                  uintptr_t out, uintptr_t ws, int batch, int h, int wd, int cin, int cout,
                  bool out_bf16, bool vec, int block_m, int splits, int per_split, bool xshift,
                  uintptr_t stream) {
  const auto fn = xshift ? pd_conv3x3_int8_xshift : pd_conv3x3_int8;
  const int err = fn(ptr(x), ptr(w), ptr(s_a), ptr(s_w), ptr(bias), ptr(out), ptr(ws),
                     batch, h, wd, cin, cout, out_bf16 ? 1 : 0, vec ? 1 : 0, block_m, splits,
                     per_split, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("conv3x3_int8 launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

int int8_quant_k_occupancy(int d, int threads) { return pd_int8_quant_k_occupancy(d, threads); }

void int8_quant_k_head(uintptr_t k, int64_t k_sb, int64_t k_sn, int batch, int heads, int nk,
                       int d, int rows, int threads, int bps, uintptr_t ws, uintptr_t sk,
                       uintptr_t codes, int code_d, uintptr_t stream) {
  const int err = pd_int8_quant_k_head(ptr(k), k_sb, k_sn, batch, heads, nk, d, rows, threads,
                                       bps, ptr(ws), ptr(sk), ptr(codes), code_d, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("int8_quant_k_head launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void int8_quant_k_rows(uintptr_t k, int64_t k_sb, int64_t k_sn, int batch, int heads, int nk,
                       int d, uintptr_t sk, int64_t sk_pitch, uintptr_t codes, uintptr_t stream) {
  const int err = pd_int8_quant_k_rows(ptr(k), k_sb, k_sn, batch, heads, nk, d, ptr(sk), sk_pitch,
                                       ptr(codes), ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("int8_quant_k_rows launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void int8_attention_fwd(uintptr_t q, uintptr_t k, uintptr_t sk, bool row_k, uintptr_t v,
                        uintptr_t o, int batch, int heads, int nq, int nk, int d,
                        int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
                        int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
                        double scale, int block_q, uintptr_t stream) {
  const int err = pd_int8_attention_fwd(
      ptr(q), ptr(k), ptr(sk), row_k ? 1 : 0, ptr(v), ptr(o), batch, heads, nq, nk, d,
      q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, static_cast<float>(scale), block_q,
      ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("int8_attention_fwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void attention_sm90_fwd(uintptr_t q, uintptr_t k, uintptr_t sk, uintptr_t v, uintptr_t o,
                        bool int8, int batch, int heads, int nq, int nk, int d,
                        int64_t q_sb, int64_t q_sn, int64_t q_sh,
                        int64_t k_sb, int64_t k_sn, int64_t k_sh,
                        int64_t v_sb, int64_t v_sn, int64_t v_sh,
                        int64_t o_sb, int64_t o_sn, int64_t o_sh, double scale,
                        int consumers, uintptr_t stream) {
  const int err = pd_attention_sm90_fwd(
      ptr(q), ptr(k), ptr(sk), ptr(v), ptr(o), int8 ? 1 : 0, batch, heads, nq, nk, d,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh,
      static_cast<float>(scale), consumers, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("attention_sm90_fwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void attention_sm90_lab_fwd(uintptr_t q, uintptr_t k, uintptr_t sk, int64_t sk_pitch,
                            uintptr_t v, uintptr_t o, int batch, int heads, int nq, int nk, int d,
                            int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn,
                            int64_t k_sh, int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb,
                            int64_t o_sn, int64_t o_sh, double scale, int mode, int consumers,
                            int block_k, uintptr_t stream) {
  const int err = pd_attention_sm90_lab_fwd(
      ptr(q), ptr(k), ptr(sk), sk_pitch, ptr(v), ptr(o), batch, heads, nq, nk, d, q_sb, q_sn, q_sh,
      k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh, static_cast<float>(scale), mode,
      consumers, block_k, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("attention_sm90_lab_fwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void attention_sm90_wide_fwd(uintptr_t q, uintptr_t k, uintptr_t v, uintptr_t o, int batch,
                             int heads, int nq, int nk, int d, int64_t q_sb, int64_t q_sn,
                             int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
                             int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb,
                             int64_t o_sn, int64_t o_sh, double scale, uintptr_t stream) {
  const int err = pd_attention_sm90_wide_fwd(
      ptr(q), ptr(k), ptr(v), ptr(o), batch, heads, nq, nk, d, q_sb, q_sn, q_sh, k_sb, k_sn,
      k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh, static_cast<float>(scale), ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("attention_sm90_wide_fwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

void row_quant(int op, uintptr_t x, bool x_bf16, int64_t x_sb, int64_t x_sn, int batch, int n,
               int c, uintptr_t sc, bool sc_bf16, int64_t sc_sb, int64_t sc_sc, uintptr_t sh,
               bool sh_bf16, int64_t sh_sb, int64_t sh_sc, double eps, int tpr, int vpt,
               int groups, int grid_x, uintptr_t out, uintptr_t scales, uintptr_t stream) {
  const int err = pd_row_quant(op, ptr(x), x_bf16 ? 1 : 0, x_sb, x_sn, batch, n, c, ptr(sc),
                               sc_bf16 ? 1 : 0, sc_sb, sc_sc, ptr(sh), sh_bf16 ? 1 : 0, sh_sb,
                               sh_sc, static_cast<float>(eps), tpr, vpt, groups, grid_x,
                               ptr(out), ptr(scales), ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("row_quant launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

int adaln_bwd_occupancy(bool x_bf16, int vpt, int c) {
  return pd_adaln_bwd_occupancy(x_bf16 ? 1 : 0, vpt, c);
}

void adaln_bwd(uintptr_t x, bool x_bf16, int64_t x_sb, int64_t x_sn, uintptr_t g, int64_t g_sb,
               int64_t g_sn, int batch, int n, int c, uintptr_t sc, bool sc_bf16, int64_t sc_sb,
               int64_t sc_sc, double eps, int tpr, int vpt, int groups, int bps,
               int merge_lanes, uintptr_t dx, uintptr_t dscale, bool dscale_bf16,
               uintptr_t dshift, bool dshift_bf16, uintptr_t ws, uintptr_t stream) {
  const int err = pd_adaln_bwd(ptr(x), x_bf16 ? 1 : 0, x_sb, x_sn, ptr(g), g_sb, g_sn, batch, n,
                               c, ptr(sc), sc_bf16 ? 1 : 0, sc_sb, sc_sc,
                               static_cast<float>(eps), tpr, vpt, groups, bps, merge_lanes,
                               ptr(dx), ptr(dscale), dscale_bf16 ? 1 : 0,
                               ptr(dshift), dshift_bf16 ? 1 : 0, ptr(ws), ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("adaln_bwd launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

int gn_quant_occupancy(bool x_bf16, int k, bool silu, int threads, int smem) {
  return pd_gn_quant_occupancy(x_bf16 ? 1 : 0, k, silu ? 1 : 0, threads, smem);
}

void gn_quant(uintptr_t x, bool x_bf16, uintptr_t gamma, uintptr_t beta, uintptr_t codes,
              uintptr_t scales, uintptr_t ws, int batch, int hw, int c, int groups, double eps,
              bool silu, int k, int rows, int threads, int chunks, int bps, uintptr_t stream) {
  const int err = pd_gn_quant(ptr(x), x_bf16 ? 1 : 0, ptr(gamma), ptr(beta), ptr(codes),
                              ptr(scales), ptr(ws), batch, hw, c, groups,
                              static_cast<float>(eps), silu ? 1 : 0, k, rows, threads, chunks,
                              bps, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("gn_quant launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

int gn_float_occupancy(bool x_bf16, int k, int act, int threads, int smem) {
  return pd_gn_float_occupancy(x_bf16 ? 1 : 0, k, act, threads, smem);
}

void gn_float(uintptr_t x, bool x_bf16, uintptr_t gamma, uintptr_t beta, uintptr_t y,
              uintptr_t ws, int batch, int hw, int c, int groups, double eps, int act, int k,
              int rows, int threads, int chunks, int bps, uintptr_t stream) {
  const int err = pd_gn_float(ptr(x), x_bf16 ? 1 : 0, ptr(gamma), ptr(beta), ptr(y), ptr(ws),
                              batch, hw, c, groups, static_cast<float>(eps), act, k, rows,
                              threads, chunks, bps, ptr(stream));
  if (err != 0) {
    throw std::runtime_error(std::string("gn_float launch failed: ") +
                             pd_cuda_error_string(err));
  }
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention_fwd", &flash_attention_fwd,
        "Flash attention forward over strided (B, N, H, D) bf16 tensors "
        "(mode 0 online softmax, 1 no softmax, 2 two passes; query and key tile sizes)");
  m.def("conv3x3_int8", &conv3x3_int8,
        "SAME 3x3 int8 convolution over NHWC with the fp32 dequant epilogue "
        "(bias pointer 0 = no bias; tiles of block_m pixels; splits > 1: split-K over a "
        "(splits, M, Cout) int32 workspace ws, per_split ring stages each; xshift = the "
        "staged-halo variant)");
  m.def("int8_quant_k_occupancy", &int8_quant_k_occupancy,
        "K9p: blocks per SM of the per-head K quantization at head dim d and `threads` "
        "threads (negative: a CUDA error)");
  m.def("int8_quant_k_head", &int8_quant_k_head,
        "K9p: packed bf16 K (B, N, H*D) -> int8 codes with heads code_d bytes apart (code_d = "
        "D: contiguous) and (B, H) fp32 scales, one cooperative launch; the plan of "
        "ops/flash_attention.py::quant_k_plan");
  m.def("int8_quant_k_rows", &int8_quant_k_rows,
        "The lab's per-row K quantization: packed bf16 K (B, N, H*D) -> contiguous int8 codes "
        "and fp32 scales, (B, H) rows of N scales `sk_pitch` floats apart");
  m.def("int8_attention_fwd", &int8_attention_fwd,
        "int8-QK^T attention forward over packed (B, N, H*D) tensors: bf16 Q and V, "
        "int8 K codes with (B, H) fp32 scales, or (B, H, Nk) ones with row_k; block_q 64 or 128");
  m.def("attention_sm90_fwd", &attention_sm90_fwd,
        "Attention forward on warpgroup tensor cores over strided (B, N, H, D) views: bf16 "
        "Q, K, V (K1, K2; D 40, 64, 80, 128), or bf16 Q and V with int8 K codes and (B, H) "
        "fp32 scales (K9; D 32, 40, 64, 80, 128); `consumers` warpgroups of 64 query rows");
  m.def("attention_sm90_smem", &pd_attention_sm90_smem,
        "Shared-memory bytes of a block of the sm90 attention kernel at head dim d (int8: K9) "
        "on `consumers` warpgroups as built (-1: not instantiated)");
  m.def("attention_sm90_block_k", &pd_attention_sm90_block_k,
        "Keys per tile of the sm90 attention kernel as built (-1: not instantiated)");
  m.def("attention_sm90_block_q", &pd_attention_sm90_block_q,
        "Query rows per block of the sm90 attention kernel as built (-1: not instantiated)");
  m.def("attention_sm90_lab_fwd", &attention_sm90_lab_fwd,
        "The attention lab's online (mode 0, L1), no-softmax (1, L2) and two-pass (2, L3) "
        "modes on warpgroup tensor cores over strided bf16 (B, N, H, D) views, and its int8 "
        "mode with per-row K scales (3, L4: K the int8 codes, sk (B*H) rows of scales "
        "`sk_pitch` floats apart), on `consumers` warpgroups of 64 query rows and "
        "`block_k`-key tiles");
  m.def("attention_sm90_lab_smem", &pd_attention_sm90_lab_smem,
        "Shared-memory bytes of a block of a lab mode of the sm90 kernel at head dim d, mode, "
        "consumers and key tile as built (-1: not instantiated)");
  m.def("attention_sm90_wide_fwd", &attention_sm90_wide_fwd,
        "K2 at D = 512 on warpgroup tensor cores over strided bf16 (B, N, H, 512) views");
  m.def("attention_sm90_wide_plan", &pd_attention_sm90_wide_plan,
        "The wide sm90 kernel's layout as built: 0 query rows, 1 key tile, 2 shared memory, "
        "3 stages, 4 producer registers, 5 consumer registers, 6 consumers (-1: other)");
  m.def("row_quant", &row_quant,
        "Rows -> int8 codes and fp32 row scales: op 0 tanh-GELU (K10), op 1 AdaLN with "
        "per-sample (B, C) scale and shift views (K13), op 2 GEGLU of [h | gate] rows (K7), "
        "op 3 LayerNorm (K6), op 4 rows (K11); op 5 AdaLN in x's dtype, no scales (K12); "
        "K10 and K11 split over a tensor group: ops 6 and 7 the row amax of GELU(x) and of x, "
        "ops 8 and 9 the codes and scales from a given row amax (in `sc`); "
        "the plan of ops/row_quant.py::row_plan");
  m.def("adaln_bwd_occupancy", &adaln_bwd_occupancy,
        "K12's backward: blocks per SM of the kernel <bf16, vpt> at c columns "
        "(negative: a CUDA error)");
  m.def("adaln_bwd", &adaln_bwd,
        "K12's backward: dx, dscale and dshift of AdaLN from x, scale and the output's "
        "gradient, one cooperative launch; the plan of ops/row_quant.py::adaln_bwd_plan");
  m.def("gn_quant_occupancy", &gn_quant_occupancy,
        "K5: blocks per SM of the GroupNorm -> int8 kernel <bf16, k, silu> at `threads` "
        "threads and `smem` bytes of dynamic shared memory (negative: a CUDA error)");
  m.def("gn_quant", &gn_quant,
        "K5: GroupNorm(+SiLU) of (B, HW, C) -> int8 codes and one fp32 scale per sample, one "
        "cooperative launch; the plan of ops/gn_quant.py::gn_plan");
  m.def("gn_float_occupancy", &gn_float_occupancy,
        "K3: blocks per SM of the GroupNorm kernel <bf16, k, act> at `threads` threads and "
        "`smem` bytes of dynamic shared memory (negative: a CUDA error)");
  m.def("gn_float", &gn_float,
        "K3: GroupNorm (+SiLU: act 1, +ReLU: act 2) of (B, HW, C) in x's dtype, one "
        "cooperative launch; the plan of ops/gn_quant.py::gn_float_plan");
}
