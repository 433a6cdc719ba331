// K1: fused SegFormer attention half-block for Hopper (sm_90a), production
// entry point (MODE 0). The design note and the kernels are in
// fused_attention.cuh; the phase-probe variants in fused_attention_probe.cu.
#include "fused_attention.cuh"

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Dynamic shared memory of one attention block at head dim hd (the formula the
// launch checks against the 232,448 bytes a block may use), or of one
// out-projection block (hd = 0).
long long uttk_fused_attention_smem(int hd) {
  return static_cast<long long>(hd ? uttk::k1::attn_smem(hd) : uttk::gemm_smem());
}

// x, out, y, o (B, N, C); gamma, beta, bq, bp (C); wq, wp (C_out, C_in);
// k, v (B, Nkv, heads, C / heads). All bf16, contiguous, 32-byte aligned; y
// and o are scratch (LN(x), the head outputs). Requires C % 16 == 0 and a
// head dim C / heads of 16, 32, 48 or 64. Three launches (LayerNorm,
// attention, out-projection; two with one head). Returns a cudaError_t code
// (0 on success).
int uttk_fused_attention(const void* x, const void* gamma, const void* beta, const void* wq,
                         const void* bq, const void* k, const void* v, const void* wp,
                         const void* bp, void* y, void* o, void* out, int B, int N, int C,
                         int heads, int Nkv, float eps, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C % heads) return static_cast<int>(cudaErrorInvalidValue);
#define UTTK_ATTN_CASE(hd)                                                                     \
  case hd:                                                                                     \
    return uttk::k1::launch<hd, uttk::k1::FULL>(x, gamma, beta, wq, bq, k, v, wp, bp, y, o, out, \
                                                B, N, C, heads, Nkv, eps, scale, true, st);
  switch (C / heads) {
    UTTK_ATTN_CASE(16)
    UTTK_ATTN_CASE(32)
    UTTK_ATTN_CASE(48)
    UTTK_ATTN_CASE(64)
#undef UTTK_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
