// P2: the phase probe of K1 (port of the TPU probe tools/probe_attn_phases.py,
// `variant_kernel`), as mode variants of K1's own kernel (fused_attention.cuh):
//   mode 1  no_softmax: w = logits / Nkv rounded to bf16, no max and no exp;
//   mode 2  no_ln:      y = x: the LayerNorm launch is skipped.
// They compute a different function on purpose: timed against K1 (mode 0,
// the production entry in fused_attention.cu) they give the share of each
// phase. Head dim 64 only (every b2 stage). Compiled apart from the
// production library, so its build runs beside it.
#include "fused_attention.cuh"

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The arguments of uttk_fused_attention, after the mode (1 or 2).
int uttk_fused_attention_probe(int mode, const void* x, const void* gamma, const void* beta,
                               const void* wq, const void* bq, const void* k, const void* v,
                               const void* wp, const void* bp, void* y, void* o, void* out, int B,
                               int N, int C, int heads, int Nkv, float eps, float scale,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C != 64 * heads) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case uttk::k1::NO_SOFTMAX:
      return uttk::k1::launch<64, uttk::k1::NO_SOFTMAX>(x, gamma, beta, wq, bq, k, v, wp, bp, y,
                                                        o, out, B, N, C, heads, Nkv, eps, scale,
                                                        true, st);
    case 2:  // no_ln
      return uttk::k1::launch<64, uttk::k1::FULL>(x, gamma, beta, wq, bq, k, v, wp, bp, y, o, out,
                                                  B, N, C, heads, Nkv, eps, scale, false, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
