// P1: the phase probe of K2 (port of the TPU probe tools/probe_ffn_phases.py,
// `variant_kernel`), as mode variants of K2's own kernels (fused_ffn.cuh):
//   mode 1  no_dw:     the stencil keeps its centre tap only, h . dw[4] + bdw;
//   mode 2  no_gelu:   the full stencil, no GELU;
//   mode 3  no_dwgelu: both.
// They compute a different function on purpose: timed against K2 (mode 0,
// the production entry in fused_ffn.cu) along the same plan, they give the
// share of each phase. The fused route is instantiated for the b2 width it
// runs (64); the split route's stencil for every width. Compiled apart
// from the production library, so its build runs beside it.
#include "fused_ffn.cuh"

template <int MODE>
static int probe(const void* x, const void* gamma, const void* beta, const void* w1,
                 const void* b1, const void* dw, const void* bdw, const void* w2, const void* b2,
                 void* work, void* out, int B, int H, int W, int C, int HID, int fused, int tw,
                 float eps, cudaStream_t st) {
  using namespace uttk::k2;
  if (!fused)
    return launch_split<MODE>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, work, out, B, H, W, C, HID,
                              tw, eps, st);
  if (C == 64)
    return launch_fused<64, MODE>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, out, B, H, W, HID, tw,
                                  eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The arguments of uttk_fused_ffn, after the mode (1, 2 or 3).
int uttk_fused_ffn_probe(int mode, const void* x, const void* gamma, const void* beta,
                         const void* w1, const void* b1, const void* dw, const void* bdw,
                         const void* w2, const void* b2, void* work, void* out, int B, int H,
                         int W, int C, int HID, int fused, int tw, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case uttk::k2::NO_DW:
      return probe<uttk::k2::NO_DW>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, work, out, B, H, W,
                                    C, HID, fused, tw, eps, st);
    case uttk::k2::NO_GELU:
      return probe<uttk::k2::NO_GELU>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, work, out, B, H, W,
                                      C, HID, fused, tw, eps, st);
    case uttk::k2::NO_DWGELU:
      return probe<uttk::k2::NO_DWGELU>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, work, out, B, H,
                                        W, C, HID, fused, tw, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
