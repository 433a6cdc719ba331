// K2: fused SegFormer LayerNorm + MixFFN half-block for Hopper (sm_90a),
// production entry point (MODE 0). The design note and the kernels are in
// fused_ffn.cuh; the phase-probe variants in fused_ffn_probe.cu. The plan
// (route, tile width) is chosen in Python (ops/fused_ffn.py `ffn_plan`) and
// passed here.
#include "fused_ffn.cuh"

// the widths the fused route is instantiated for (the split route takes any C % 16 == 0)
#define UTTK_FFN_FUSED_WIDTHS(X) X(32) X(64)

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Dynamic shared memory of one block of a launch of the plan (the formulas the
// launches check against the 232,448 bytes a block may use): what = 0 the
// fused tile kernel (fused) or the stencil kernel (split), 1 the split
// route's products (fc1 and fc2). -1 for a fused width without an
// instantiation.
long long uttk_fused_ffn_smem(int C, int fused, int tw, int what) {
  if (what == 1) return static_cast<long long>(uttk::gemm_smem());
  if (!fused) return static_cast<long long>(uttk::k2::stencil_smem(tw));
#define UTTK_SMEM(c) \
  if (C == c) return static_cast<long long>(uttk::k2::tile_smem(c, tw));
  UTTK_FFN_FUSED_WIDTHS(UTTK_SMEM)
#undef UTTK_SMEM
  return -1;
}

// x, out (B, H*W, C); gamma, beta, b2 (C); w1 (HID, C); b1, bdw (HID);
// dw (9, HID) with tap index 3*dy + dx; w2 (C, HID); work: scratch of
// B*H*W*(C + 2 HID) bf16 for the split route (may be null when fused). All
// bf16, contiguous, 32-byte aligned. fused: C must be an instantiated width;
// split: C % 16 == 0. tw 8, 16 or 32; HID % 64 == 0. The fused route is one
// launch, the split route four. Returns a cudaError_t code (0 on success).
int uttk_fused_ffn(const void* x, const void* gamma, const void* beta, const void* w1,
                   const void* b1, const void* dw, const void* bdw, const void* w2,
                   const void* b2, void* work, void* out, int B, int H, int W, int C, int HID,
                   int fused, int tw, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fused)
    return uttk::k2::launch_split<uttk::k2::FULL>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, work,
                                                  out, B, H, W, C, HID, tw, eps, st);
#define UTTK_LAUNCH(c)                                                                         \
  if (C == c)                                                                                  \
    return uttk::k2::launch_fused<c, uttk::k2::FULL>(x, gamma, beta, w1, b1, dw, bdw, w2, b2, out, \
                                                     B, H, W, HID, tw, eps, st);
  UTTK_FFN_FUSED_WIDTHS(UTTK_LAUNCH)
#undef UTTK_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
