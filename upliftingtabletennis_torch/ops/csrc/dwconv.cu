// K4: depthwise 3x3 convolution, SAME zero padding, stride 1, + bias, NHWC, for
// Hopper (sm_90a).
//
//   out[b, h, w, c] = bias[c] + sum_{i, j < 3} x[b, h + i - 1, w + j - 1, c] * k[i, j, c]
//
// with x read as 0 outside the image. Replaces the Pallas TPU kernel
// upliftingtabletennis_tpu/ops/dwconv.py (`_dw_kernel`, launched by
// `_dw_pallas`). In the SegFormer trainer it runs twice in the backward of
// every MiTBlock's FFN half (K2's recompute and the recompute's dx, which is
// this same function with the kernel flipped and no bias).
//
// What bounds it: device memory. 18 operations per element against 4 bytes
// (one bf16 read, one bf16 write), so about 0.11 ms at b2's stage-1 hidden
// shape (4, 224, 400, 256) at 3.35 TB/s.
//
// Design. One block per (sample, TH x TW pixel tile, 64-channel group). The
// block copies its (TH+2) x (TW+2) x 64 input tile with a 1-pixel halo into
// shared memory; the halo outside the image is written as zeros by masking the
// load (no padded copy of x in device memory, as the TPU version makes). Each
// thread owns a vector of 8 channels (one 16-byte load; neighbouring threads
// hold neighbouring channels, so a warp reads contiguous bytes) at one column of
// the tile, keeps its 9 taps and bias in registers, and walks down the TH rows,
// reading the 9 neighbours from shared memory. It accumulates in f32 (bias
// first, then the taps in row-major order, as the TPU kernel does) and rounds
// once to bf16. Any H and W (ragged tiles are masked) and any C % 8 == 0 (a
// group's channels beyond C are masked). No pipelining or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int CG = 64;            // channels per block
constexpr int VEC = 8;            // channels per thread (16 bytes of bf16)
constexpr int NV = CG / VEC;      // channel vectors per pixel
constexpr int NTHREADS = TW * NV;  // one thread per (column, channel vector)
constexpr int HALO_ROWS = TH + 2, HALO_COLS = TW + 2;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(p[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__global__ void __launch_bounds__(NTHREADS)
dwconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k, const bf16* __restrict__ bias,
              bf16* __restrict__ out, int H, int W, int C, int tiles_w) {
  __shared__ uint4 tile[HALO_ROWS * HALO_COLS * NV];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CG;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const size_t plane = static_cast<size_t>(H) * W * C;
  const bf16* xb = x + b * plane;

  // the input tile and its halo; zeros outside the image and beyond C
  for (int idx = threadIdx.x; idx < HALO_ROWS * HALO_COLS * NV; idx += NTHREADS) {
    const int v = idx % NV, p = idx / NV;
    const int h = h0 + p / HALO_COLS - 1, w = w0 + p % HALO_COLS - 1;
    const int c = c0 + v * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < H && w >= 0 && w < W && c < C)
      val = *reinterpret_cast<const uint4*>(xb + (static_cast<size_t>(h) * W + w) * C + c);
    tile[idx] = val;
  }

  const int v = threadIdx.x % NV, col = threadIdx.x / NV;
  const int c = c0 + v * VEC;
  const bool active = c < C && w0 + col < W;
  float taps[9][VEC], b0[VEC];
  if (active) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      unpack8(*reinterpret_cast<const uint4*>(k + static_cast<size_t>(t) * C + c), taps[t]);
    unpack8(*reinterpret_cast<const uint4*>(bias + c), b0);
  }
  __syncthreads();
  if (!active) return;

  for (int r = 0; r < TH && h0 + r < H; ++r) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = b0[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float xv[VEC];
        unpack8(tile[((r + i) * HALO_COLS + col + j) * NV + v], xv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += xv[e] * taps[3 * i + j][e];
      }
    }
    uint4 o;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) op[e] = __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + b * plane +
                              (static_cast<size_t>(h0 + r) * W + w0 + col) * C + c) = o;
  }
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x, out (B, H, W, C); k (3, 3, C) with tap index 3*i + j; bias (C). All bf16,
// contiguous, 16-byte aligned; C % 8 == 0. Returns a cudaError_t code (0 on success).
int uttk_dwconv3x3(const void* x, const void* k, const void* bias, void* out, int B, int H, int W,
                   int C, void* stream) {
  if (C % VEC || B < 1 || H < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (C + CG - 1) / CG, B);
  dwconv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), H, W, C, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
