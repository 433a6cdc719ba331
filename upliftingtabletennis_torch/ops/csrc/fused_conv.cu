// K5: fused convolution + bias + ReLU (+ residual) for Hopper (sm_90a).
//
//   out = act(conv_same(x, w) + b [+ residual]),  stride 1, kernel 3x3 (K5a) or 1x1 (K5b)
//
// x, residual and out are NHWC bf16; the products accumulate in f32; the bias,
// the residual and the ReLU are applied to the f32 sum, which is rounded to
// bf16 once. Replaces the Pallas TPU kernels of
// upliftingtabletennis_tpu/ops/fused_conv.py: `_k3` (called from
// `conv3x3_bias_act`) and `_k1` (from `conv1x1_bias_act`). Their TPU layout
// (the row-tap lane stacking, the Co % 128 gate, the block-diagonal lane
// packing of hrnet_packed.py) is not carried over: this is a plain NHWC
// implicit GEMM.
//
// What bounds it: the HRNet's full-resolution 16- and 32-channel convs do
// few operations per byte (a 16->16 3x3 conv about 72 per byte moved, against
// the card's ~295 bf16 tensor operations per byte of device memory), so they
// are bound by bytes; the 64- and 128-channel 3x3 convs are bound by the
// tensor cores. The design reads each input pixel about once from device
// memory (plus the halo, which neighbouring tiles mostly find in L2) and
// writes each output once, with 16-byte coalesced stores.
//
// Design. GEMM view: M = output pixels, N = output channels, K = taps x Ci.
//   * A block keeps its slice of the weights (NB output channels x K, in the
//     layout [co][tap * Ci + ci], zero-padded to K % 16 == 0) in shared memory
//     for its whole life and walks over output tiles of TH x TW pixels of one
//     sample (a persistent grid of as many blocks as fit on the card).
//   * Per tile, the input tile with its halo ((TH + 2) x (TW + 2) pixels for
//     3x3, zero outside the image) is copied to shared memory with cp.async.
//     A K-step of 16 lies inside one tap when Ci % 16 == 0, so the A operand of
//     mma.sync.m16n8k16 is read with ldmatrix straight from the halo tile at
//     the tap's pixel offset: no im2col buffer.
//   * The stem (Ci = 3 or 9: K = 27 or 81) builds an im2col tile in shared
//     memory instead, K zero-padded to 32 or 96 (padding taps x Ci, not Ci per
//     tap, which would cost 144 instead of 96).
//   * Heads with Co = 3 or 13 pad N to 16 with zero weights and mask the
//     stores.
//   * Epilogue: the f32 sums + bias go through shared memory (over the input
//     tile, which is no longer needed) so that each thread then adds 8
//     channels of the residual, applies the ReLU and writes 8 bf16 channels as
//     one 16-byte store. Ragged tiles (H or W not a multiple of the tile) are
//     masked per pixel. out never aliases x or the residual.
// No TMA, wgmma or multi-stage pipelining yet: overlap comes from several
// blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int PADE = 8;  // bf16 row padding of the shared tiles (ldmatrix without bank conflicts)

template <int KS, int CI, int NB, int TH, int TW, int WM, int WN>
struct Cfg {
  static constexpr bool STEM = (CI % 16) != 0;
  static constexpr int HALO = KS / 2;
  static constexpr int KREAL = KS * KS * CI;
  static constexpr int KP = (KREAL + 15) / 16 * 16;  // K padded to whole k16 steps
  static constexpr int KSTEPS = KP / 16;
  static constexpr int IH = TH + 2 * HALO, IW = TW + 2 * HALO;
  static constexpr int P = TH * TW;        // output pixels per tile
  static constexpr int LDI = CI + PADE;    // halo tile row (one pixel)
  static constexpr int LDA = KP + PADE;    // im2col row (stem)
  static constexpr int LDW = KP + PADE;    // weight row (one output channel)
  static constexpr int LDO = NB + 4;       // f32 staging row
  static constexpr int MW = P / WM, MT = MW / 16;  // pixels and m16 tiles per warp
  static constexpr int NW = NB / WN, NT = NW / 8;  // channels and n8 tiles per warp
  static constexpr int IN_BYTES = 2 * (STEM ? P * LDA : IH * IW * LDI);
  static constexpr int OUT_BYTES = 4 * P * LDO;
  static constexpr int TILE_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
  static constexpr size_t smem = 2 * (size_t)NB * LDW + TILE_BYTES + 4 * (size_t)NB;
  static_assert(WM * WN == NWARPS && MW % 16 == 0 && NW % 16 == 0, "bad warp tiling");
  static_assert(STEM ? (KS == 3 && CI < 16) : (CI % 16 == 0), "unsupported Ci");
  static_assert(smem <= 227 * 1024, "tile does not fit in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KS, int CI, int NB, int TH, int TW, int WM, int WN>
__global__ void __launch_bounds__(NTHREADS)
fused_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, const bf16* __restrict__ res,
                  bf16* __restrict__ out, int B, int H, int W, int CO, int relu) {
  using T = Cfg<KS, CI, NB, TH, TW, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);                    // NB x LDW weights
  unsigned char* tile_mem = smem + 2 * (size_t)NB * T::LDW;
  bf16* ins = reinterpret_cast<bf16*>(tile_mem);               // halo tile or im2col tile
  float* outs = reinterpret_cast<float*>(tile_mem);            // P x LDO f32 (same bytes)
  float* bs = reinterpret_cast<float*>(tile_mem + T::TILE_BYTES);  // NB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.y * NB;                 // first output channel of this block
  const int co_rows = (CO + 15) / 16 * 16;        // rows of the packed weight

  // this block's weights and bias, once (published by the first tile's barrier)
  for (int e = tid; e < NB * (T::KP / 8); e += NTHREADS) {
    const int n = e / (T::KP / 8), k8 = e % (T::KP / 8);
    const bool ok = n0 + n < co_rows;
    cp_async16(smem_u32(ws + n * T::LDW + k8 * 8), ok ? w + (size_t)(n0 + n) * T::KP + k8 * 8 : w,
               ok);
  }
  if (tid < NB) bs[tid] = (bias != nullptr && n0 + tid < CO) ? bias[n0 + tid] : 0.f;

  // per-lane parts of the ldmatrix addresses (bytes)
  const uint32_t ins_u = smem_u32(ins);
  uint32_t a_base[T::MT];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int p = wm * T::MW + mt * 16 + (lane & 15);
    if constexpr (T::STEM)
      a_base[mt] = ins_u + 2 * (p * T::LDA + (lane >> 4) * 8);
    else
      a_base[mt] = ins_u + 2 * (((p / TW) * T::IW + p % TW) * T::LDI + (lane >> 4) * 8);
  }
  const uint32_t b_base =
      smem_u32(ws) + 2 * ((wn * T::NW + (lane & 7) + ((lane >> 4) << 3)) * T::LDW +
                          ((lane >> 3) & 1) * 8);

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const size_t plane_in = (size_t)H * W * CI, plane_out = (size_t)H * W * CO;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x), t2 = tile % (tiles_y * tiles_x);
    const int y0 = (t2 / tiles_x) * TH, x0 = (t2 % tiles_x) * TW;
    const bf16* xb = x + (size_t)b * plane_in;

    if constexpr (T::STEM) {  // im2col of the tile: row p, column tap * CI + ci; zero padding
      for (int e = tid; e < T::P * T::KP; e += NTHREADS) {
        const int p = e / T::KP, k = e % T::KP;
        bf16 v = __float2bfloat16(0.f);
        if (k < T::KREAL) {
          const int tap = k / CI, ci = k % CI;
          const int gy = y0 + p / TW + tap / 3 - 1, gx = x0 + p % TW + tap % 3 - 1;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[((size_t)gy * W + gx) * CI + ci];
        }
        ins[p * T::LDA + k] = v;
      }
    } else {  // the input tile with its halo, zero outside the image
      for (int e = tid; e < T::IH * T::IW * (CI / 8); e += NTHREADS) {
        const int q = e / (CI / 8), c8 = e % (CI / 8);
        const int gy = y0 - T::HALO + q / T::IW, gx = x0 - T::HALO + q % T::IW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        cp_async16(ins_u + 2 * (q * T::LDI + c8 * 8),
                   ok ? xb + ((size_t)gy * W + gx) * CI + c8 * 8 : x, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
    for (int s = 0; s < T::KSTEPS; ++s) {
      uint32_t a_off;
      if constexpr (T::STEM) {
        a_off = 32 * s;
      } else {
        const int tap = s / (CI / 16), ci0 = (s % (CI / 16)) * 16;
        a_off = 2 * (((tap / KS) * T::IW + tap % KS) * T::LDI + ci0);
      }
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(a_base[mt] + a_off, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
      for (int j = 0; j < T::NT / 2; ++j) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b_base + 2 * (j * 16 * T::LDW + s * 16), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          mma_bf16(acc[mt][2 * j], a[mt], b0, b1);
          mma_bf16(acc[mt][2 * j + 1], a[mt], b2, b3);
        }
      }
    }
    __syncthreads();  // every warp is done reading the input tile: reuse it for the sums

    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int r = wm * T::MW + mt * 16 + g, c = wn * T::NW + nt * 8 + tg * 2;
        *reinterpret_cast<float2*>(outs + r * T::LDO + c) =
            make_float2(acc[mt][nt][0] + bs[c], acc[mt][nt][1] + bs[c + 1]);
        *reinterpret_cast<float2*>(outs + (r + 8) * T::LDO + c) =
            make_float2(acc[mt][nt][2] + bs[c], acc[mt][nt][3] + bs[c + 1]);
      }
    __syncthreads();

    bf16* ob = out + (size_t)b * plane_out;
    const bf16* rb = res != nullptr ? res + (size_t)b * plane_out : nullptr;
    if (CO % 8 == 0) {  // 8 channels per thread: 16-byte loads of the residual, 16-byte stores
      for (int e = tid; e < T::P * (NB / 8); e += NTHREADS) {
        const int p = e / (NB / 8), c = (e % (NB / 8)) * 8;
        const int gy = y0 + p / TW, gx = x0 + p % TW;
        if (gy >= H || gx >= W || n0 + c >= CO) continue;
        const size_t off = ((size_t)gy * W + gx) * CO + n0 + c;
        const float4 lo = *reinterpret_cast<const float4*>(outs + p * T::LDO + c);
        const float4 hi = *reinterpret_cast<const float4*>(outs + p * T::LDO + c + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (rb != nullptr) {
          const uint4 rv = *reinterpret_cast<const uint4*>(rb + off);
          const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(r2[i]);
            v[2 * i] += f.x;
            v[2 * i + 1] += f.y;
          }
        }
        uint4 o;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a0 = v[2 * i], a1 = v[2 * i + 1];
          if (relu) {
            a0 = fmaxf(a0, 0.f);
            a1 = fmaxf(a1, 0.f);
          }
          o2[i] = __floats2bfloat162_rn(a0, a1);
        }
        *reinterpret_cast<uint4*>(ob + off) = o;
      }
    } else {  // heads with Co = 3 or 13: one channel per thread, masked
      for (int e = tid; e < T::P * NB; e += NTHREADS) {
        const int p = e / NB, c = e % NB;
        const int gy = y0 + p / TW, gx = x0 + p % TW;
        if (gy >= H || gx >= W || n0 + c >= CO) continue;
        const size_t off = ((size_t)gy * W + gx) * CO + n0 + c;
        float v = outs[p * T::LDO + c];
        if (rb != nullptr) v += __bfloat162float(rb[off]);
        if (relu) v = fmaxf(v, 0.f);
        ob[off] = __float2bfloat16(v);
      }
    }
    __syncthreads();  // the staged sums are read before the next tile overwrites them
  }
}

template <int KS, int CI, int NB, int TH, int TW, int WM, int WN>
int launch(const void* x, const void* w, const void* bias, const void* res, void* out, int B,
           int H, int W, int CO, int relu, cudaStream_t stream) {
  auto kernel = fused_conv_kernel<KS, CI, NB, TH, TW, WM, WN>;
  const int smem = static_cast<int>(Cfg<KS, CI, NB, TH, TW, WM, WN>::smem);
  static int blocks_per_sm = 0, sms = 0;  // per instantiation, found at its first launch
  if (blocks_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, bps = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, NTHREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks_per_sm = bps;
  }
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles == 0) return 0;
  const long long cap = (long long)blocks_per_sm * sms;
  const dim3 grid(static_cast<unsigned>(ntiles < cap ? ntiles : cap), (CO + NB - 1) / NB);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), B, H, W, CO, relu);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated convolutions: (KS, CI, CO bucket) -> (NB, TH, TW, WM, WN). The CO
// bucket is CO rounded up to 16, 32, 64 or 128; a block computes NB output channels.
// These are the stride-1 convs of the HRNet (WASB w18-small configuration).
#define UTTK_CONV_TABLE(X)                                                     \
  X(3, 9, 64, 64, 8, 16, 4, 2)     /* WASB stem, 9-channel triplets */         \
  X(3, 3, 64, 64, 8, 16, 4, 2)     /* table stem, 3-channel frames */          \
  X(3, 64, 64, 64, 8, 16, 4, 2)    /* conv2; branch 2 blocks */                \
  X(3, 32, 32, 32, 8, 32, 8, 1)    /* layer1 conv2; branch 1 blocks */         \
  X(3, 16, 16, 16, 8, 32, 8, 1)    /* branch 0 blocks */                       \
  X(3, 128, 16, 16, 8, 16, 8, 1)   /* transition1_0 */                         \
  X(3, 128, 128, 32, 8, 16, 4, 2)  /* branch 3 blocks: 4 blocks of 32 in N */  \
  X(1, 64, 32, 32, 8, 16, 4, 2)    /* layer1 conv1; fuse 2 -> 1 */             \
  X(1, 64, 128, 128, 8, 16, 2, 4)  /* layer1 downsample */                     \
  X(1, 32, 128, 128, 8, 16, 2, 4)  /* layer1 conv3 + residual */               \
  X(1, 32, 16, 16, 8, 32, 8, 1)    /* fuse 1 -> 0 */                           \
  X(1, 64, 16, 16, 8, 32, 8, 1)    /* fuse 2 -> 0 */                           \
  X(1, 128, 16, 16, 8, 16, 8, 1)   /* fuse 3 -> 0 */                           \
  X(1, 128, 32, 32, 8, 16, 4, 2)   /* fuse 3 -> 1 */                           \
  X(1, 128, 64, 64, 8, 16, 4, 2)   /* fuse 3 -> 2 */                           \
  X(1, 16, 16, 16, 8, 32, 8, 1)    /* heads: Co = 3 (WASB) or 13 (table) */

int co_bucket(int co) { return co <= 16 ? 16 : co <= 32 ? 32 : co <= 64 ? 64 : co <= 128 ? 128 : 0; }

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x (B, H, W, ci) bf16; w (round16(co), round16(ks*ks*ci)) bf16, row n = output
// channel, column (dy*ks + dx)*ci + c, zero-padded; bias (co) f32 or null;
// res (B, H, W, co) bf16 or null; out (B, H, W, co) bf16, aliasing neither x
// nor res. All contiguous and 16-byte aligned. Returns a cudaError_t code, or -1
// (nothing launched) if the (ks, ci, co) convolution has no instantiation.
int uttk_fused_conv(const void* x, const void* w, const void* bias, const void* res, void* out,
                    int B, int H, int W, int ks, int ci, int co, int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cb = co_bucket(co);
#define UTTK_LAUNCH(ks_, ci_, cb_, nb, th, tw, wm, wn)                                    \
  if (ks == ks_ && ci == ci_ && cb == cb_)                                                \
    return launch<ks_, ci_, nb, th, tw, wm, wn>(x, w, bias, res, out, B, H, W, co, relu, st);
  UTTK_CONV_TABLE(UTTK_LAUNCH)
#undef UTTK_LAUNCH
  return -1;
}

}  // extern "C"
