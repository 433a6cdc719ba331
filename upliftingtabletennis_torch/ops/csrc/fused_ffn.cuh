// K2: fused SegFormer LayerNorm + MixFFN half-block for Hopper (sm_90a),
// kernel bodies.
//
//   out = x + fc2(gelu_erf(dw3x3(fc1(LN(x))) + bdw)) + b2,
//   fc1(y) = y . W1^T + b1,  fc2(z) = z . W2^T
//
// Replaces the Pallas TPU kernel upliftingtabletennis_tpu/ops/fused_ffn.py
// (`_kernel`, called from `fused_ln_ffn`; its v2/v3 variants compute the
// same function in TPU lane layouts). The 3x3 depthwise conv zero-pads the
// HIDDEN tensor at the image border. Roundings are the plain version's:
// LN(x), the hidden tensor h = fc1(LN x) and the GELU output round to bf16;
// every product accumulates in f32. `fused_ffn.cu` exports the production
// entry point (MODE 0); `fused_ffn_probe.cu` the phase-probe variants (the
// TPU probe tools/probe_ffn_phases.py): MODE 1 keeps only the centre tap of
// the stencil, MODE 2 drops the GELU, MODE 3 both.
//
// What bounds it: the operations, 4 * N * C * HID of fc1 and fc2 on the
// tensor cores, then the 9 taps and one erff per hidden element on the f32
// cores; x is read once and out written once.
//
// Design: one C entry point and two routes, the choice made in Python
// (ops/fused_ffn.py `ffn_plan`) and passed in.
//   fused (narrow widths, C <= 64): tile_kernel. A block of 8 warps owns
//     128 output pixels of one sample as a TH x TW tile (TW = 8, 16 or 32,
//     chosen to pad a ragged width the least) and keeps LN(x) of the tile
//     plus a 1-pixel halo in shared memory. The hidden dimension streams
//     through in chunks of HC = 64 channels: fc1 of the chunk on the halo
//     tile (1.4-1.6x the useful rows) into shared memory, zero outside the
//     image; the stencil + bdw + GELU, vectorised (each thread 8 channels as
//     one 16-byte vector, 4 output rows from a 6-row register window); then
//     that 128 x 64 tile . W2[:, chunk]^T accumulated in registers across
//     all chunks (mma.sync, warps as 4 rows x 2 columns). W1 and W2 chunks
//     stream through 2-stage cp.async rings, staged once per block and
//     shared by its warps. h never reaches device memory. One launch.
//   split (C >= 128, where it measured faster than the fused route; at
//     C = 512 the halo tile of LN(x), 180 pixels x 1 KB, and a W1 chunk would
//     not even fit 227 KB beside the rest): ln_kernel -> y = LN(x);
//     gemm_kernel -> h = y . W1^T + b1; stencil_kernel -> g = gelu(dw3x3(h) +
//     bdw); gemm_kernel -> out = x + g . W2^T + b2.
//     y, h and g are bf16 in device memory, where the plain version rounds
//     them anyway; at b2's stage 4 h and g are 23 MB each per batch of 4
//     and mostly stay in the 50 MB L2. Every launch has >= 132 blocks at
//     every b2 stage. The stencil runs once per hidden element (an fc2
//     whose A-tile producer computes it would repeat it once per column
//     tile of the output: 42% of the kernel at stage 4, per the probe).
// Products are mma.sync.m16n8k16 from shared memory; wgmma is left to a
// later PR. erff as the plain version's GELU: no --use_fast_math.
#pragma once

#include "tiles.cuh"

namespace uttk {
namespace k2 {

constexpr int HC = KC;      // hidden channels per chunk
enum Mode { FULL = 0, NO_DW = 1, NO_GELU = 2, NO_DWGELU = 3 };

// rows of the halo tile of a 128-pixel TH x TW tile, rounded up to whole 16-row fragments
__host__ __device__ constexpr int halo_rows(int tw) {
  return ((BM / tw + 2) * (tw + 2) + 15) / 16 * 16;
}

// Dynamic shared memory of one fused tile block (the formula the launch checks).
constexpr size_t tile_smem(int C, int tw) {
  return sizeof(bf16) * (2 * (size_t)C * LDK + (size_t)BM * LDK + (size_t)halo_rows(tw) * LDK +
                         (size_t)halo_rows(tw) * (C + PAD) + 2 * (size_t)HC * (C + PAD));
}

constexpr int STENCIL_CHUNKS = 4;  // hidden chunks per block of the split route's stencil

// Dynamic shared memory of one stencil block.
constexpr size_t stencil_smem(int tw) { return sizeof(bf16) * 2 * (size_t)halo_rows(tw) * LDK; }

// Depthwise 3x3 + bdw (+ exact GELU) of one HC-channel chunk from hs (the halo
// tile, row stride LDK, zero outside the image), rounded to bf16: this
// thread's 8 channels (cg) of output rows 4 ry .. 4 ry + 3 of column px, as
// out[i], from a 6-row register window; the taps are re-read from L1.
template <int MODE>
__device__ __forceinline__ void stencil(const bf16* hs, uint4 (&out)[4], const bf16* __restrict__ dw,
                                        const bf16* __restrict__ bdw, int ch0, int HID, int tw) {
  const int tid = threadIdx.x, cg = tid & 7, px = (tid >> 3) % tw, ry = (tid >> 3) / tw;
  const int hw2 = tw + 2, ch = ch0 + cg * 8;
  constexpr bool ALL_TAPS = MODE == FULL || MODE == NO_GELU;
  constexpr bool GELU = MODE == FULL || MODE == NO_DW;
  float acc[4][8];
  {
    const uint4 bu = *reinterpret_cast<const uint4*>(bdw + ch);
    const uint32_t bw[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(bw[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][2 * j] = f.x;
        acc[i][2 * j + 1] = f.y;
      }
    }
  }
  if (ALL_TAPS) {
#pragma unroll
    for (int ir = 0; ir < 6; ++ir)  // halo rows 4 ry + ir
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 hu = *reinterpret_cast<const uint4*>(hs + ((4 * ry + ir) * hw2 + px + dx) * LDK + cg * 8);
        const uint32_t hw[4] = {hu.x, hu.y, hu.z, hu.w};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int i = ir - dy;  // output row fed by this tap
          if (i < 0 || i > 3) continue;
          const uint4 wu = *reinterpret_cast<const uint4*>(dw + (size_t)(dy * 3 + dx) * HID + ch);
          const uint32_t ww[4] = {wu.x, wu.y, wu.z, wu.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 hv = unpack_bf16(hw[j]), wv = unpack_bf16(ww[j]);
            acc[i][2 * j] = fmaf(hv.x, wv.x, acc[i][2 * j]);
            acc[i][2 * j + 1] = fmaf(hv.y, wv.y, acc[i][2 * j + 1]);
          }
        }
      }
  } else {  // the centre tap only: h . dw[4]
    const uint4 wu = *reinterpret_cast<const uint4*>(dw + (size_t)4 * HID + ch);
    const uint32_t ww[4] = {wu.x, wu.y, wu.z, wu.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 hu = *reinterpret_cast<const uint4*>(hs + ((4 * ry + i + 1) * hw2 + px + 1) * LDK + cg * 8);
      const uint32_t hw[4] = {hu.x, hu.y, hu.z, hu.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 hv = unpack_bf16(hw[j]), wv = unpack_bf16(ww[j]);
        acc[i][2 * j] = fmaf(hv.x, wv.x, acc[i][2 * j]);
        acc[i][2 * j + 1] = fmaf(hv.y, wv.y, acc[i][2 * j + 1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = acc[i][2 * j], c = acc[i][2 * j + 1];
      if (GELU) {
        a = 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
        c = 0.5f * c * (1.f + erff(c * 0.70710678118654752f));
      }
      w[j] = pack_bf16(a, c);
    }
    out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The tile (r0, c0) of block x of a (tiles_y x tiles_x) grid of TH x TW tiles,
// and its halo pixel p -> the pixel's index in the image, or -1 outside it.
struct TileMap {
  int H, W, tw, th, hw2, ph, r0, c0;
  __device__ TileMap(int H_, int W_, int tw_, int bx) : H(H_), W(W_), tw(tw_) {
    th = BM / tw;
    hw2 = tw + 2;
    ph = (th + 2) * hw2;
    const int tiles_x = (W + tw - 1) / tw;
    r0 = (bx / tiles_x) * th;
    c0 = (bx % tiles_x) * tw;
  }
  __device__ long long halo_pix(int p) const {
    const int gy = r0 - 1 + p / hw2, gx = c0 - 1 + p % hw2;
    return p < ph && gy >= 0 && gy < H && gx >= 0 && gx < W ? (long long)gy * W + gx : -1;
  }
  // output pixel p (< BM) of the tile -> its index in the image, or -1 outside it
  __device__ long long out_pix(int p) const {
    const int oy = r0 + p / tw, ox = c0 + p % tw;
    return oy < H && ox < W ? (long long)oy * W + ox : -1;
  }
};

// g = gelu(dw3x3(h) + bdw) (MODE: the probe's variants) on one 128-pixel tile
// for STENCIL_CHUNKS hidden chunks of HC channels, which stream through a
// 2-stage cp.async ring (the next chunk's halo loads while this one is
// computed); h, g (B, H*W, HID). grid (tiles, ceil(HID / HC / STENCIL_CHUNKS), B).
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
stencil_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dw,
               const bf16* __restrict__ bdw, bf16* __restrict__ g, int H, int W, int HID,
               int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // 2 x mp x LDK: chunks of h on the halo tile
  const TileMap tm(H, W, tw, blockIdx.x);
  const int mp = halo_rows(tw);
  const int j0 = blockIdx.y * STENCIL_CHUNKS, j1 = min(j0 + STENCIL_CHUNKS, HID / HC);
  const size_t plane = (size_t)H * W * HID * blockIdx.z;
  auto load = [&](int j, int st) {
    const bf16* hb = h + plane + j * HC;
    for (int e = threadIdx.x; e < mp * (HC / 8); e += NTHREADS) {
      const int p = e >> 3, c8 = (e & 7) * 8;
      const long long pix = tm.halo_pix(p);
      cp_async16(hs + (st * mp + p) * LDK + c8, hb + (pix >= 0 ? pix * HID + c8 : 0), pix >= 0);
    }
  };
  const int cg = threadIdx.x & 7, px = (threadIdx.x >> 3) % tw, ry = (threadIdx.x >> 3) / tw;
  load(j0, 0);
  cp_async_commit();
  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk j landed everywhere; chunk j - 1's stage is free
    if (j + 1 < j1) load(j + 1, st ^ 1);
    cp_async_commit();
    uint4 res[4];
    stencil<MODE>(hs + st * mp * LDK, res, dw, bdw, j * HC, HID, tw);
    bf16* gb = g + plane + j * HC + cg * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 8 threads store one pixel's 128 bytes
      const long long pix = tm.out_pix((4 * ry + i) * tw + px);
      if (pix >= 0) *reinterpret_cast<uint4*>(gb + pix * HID) = res[i];
    }
  }
}

// The fused route: one 128-pixel tile x all C output columns; x -> LN -> fc1
// on the halo -> stencil -> fc2 inside the block. grid (tiles, 1, B).
template <int C, int MODE>
__global__ void __launch_bounds__(NTHREADS)
tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
            const bf16* __restrict__ beta, const bf16* __restrict__ w1,
            const bf16* __restrict__ b1, const bf16* __restrict__ dw,
            const bf16* __restrict__ bdw, const bf16* __restrict__ w2,
            const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int HID, int tw,
            float eps) {
  constexpr int LDY = C + PAD;
  constexpr int WN = C / 2, NT = WN / 8;
  static_assert(WN % 16 == 0, "unsupported width");
  const int mp = halo_rows(tw);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w2s = reinterpret_cast<bf16*>(smem);  // 2 x C x LDK: W2 rows, hidden columns of the chunk
  bf16* gs = w2s + 2 * C * LDK;                // BM x LDK: gelu(dw(h)) of the chunk
  bf16* hs = gs + BM * LDK;                    // mp x LDK: h of the chunk on the halo
  bf16* ys = hs + mp * LDK;                    // mp x LDY: LN(x) on the halo
  bf16* w1s = ys + mp * LDY;                   // 2 x HC x LDY: W1 rows of the chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const TileMap tm(H, W, tw, blockIdx.x);
  const size_t plane = (size_t)H * W;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * plane * C;
  const int nch = HID / HC;

  auto load_w1 = [&](int j, int st) {  // W1 rows j*HC.., all C columns
    bf16* dst = w1s + st * HC * LDY;
    for (int e = tid; e < HC * (C / 8); e += NTHREADS) {
      const int r = e / (C / 8), c8 = (e % (C / 8)) * 8;
      cp_async16(dst + r * LDY + c8, w1 + (size_t)(j * HC + r) * C + c8, true);
    }
  };
  for (int e = tid; e < mp * (C / 8); e += NTHREADS) {  // x of the halo pixels
    const int p = e / (C / 8), c8 = (e % (C / 8)) * 8;
    const long long pix = tm.halo_pix(p);
    cp_async16(ys + p * LDY + c8, xb + (pix >= 0 ? pix * C + c8 : 0), pix >= 0);
  }
  load_w1(0, 0);
  load_chunk(w2s, w2, 0, C, C, HID, 0);
  cp_async_commit();

  // LN of the halo rows in place (two-pass, from shared memory)
  cp_async_wait_all();
  __syncthreads();
  {
    const int sub = lane & 7;
    for (int p0 = warp * 4; p0 < mp; p0 += NWARPS * 4) {  // mp % 4 == 0: whole warps agree
      bf16* yr = ys + (p0 + (lane >> 3)) * LDY;
      float s = 0.f;
      for (int v = sub; v < C / 8; v += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(yr + v * 8);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(w[i]);
          s += f.x + f.y;
        }
      }
      const float mean = oct_sum(s) / C;
      float s2 = 0.f;
      for (int v = sub; v < C / 8; v += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(yr + v * 8);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(w[i]);
          s2 += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
        }
      }
      const float rstd = rsqrtf(oct_sum(s2) / C + eps);
      for (int v = sub; v < C / 8; v += 8) {
        uint4 u = *reinterpret_cast<uint4*>(yr + v * 8);
        const uint4 gu = *reinterpret_cast<const uint4*>(gamma + v * 8);
        const uint4 bu = *reinterpret_cast<const uint4*>(beta + v * 8);
        uint32_t w[4] = {u.x, u.y, u.z, u.w};
        const uint32_t gw[4] = {gu.x, gu.y, gu.z, gu.w}, bw[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(w[i]), gg = unpack_bf16(gw[i]), bb = unpack_bf16(bw[i]);
          w[i] = pack_bf16((f.x - mean) * rstd * gg.x + bb.x, (f.y - mean) * rstd * gg.y + bb.y);
        }
        *reinterpret_cast<uint4*>(yr + v * 8) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  float acc[2][NT][4];
  zero_acc(acc);
  for (int j = 0; j < nch; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk j landed everywhere; chunk j - 1's stages are free
    if (j + 1 < nch) {
      load_w1(j + 1, st ^ 1);
      load_chunk(w2s + (st ^ 1) * C * LDK, w2, 0, C, C, HID, (j + 1) * HC);
    }
    cp_async_commit();
    // h = fc1(LN x) of chunk j on the halo: mp / 16 row tiles x 2 column halves
    const bf16* w1c = w1s + st * HC * LDY;
    for (int u = warp; u < (mp / 16) * 2; u += NWARPS) {
      const int mt = u >> 1, nh = u & 1;
      float a1[1][4][4];
      zero_acc(a1);
      warp_mma<1, 4, C / 16>(a1, ys + mt * 16 * LDY, LDY, w1c + nh * 32 * LDY, LDY);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = nh * 32 + ni * 8 + 2 * t;
        const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + j * HC + col));
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = mt * 16 + g + hi * 8;
          *reinterpret_cast<uint32_t*>(hs + p * LDK + col) =
              tm.halo_pix(p) >= 0 ? pack_bf16(a1[0][ni][2 * hi] + bb.x, a1[0][ni][2 * hi + 1] + bb.y)
                                  : 0u;
        }
      }
    }
    __syncthreads();
    {
      uint4 res[4];
      stencil<MODE>(hs, res, dw, bdw, j * HC, HID, tw);
      const int cg = tid & 7, px = (tid >> 3) % tw, ry = (tid >> 3) / tw;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(gs + ((4 * ry + i) * tw + px) * LDK + cg * 8) = res[i];
    }
    __syncthreads();
    warp_mma<2, NT, HC / 16>(acc, gs + wm * 32 * LDK, LDK, w2s + st * C * LDK + wn * WN * LDK, LDK);
  }

  // out = x + acc + b2 for the tile's pixels inside the image
  bf16* outb = out + (size_t)b * plane * C;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn * WN + ni * 8 + 2 * t;
    const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const long long pix = tm.out_pix(wm * 32 + mi * 16 + g + hi * 8);
        if (pix < 0) continue;
        const size_t off = (size_t)pix * C + col;
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xb + off));
        *reinterpret_cast<uint32_t*>(outb + off) =
            pack_bf16(xv.x + (acc[mi][ni][2 * hi] + bb.x), xv.y + (acc[mi][ni][2 * hi + 1] + bb.y));
      }
  }
}

inline bool valid_shape(int B, int H, int W, int HID, int tw) {
  return B >= 1 && B <= 65535 && H >= 1 && W >= 1 && HID >= HC && HID % HC == 0 &&
         (tw == 8 || tw == 16 || tw == 32) &&
         (long long)((H + BM / tw - 1) / (BM / tw)) * ((W + tw - 1) / tw) <= 0x7fffffffLL;
}

inline dim3 tile_grid(int B, int H, int W, int tw, int ny) {
  const int th = BM / tw;
  return dim3(((H + th - 1) / th) * ((W + tw - 1) / tw), ny, B);
}

// The fused route. x, out (B, H*W, C); gamma, beta, b2 (C); w1 (HID, C);
// b1, bdw (HID); dw (9, HID); w2 (C, HID).
template <int C, int MODE>
int launch_fused(const void* x, const void* gamma, const void* beta, const void* w1,
                 const void* b1, const void* dw, const void* bdw, const void* w2, const void* b2,
                 void* out, int B, int H, int W, int HID, int tw, float eps, cudaStream_t stream) {
  const size_t smem = tile_smem(C, tw);
  if (!valid_shape(B, H, W, HID, tw) || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<C, MODE><<<tile_grid(B, H, W, tw, 1), NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(dw), static_cast<const bf16*>(bdw), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), H, W, HID, tw, eps);
  return static_cast<int>(cudaGetLastError());
}

// The split route, arguments as launch_fused; work: scratch of B*H*W*(C + 2 HID)
// bf16 for y, h and g.
template <int MODE>
int launch_split(const void* x, const void* gamma, const void* beta, const void* w1,
                 const void* b1, const void* dw, const void* bdw, const void* w2, const void* b2,
                 void* work, void* out, int B, int H, int W, int C, int HID, int tw, float eps,
                 cudaStream_t stream) {
  if (!valid_shape(B, H, W, HID, tw) || C % 16 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = (long long)B * H * W;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(work);
  bf16* h = y + M * C;
  bf16* g = h + M * HID;
  int err = launch_ln(xb, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta), y, M,
                      C, eps, stream);
  if (err) return err;
  err = launch_gemm<EPI_BIAS>(y, static_cast<const bf16*>(w1),
                                      static_cast<const bf16*>(b1), nullptr, h, M, C, HID, stream);
  if (err) return err;
  const size_t smem = stencil_smem(tw);
  err = static_cast<int>(cudaFuncSetAttribute(
      stencil_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  const int groups = (HID / HC + STENCIL_CHUNKS - 1) / STENCIL_CHUNKS;
  stencil_kernel<MODE><<<tile_grid(B, H, W, tw, groups), NTHREADS, smem, stream>>>(
      h, static_cast<const bf16*>(dw), static_cast<const bf16*>(bdw), g, H, W, HID, tw);
  const cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return launch_gemm<EPI_BIAS_RESIDUAL>(g, static_cast<const bf16*>(w2),
                                                static_cast<const bf16*>(b2), xb,
                                                static_cast<bf16*>(out), M, HID, C, stream);
}

}  // namespace k2
}  // namespace uttk
