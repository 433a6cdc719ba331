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
// packing of hrnet_packed.py) is not carried over: this is an NHWC implicit
// GEMM, M = output pixels, N = output channels, K = taps x Ci.
//
// What bounds it: the HRNet's full-resolution 16- and 32-channel convs and
// the stems do few operations per byte (a 16->16 3x3 conv about 72 per byte
// moved, against the card's ~295 bf16 tensor operations per byte of device
// memory), so they are bound by bytes; the 64- and 128-channel 3x3 convs are
// bound by the tensor cores.
//
// K5a (`conv3x3_kernel`), the 3x3 convs. Tiles, ring depth and channel
// groups come from the launch plan (`conv_plan` in ops/fused_conv.py); the
// instantiations below are the plans of the HRNet's convs.
//   * A persistent block walks over output tiles of TH x TW pixels of one
//     sample. Its NB output channels' weights stay in shared memory for its
//     whole life, as wgmma's K-major B operand (core matrices of 8 channels x
//     8 taps-channels, no swizzle).
//   * Warpgroup 2 is the producer. It keeps up to ST tiles in flight in a ring
//     of stages with full / empty mbarriers. A stage holds the tile's input
//     with its one-pixel halo, loaded by TMA through a 4-D map over NHWC
//     (C, W, H, B) as boxes of (<= 64 channels, TW + 2, TH + 2, 1) from
//     (x0 - 1, y0 - 1): the out-of-bounds fill is the SAME zero padding, and
//     ragged tiles need no masks. With a residual, the stage also holds the
//     tile's residual (a TMA box per consumer half).
//   * The stems (Ci = 3 or 9: a pixel of 6 or 18 bytes, no TMA stride) are
//     loaded by the producer warpgroup's 128 threads, one coalesced pass over
//     the halo rows into a tile of 16 channels per pixel whose channels
//     beyond Ci stay zero: the stem is a 3x3 conv with Ci = 16 (K = 144).
//   * Warpgroups 0 and 1 are consumers, each owning half the tile's rows
//     (P / 2 pixels, in m64 blocks). For each 16-deep K step (one tap, 16
//     channels) every warp reads its 16 pixels' A fragment with ldmatrix
//     straight from the halo tile at the tap's pixel offset (the halo tile
//     is stored with TMA's swizzle of its channel width, which the addresses
//     follow), and the warpgroup issues wgmma m64nNBk16 with A from registers
//     and the weights from shared memory. A fragments are double-buffered: the
//     next step's ldmatrix runs while this step's products are in flight.
//   * Epilogue per consumer half: bias and residual (from the stage) on the
//     f32 sums, ReLU, one rounding to bf16, staged swizzled in shared memory
//     and written by a TMA store, which clips at the image edge. The stage is
//     released as soon as its residual is read, so the producer's next loads
//     and the other half's products overlap this one's epilogue.
//
// K5b (`conv1x1_kernel`), the 1x1 convs, keeps its first design: a
// persistent block with its weights in shared memory, the input tile copied
// with cp.async, mma.sync products with ldmatrix fragments, and an f32
// staging epilogue with 16-byte stores; heads with Co = 3 or 13 pad N to 16
// with zero weights and mask the stores.
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int round1024(int n) { return (n + 1023) / 1024 * 1024; }

// K5a's K steps per group of wgmmas: the most that divides `ksteps` with `mt` m64 blocks
// each, within 8 A fragments per group (two groups in 64 registers)
constexpr int group_steps(int ksteps, int mt) {
  for (int g = 8 / mt; g > 1; --g)
    if (ksteps % g == 0) return g;
  return 1;
}

// ---- K5a -----------------------------------------------------------------------------------
constexpr int CONV_THREADS = 384;  // two consumer warpgroups and the producer warpgroup
constexpr int CONSUMERS = 256;

// CI the input channels; CIS the channels per pixel of the halo tile (16 for the stems);
// NB output channels per block; TH x TW the tile; ST the ring depth.
template <int CI, int CIS, int NB, int TH, int TW, int ST>
struct Conv3 {
  static constexpr bool STEM = CI != CIS;
  static constexpr int CB = CIS < 64 ? CIS : 64;  // channels per halo box (its swizzle: 2 CB B)
  static constexpr int NCB = CIS / CB;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int P = TH * TW, PW = P / 2;  // pixels per tile and per consumer half
  static constexpr int MT = PW / 64;             // m64 blocks per consumer warpgroup
  static constexpr int KP = 9 * CIS, KSTEPS = KP / 16;
  static constexpr int KG = group_steps(KSTEPS, MT);
  static constexpr int HALO_BOX = round1024(IH * IW * CB * 2);
  static constexpr int HALF = PW * NB * 2;  // one half's residual or output tile (bytes)
  static constexpr int STAGE = NCB * HALO_BOX + 2 * HALF;
  static constexpr int OUT = ST * STAGE;                    // offsets from the aligned base
  static constexpr int WEIGHTS = OUT + 2 * HALF;
  static constexpr int BIAS = WEIGHTS + round1024(NB * KP * 2);
  static constexpr int BARS = BIAS + 4 * NB;
  static constexpr int SMEM = 1024 + BARS + 16 * ST;
  static_assert(CIS % 16 == 0 && (STEM ? CIS == 16 && CI < 16 : CI == CIS), "unsupported Ci");
  static_assert(NB == 16 || NB == 32 || NB == 64, "wgmma N and the output swizzle");
  static_assert(TW % 16 == 0 && TH % 2 == 0 && PW % 64 == 0, "bad tile");
  static_assert(IW <= 256 && IH <= 256, "TMA box dimensions");
  static_assert(HALF % 1024 == 0, "swizzled tiles start on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "tile does not fit in shared memory");
};

template <int CI, int CIS, int NB, int TH, int TW, int ST>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap rmap,
               const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ x,
               const bf16* __restrict__ w, const float* __restrict__ bias, int has_res, int B,
               int H, int W, int relu) {
  using C = Conv3<CI, CIS, NB, TH, TW, ST>;
  constexpr int XSW = 2 * C::CB, OSW = 2 * NB;  // swizzles of the halo and output tiles
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = uttk::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic address
  auto stage = [&](int s) { return base + s * C::STAGE; };
  auto res_half = [&](int s, int half) {
    return stage(s) + C::NCB * C::HALO_BOX + half * C::HALF;
  };
  const uint32_t w_s = base + C::WEIGHTS;
  float* bias_s = reinterpret_cast<float*>(gbase + C::BIAS);
  auto full = [&](int s) { return base + C::BARS + 8 * s; };
  auto empty = [&](int s) { return base + C::BARS + 8 * (ST + s); };

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NB;
  // the block's weights as core matrices: [NB / 8][KP / 8][8 channels][8 k]
  for (int e = tid; e < NB * (C::KP / 8); e += CONV_THREADS) {
    const int n = e / (C::KP / 8), k8 = e % (C::KP / 8);
    const uint4 v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * C::KP + 8 * k8);
    *reinterpret_cast<uint4*>(gbase + C::WEIGHTS + ((n / 8) * (C::KP / 8) + k8) * 128 +
                              (n % 8) * 16) = v;
  }
  if (tid < NB) bias_s[tid] = bias != nullptr ? bias[n0 + tid] : 0.f;
  if constexpr (C::STEM) {  // the widened channels CI .. 15 of every halo tile stay zero
    for (int s = 0; s < ST; ++s)
      for (int e = tid; e < C::HALO_BOX / 16; e += CONV_THREADS)
        reinterpret_cast<uint4*>(gbase + s * C::STAGE)[e] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      uttk::mbar_init(full(s), C::STEM ? 128 : 1);
      uttk::mbar_init(empty(s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    uttk::mbar_fence_init();
  }
  uttk::fence_proxy_async();  // the weights are read by wgmma (the async proxy)
  __syncthreads();

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    b = tile / (tiles_y * tiles_x);
    const int t2 = tile % (tiles_y * tiles_x);
    y0 = (t2 / tiles_x) * TH;
    x0 = (t2 % tiles_x) * TW;
  };
  constexpr uint32_t HALO_BYTES = C::NCB * C::CB * C::IW * C::IH * 2;
  constexpr uint32_t TX = (C::STEM ? 0 : HALO_BYTES);

  if (tid >= CONSUMERS) {  // ---- producer warpgroup (one thread, or all 128 for a stem)
    const int pt = tid - CONSUMERS;
    if (!C::STEM && pt != 0) return;
    int i = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
      const int s = i % ST;
      int b, y0, x0;
      origin(tile, b, y0, x0);
      if (i >= ST) uttk::mbar_wait(empty(s), ((i / ST) - 1) & 1);
      if constexpr (C::STEM) {
        // halo rows of Ci-channel pixels, coalesced, into 16-channel pixels
        constexpr int NE = C::IH * C::IW * CI, PER = (NE + 127) / 128;
        const bf16* xb = x + (size_t)b * H * W * CI;
        bf16 v[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int e = pt + 128 * j;
          const int hp = e / CI, c = e - hp * CI;
          const int gy = y0 - 1 + hp / C::IW, gx = x0 - 1 + hp % C::IW;
          const bool in = e < NE && gy >= 0 && gy < H && gx >= 0 && gx < W;
          v[j] = in ? xb[((size_t)gy * W + gx) * CI + c] : __float2bfloat16(0.f);
        }
        unsigned char* halo = gbase + s * C::STAGE;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int e = pt + 128 * j;
          if (e < NE) {
            const int hp = e / CI, c = e - hp * CI;
            *reinterpret_cast<bf16*>(halo + uttk::swizzle<XSW>(hp * 32 + 2 * c)) = v[j];
          }
        }
        if (pt == 0 && has_res) {
          uttk::mbar_expect_tx(full(s), 2 * C::HALF);
          for (int half = 0; half < 2; ++half)
            uttk::tma_load_4d(res_half(s, half), &rmap, full(s), n0, x0, y0 + half * (TH / 2), b);
        } else {
          uttk::mbar_arrive(full(s));
        }
      } else {
        uttk::mbar_expect_tx(full(s), TX + (has_res ? 2 * C::HALF : 0));
        for (int cb = 0; cb < C::NCB; ++cb)
          uttk::tma_load_4d(stage(s) + cb * C::HALO_BOX, &xmap, full(s), cb * C::CB, x0 - 1,
                            y0 - 1, b);
        if (has_res)
          for (int half = 0; half < 2; ++half)
            uttk::tma_load_4d(res_half(s, half), &rmap, full(s), n0, x0, y0 + half * (TH / 2), b);
      }
    }
  } else {  // ---- consumer warpgroups 0 and 1: pixels wg * PW .. + PW - 1 of each tile
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this lane's ldmatrix row: the halo pixel of its output pixel at tap (0, 0), per m64 block
    int hp0[C::MT];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int p = wg * C::PW + mt * 64 + 16 * warp + (lane & 15);
      hp0[mt] = (p / TW) * C::IW + p % TW;
    }
    const int kc = (lane >> 4) * 8;  // the lane's 8 channels within a 16-deep step
    const uint32_t out_s = base + C::OUT + wg * C::HALF;
    unsigned char* out_g = gbase + C::OUT + wg * C::HALF;
    int i = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
      const int s = i % ST;
      int b, y0, x0;
      origin(tile, b, y0, x0);
      uttk::mbar_wait(full(s), (i / ST) & 1);
      const uint32_t halo = stage(s);
      // A fragments of KG steps per group, two groups: the next group's ldmatrix runs
      // while this group's products are in flight
      uint32_t a[2][C::KG][C::MT][4];
      auto load_group = [&](int grp, int buf) {
#pragma unroll
        for (int kk = 0; kk < C::KG; ++kk) {
          const int ks = grp * C::KG + kk;
          const int tap = ks / (CIS / 16), ci0 = (ks % (CIS / 16)) * 16;
          const int shift = (tap / 3) * C::IW + tap % 3;
          const uint32_t box = halo + (ci0 / C::CB) * C::HALO_BOX;
          const int cc = 2 * (ci0 % C::CB + kc);
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            const uint32_t addr = box + uttk::swizzle<XSW>((hp0[mt] + shift) * XSW + cc);
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(a[buf][kk][mt][0]), "=r"(a[buf][kk][mt][1]),
                           "=r"(a[buf][kk][mt][2]), "=r"(a[buf][kk][mt][3])
                         : "r"(addr));
          }
        }
      };
      float acc[C::MT][NB / 2];
      load_group(0, 0);
#pragma unroll
      for (int grp = 0; grp < C::KSTEPS / C::KG; ++grp) {
        uttk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KG; ++kk) {
          // weights of step ks: core matrices 2 ks and 2 ks + 1 along K
          const int ks = grp * C::KG + kk;
          const uint64_t wd = uttk::wgmma_desc(w_s + ks * 256, 128, (C::KP / 8) * 128, 0);
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt)
            uttk::wgmma_rs<NB, 0>(acc[mt], a[grp & 1][kk][mt], wd, ks > 0);
        }
        uttk::wgmma_commit();
        if (grp + 1 < C::KSTEPS / C::KG) {
          uttk::wgmma_wait<1>();  // group grp - 1 is done with the other A buffer
          load_group(grp + 1, (grp + 1) & 1);
        }
      }
      uttk::wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) uttk::fence_operands(acc[mt]);

      // bias and residual on the f32 sums; then the stage goes back to the producer
      const unsigned char* res_g = gbase + (res_half(s, wg) - base);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = mt * 64 + 16 * warp + g + 8 * hi, col = 8 * j + 2 * t;
            float v0 = acc[mt][4 * j + 2 * hi] + bias_s[col];
            float v1 = acc[mt][4 * j + 2 * hi + 1] + bias_s[col + 1];
            if (has_res) {
              const uint32_t rv = *reinterpret_cast<const uint32_t*>(
                  res_g + uttk::swizzle<OSW>(r * OSW + 2 * col));
              const float2 f =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
              v0 += f.x;
              v1 += f.y;
            }
            acc[mt][4 * j + 2 * hi] = v0;
            acc[mt][4 * j + 2 * hi + 1] = v1;
          }
      __syncwarp();
      if (lane == 0) uttk::mbar_arrive(empty(s));

      // ReLU, bf16, staged swizzled; one thread stores the half with TMA
      if ((tid & 127) == 0) uttk::bulk_wait_read();  // the last store has read the staging
      uttk::named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = mt * 64 + 16 * warp + g + 8 * hi, col = 8 * j + 2 * t;
            float v0 = acc[mt][4 * j + 2 * hi], v1 = acc[mt][4 * j + 2 * hi + 1];
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(out_g + uttk::swizzle<OSW>(r * OSW + 2 * col)) = o;
          }
      uttk::fence_proxy_async();
      uttk::named_bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
        uttk::tma_store_4d(&omap, out_s, n0, x0, y0 + wg * (TH / 2), b);
        uttk::bulk_commit();
      }
    }
    if ((tid & 127) == 0) uttk::bulk_wait();
  }
}

template <int CI, int CIS, int NB, int TH, int TW, int ST>
int launch3(const void* x, const void* w, const void* bias, const void* res, void* out, int B,
            int H, int W, int CO, int relu, cudaStream_t stream) {
  using C = Conv3<CI, CIS, NB, TH, TW, ST>;
  auto kernel = conv3x3_kernel<CI, CIS, NB, TH, TW, ST>;
  uttk_host::Occupancy occ;
  int err = uttk_host::prepare<conv3x3_kernel<CI, CIS, NB, TH, TW, ST>>(C::SMEM, CONV_THREADS,
                                                                       &occ);
  if (err != 0) return err;
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles == 0) return 0;
  // NHWC tensors as (C, W, H, B) maps; the stem's x is read without a map
  const uint64_t dx[4] = {(uint64_t)CI, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t dy[4] = {(uint64_t)CO, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t sx[3] = {2ull * CI, 2ull * CI * W, 2ull * CI * W * H};
  const uint64_t sy[3] = {2ull * CO, 2ull * CO * W, 2ull * CO * W * H};
  const uint32_t bx[4] = {C::CB, C::IW, C::IH, 1}, by[4] = {NB, TW, TH / 2, 1};
  CUtensorMap xm = {}, rm = {}, om;
  if (!C::STEM && (err = uttk_host::tensor_map_4d(&xm, x, dx, sx, bx, 2 * C::CB)) != 0) return err;
  if (res != nullptr && (err = uttk_host::tensor_map_4d(&rm, res, dy, sy, by, 2 * NB)) != 0)
    return err;
  if ((err = uttk_host::tensor_map_4d(&om, out, dy, sy, by, 2 * NB)) != 0) return err;
  const int groups = CO / NB;
  const long long per_group = (long long)occ.blocks_per_sm * occ.sms / groups;
  const long long cap = per_group > 0 ? per_group : 1;
  const dim3 grid(static_cast<unsigned>(ntiles < cap ? ntiles : cap), groups);
  kernel<<<grid, CONV_THREADS, C::SMEM, stream>>>(
      xm, rm, om, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), res != nullptr, B, H, W, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---- K5b -----------------------------------------------------------------------------------
constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int PADE = 8;  // bf16 row padding of the shared tiles (ldmatrix without bank conflicts)

template <int CI, int NB, int TH, int TW, int WM, int WN>
struct Conv1 {
  static constexpr int KP = (CI + 15) / 16 * 16;  // K padded to whole k16 steps
  static constexpr int KSTEPS = KP / 16;
  static constexpr int P = TH * TW;        // output pixels per tile
  static constexpr int LDI = CI + PADE;    // input tile row (one pixel)
  static constexpr int LDW = KP + PADE;    // weight row (one output channel)
  static constexpr int LDO = NB + 4;       // f32 staging row
  static constexpr int MW = P / WM, MT = MW / 16;  // pixels and m16 tiles per warp
  static constexpr int NW = NB / WN, NT = NW / 8;  // channels and n8 tiles per warp
  static constexpr int IN_BYTES = 2 * P * LDI;
  static constexpr int OUT_BYTES = 4 * P * LDO;
  static constexpr int TILE_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
  static constexpr int SMEM = 2 * NB * LDW + TILE_BYTES + 4 * NB;
  static_assert(WM * WN == NWARPS && MW % 16 == 0 && NW % 16 == 0, "bad warp tiling");
  static_assert(CI % 16 == 0, "unsupported Ci");
  static_assert(SMEM <= 227 * 1024, "tile does not fit in shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

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

template <int CI, int NB, int TH, int TW, int WM, int WN>
__global__ void __launch_bounds__(NTHREADS)
conv1x1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, const bf16* __restrict__ res,
               bf16* __restrict__ out, int B, int H, int W, int CO, int relu) {
  using T = Conv1<CI, NB, TH, TW, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);                    // NB x LDW weights
  unsigned char* tile_mem = smem + 2 * (size_t)NB * T::LDW;
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
    cp_async16(uttk::smem_u32(ws + n * T::LDW + k8 * 8),
               ok ? w + (size_t)(n0 + n) * T::KP + k8 * 8 : w, ok);
  }
  if (tid < NB) bs[tid] = (bias != nullptr && n0 + tid < CO) ? bias[n0 + tid] : 0.f;

  // per-lane parts of the ldmatrix addresses (bytes)
  const uint32_t ins_u = uttk::smem_u32(tile_mem);
  uint32_t a_base[T::MT];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int p = wm * T::MW + mt * 16 + (lane & 15);
    a_base[mt] = ins_u + 2 * (p * T::LDI + (lane >> 4) * 8);
  }
  const uint32_t b_base =
      uttk::smem_u32(ws) + 2 * ((wn * T::NW + (lane & 7) + ((lane >> 4) << 3)) * T::LDW +
                                ((lane >> 3) & 1) * 8);

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const size_t plane_in = (size_t)H * W * CI, plane_out = (size_t)H * W * CO;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x), t2 = tile % (tiles_y * tiles_x);
    const int y0 = (t2 / tiles_x) * TH, x0 = (t2 % tiles_x) * TW;
    const bf16* xb = x + (size_t)b * plane_in;

    // the input tile, zero outside the image
    for (int e = tid; e < T::P * (CI / 8); e += NTHREADS) {
      const int q = e / (CI / 8), c8 = e % (CI / 8);
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      const bool ok = gy < H && gx < W;
      cp_async16(ins_u + 2 * (q * T::LDI + c8 * 8),
                 ok ? xb + ((size_t)gy * W + gx) * CI + c8 * 8 : x, ok);
    }
    asm volatile("cp.async.wait_all;\n" ::);
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
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(a_base[mt] + 32 * s, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
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

template <int CI, int NB, int TH, int TW, int WM, int WN>
int launch1(const void* x, const void* w, const void* bias, const void* res, void* out, int B,
            int H, int W, int CO, int relu, cudaStream_t stream) {
  using T = Conv1<CI, NB, TH, TW, WM, WN>;
  auto kernel = conv1x1_kernel<CI, NB, TH, TW, WM, WN>;
  uttk_host::Occupancy occ;
  const int err =
      uttk_host::prepare<conv1x1_kernel<CI, NB, TH, TW, WM, WN>>(T::SMEM, NTHREADS, &occ);
  if (err != 0) return err;
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles == 0) return 0;
  const long long cap = (long long)occ.blocks_per_sm * occ.sms;
  const dim3 grid(static_cast<unsigned>(ntiles < cap ? ntiles : cap), (CO + NB - 1) / NB);
  kernel<<<grid, NTHREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), B, H, W, CO, relu);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: the launch plans `conv_plan` (ops/fused_conv.py) gives the
// stride-1 convs of the HRNet (WASB w18-small configuration).
// 3x3: (CI, CIS, CO, NB, TH, TW, ST); a block computes NB of the CO output channels.
#define UTTK_CONV3_TABLE(X)                                                  \
  X(9, 16, 64, 64, 16, 16, 4)      /* WASB stem, 9-channel triplets */       \
  X(3, 16, 64, 64, 16, 16, 4)      /* table stem, 3-channel frames */        \
  X(64, 64, 64, 64, 8, 16, 3)      /* conv2; branch 2 blocks */              \
  X(32, 32, 32, 32, 16, 16, 4)     /* layer1 conv2; branch 1 blocks */       \
  X(16, 16, 16, 16, 16, 32, 4)     /* branch 0 blocks */                     \
  X(128, 128, 16, 16, 8, 16, 3)    /* transition1_0 */                       \
  X(128, 128, 128, 32, 8, 16, 2)   /* branch 3 blocks: 4 channel groups */
// 1x1: (CI, CO bucket, NB, TH, TW, WM, WN); the bucket is CO rounded up to 16, 32, 64 or 128.
#define UTTK_CONV1_TABLE(X)                                                  \
  X(64, 32, 32, 8, 16, 4, 2)    /* layer1 conv1; fuse 2 -> 1 */              \
  X(64, 128, 128, 8, 16, 2, 4)  /* layer1 downsample */                      \
  X(32, 128, 128, 8, 16, 2, 4)  /* layer1 conv3 + residual */                \
  X(32, 16, 16, 8, 32, 8, 1)    /* fuse 1 -> 0 */                            \
  X(64, 16, 16, 8, 32, 8, 1)    /* fuse 2 -> 0 */                            \
  X(128, 16, 16, 8, 16, 8, 1)   /* fuse 3 -> 0 */                            \
  X(128, 32, 32, 8, 16, 4, 2)   /* fuse 3 -> 1 */                            \
  X(128, 64, 64, 8, 16, 4, 2)   /* fuse 3 -> 2 */                            \
  X(16, 16, 16, 8, 32, 8, 1)    /* heads: Co = 3 (WASB) or 13 (table) */

int co_bucket(int co) {
  return co <= 16 ? 16 : co <= 32 ? 32 : co <= 64 ? 64 : co <= 128 ? 128 : 0;
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x (B, H, W, ci) bf16; w (round16(co), K) bf16, row n = output channel: for 3x3,
// K = 9 * max(ci, 16) with column (dy*3 + dx) * max(ci, 16) + c (channels beyond ci
// zero); for 1x1, K = round16(ci); bias (co) f32 or null; res (B, H, W, co) bf16 or
// null; out (B, H, W, co) bf16, aliasing neither x nor res. All contiguous and
// 16-byte aligned. (nb, th, tw, depth) is the launch plan: the ring depth (3x3) or
// the warps along M (1x1). Returns a cudaError_t code, or -1 (nothing launched) if
// the plan has no instantiation.
int uttk_fused_conv(const void* x, const void* w, const void* bias, const void* res, void* out,
                    int B, int H, int W, int ks, int ci, int co, int relu, int nb, int th, int tw,
                    int depth, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UTTK_LAUNCH3(ci_, cis, co_, nb_, th_, tw_, st_)                                        \
  if (ks == 3 && ci == ci_ && co == co_ && nb == nb_ && th == th_ && tw == tw_ && depth == st_) \
    return launch3<ci_, cis, nb_, th_, tw_, st_>(x, w, bias, res, out, B, H, W, co, relu, st);
  UTTK_CONV3_TABLE(UTTK_LAUNCH3)
#undef UTTK_LAUNCH3
#define UTTK_LAUNCH1(ci_, cb_, nb_, th_, tw_, wm, wn)                                      \
  if (ks == 1 && ci == ci_ && co_bucket(co) == cb_ && nb == nb_ && th == th_ && tw == tw_ && \
      depth == wm)                                                                         \
    return launch1<ci_, nb_, th_, tw_, wm, wn>(x, w, bias, res, out, B, H, W, co, relu, st);
  UTTK_CONV1_TABLE(UTTK_LAUNCH1)
#undef UTTK_LAUNCH1
  return -1;
}

// Dynamic shared memory of a block of the plan's instantiation, or -1 if it has none.
long long uttk_fused_conv_smem(int ks, int ci, int co, int nb, int th, int tw, int depth) {
#define UTTK_SMEM3(ci_, cis, co_, nb_, th_, tw_, st_)                                          \
  if (ks == 3 && ci == ci_ && co == co_ && nb == nb_ && th == th_ && tw == tw_ && depth == st_) \
    return Conv3<ci_, cis, nb_, th_, tw_, st_>::SMEM;
  UTTK_CONV3_TABLE(UTTK_SMEM3)
#undef UTTK_SMEM3
#define UTTK_SMEM1(ci_, cb_, nb_, th_, tw_, wm, wn)                                        \
  if (ks == 1 && ci == ci_ && co_bucket(co) == cb_ && nb == nb_ && th == th_ && tw == tw_ && \
      depth == wm)                                                                         \
    return Conv1<ci_, nb_, th_, tw_, wm, wn>::SMEM;
  UTTK_CONV1_TABLE(UTTK_SMEM1)
#undef UTTK_SMEM1
  return -1;
}

}  // extern "C"
