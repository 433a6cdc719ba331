// K4: depthwise 3x3 convolution, SAME zero padding, stride 1, NHWC bf16, for Hopper
// (sm_90a): the forward (+ bias) and its backward (dx, dw and db in one pass).
//
//   out[b, h, w, c] = bias[c] + sum_{i, j < 3} x[b, h + i - 1, w + j - 1, c] * k[i, j, c]
//   dx              = the same conv of the cotangent g with the taps flipped in both
//                     spatial axes, and no bias
//   dw[i, j, c]     = sum_{b, h, w} g[b, h, w, c] * x[b, h + i - 1, w + j - 1, c]
//   db[c]           = sum_{b, h, w} g[b, h, w, c]
//
// with x and g read as 0 outside the image. Replaces the Pallas TPU kernel
// upliftingtabletennis_tpu/ops/dwconv.py (`_dw_kernel`, launched by `_dw_pallas`) and
// the custom VJP's backward `_dw_bwd` there, which leaves dx, dw and db to XLA. In the
// SegFormer trainer the forward runs once in the backward of every MiTBlock's FFN half
// (K2's recompute) and the backward once after it.
//
// What bounds it: device memory. The forward moves 4 bytes per element (read x, write
// out) for 18 f32 operations; the backward 6 (read g and x, write dx) for 38. At b2's
// stage-1 hidden shape (4, 224, 400, 256) that is 0.110 and 0.164 ms at 3.35 TB/s.
//
// Design. A block owns a tile of TW = 8 output columns x CG channels x `th` rows
// (the launch plan's, `ops/dwconv.py:dwconv_plan`, tall enough that the two halo rows
// cost little) and walks down its rows. The input rows, with their one-pixel halo,
// stream through a ring of STAGES rows in shared memory by cp.async, STAGES - 1 rows
// ahead of the row being computed, so the loads of the next rows overlap the compute of
// this one; the halo outside the image and channels beyond C are zero-filled by the
// copy itself (a source size of 0), so no padded copy of x exists in device memory.
// Each thread owns V channels at one column, keeps its 9 taps in registers and converts
// each input row's three neighbouring vectors once. Three rolling accumulators hold the
// output rows the current input row feeds (it is tap row 0 of the next output row, tap
// row 1 of this one and tap row 2 of the previous one, which is then complete), so every
// output sums in f32 in the TPU kernel's order (bias, then the taps in row-major
// order) and is rounded once to bf16. The forward takes V = 4 (64 channels per tile);
// the backward V = 2 (32 channels), since each of its threads also carries 9 dw and one
// db accumulator per channel.
//
// The backward's ring holds a row of g and a row of x. The dx accumulators run as the
// forward's; for dw, the thread keeps the last three x rows (converted once) and, at
// each step, adds g's centre value of the row above times the 3 x 3 window of x around
// it, for the g rows its tile owns. The block then sums its threads' dw and db in a
// fixed order (a shuffle across the two columns of a warp, then the four warps in
// order) into one f32 partial per block, (10, C) in `partial`; a second launch sums the
// partials in a fixed order (a fixed stride per thread, then the slices in order). No
// float atomics: two calls on the same inputs give bit-identical dw and db.
//
// Any H and W (ragged tiles are masked) and any C % 8 == 0 (a tile's channels beyond C
// are zero-filled and masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TW = 8;               // output columns per tile (128-thread blocks: 4-5 per SM)
constexpr int NV = 16;              // channel vectors per pixel of a tile
constexpr int NTHREADS = TW * NV;   // one thread per (column, channel vector)
constexpr int HALO = TW + 2;        // input columns of a tile row
constexpr int STAGES = 8;           // input rows in the cp.async ring
constexpr int FWD_V = 4, BWD_V = 2;  // channels per thread
constexpr int PARTS = 10;           // dw's 9 taps and db, per channel
constexpr int RED_POS = 32, RED_SLICES = 8;  // the partials' sum: positions x slices

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V bf16 channels (V = 2 or 4, 4 or 8 bytes) -> f32
template <int V>
__device__ __forceinline__ void unpack(const bf16* p, float* f) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float* f) {
  if constexpr (V == 4) {
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(f[0], f[1]), __floats2bfloat162_rn(f[2], f[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(o);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  }
}

// The tile a block owns and the thread's place in it.
template <int V>
struct Tile {
  static constexpr int CG = V * NV;  // channels per tile
  int b, c0, h0, w0, rows, n_in, v, col, c;
  __device__ Tile(int H, int th, int tiles_w) {
    b = blockIdx.z;
    c0 = blockIdx.y * CG;
    h0 = (blockIdx.x / tiles_w) * th;
    w0 = (blockIdx.x % tiles_w) * TW;
    rows = min(th, H - h0);  // output rows of this tile
    n_in = rows + 2;         // input rows h0 - 1 ... h0 + rows
    v = threadIdx.x % NV;
    col = threadIdx.x / NV;
    c = c0 + v * V;
  }
};

// Copy input row t of the tile (image row h0 - 1 + t, with its halo columns) of each of
// the NSRC tensors into ring stage t % STAGES; zeros outside the image and beyond C.
template <int V, int NSRC>
__device__ __forceinline__ void load_row(bf16* ring, const bf16* const (&src)[NSRC],
                                         const Tile<V>& tl, int t, int H, int W, int C) {
  constexpr int CG = Tile<V>::CG, GRAN = CG / 8, PER_SRC = HALO * GRAN;
  if (t >= tl.n_in) return;
  const int h = tl.h0 - 1 + t;
  for (int i = threadIdx.x; i < NSRC * PER_SRC; i += NTHREADS) {
    const int s = i / PER_SRC, r = i % PER_SRC, pix = r / GRAN, gi = r % GRAN;
    const int w = tl.w0 - 1 + pix, c = tl.c0 + gi * 8;
    const bool ok = h >= 0 && h < H && w >= 0 && w < W && c < C;
    const bf16* p = src[s] + (ok ? (static_cast<size_t>(h) * W + w) * C + c : 0);
    cp_async16(ring + ((t % STAGES) * NSRC + s) * HALO * CG + pix * CG + gi * 8, p, ok);
  }
}

// Start the copies of the first STAGES - 1 input rows, one row per group.
template <int V, int NSRC>
__device__ __forceinline__ void first_rows(bf16* ring, const bf16* const (&src)[NSRC],
                                           const Tile<V>& tl, int H, int W, int C) {
#pragma unroll 1
  for (int t = 0; t < STAGES - 1; ++t) {
    load_row<V, NSRC>(ring, src, tl, t, H, W, C);
    cp_async_commit();
  }
}

// Wait for input row t, free the stage row t - 1 used, start the copy of row
// t + STAGES - 1 into it, and return row t at this thread's column and channels in
// tensor 0 (the vectors of columns col - 1, col, col + 1 lie CG apart).
template <int V, int NSRC>
__device__ __forceinline__ const bf16* next_row(bf16* ring, const bf16* const (&src)[NSRC],
                                                const Tile<V>& tl, int t, int H, int W,
                                                int C) {
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // row t landed for every thread; every thread is done with row t - 1
  load_row<V, NSRC>(ring, src, tl, t + STAGES - 1, H, W, C);
  cp_async_commit();
  return ring + (t % STAGES) * NSRC * HALO * Tile<V>::CG + tl.col * Tile<V>::CG + tl.v * V;
}

template <int V>
__device__ __forceinline__ void load_taps(const bf16* k, int C, int c, float (&taps)[9][V]) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (c < C)
      unpack<V>(k + static_cast<size_t>(t) * C + c, taps[t]);
    else
#pragma unroll
      for (int e = 0; e < V; ++e) taps[t][e] = 0.f;
  }
}

// One input row's part of the conv: `in` holds its three vectors (columns col - 1, col,
// col + 1 of the output). Output row t (slot S) starts with `init` and tap row 0; row
// t - 1 (slot S + 2) takes tap row 1; row t - 2 (slot S + 1) takes tap row 2 and is done.
template <int S, int V>
__device__ __forceinline__ void conv_step(float (&acc)[3][V], const float (&in)[3][V],
                                          const float (&taps)[9][V], const float* init) {
  constexpr int S1 = (S + 2) % 3, S2 = (S + 1) % 3;
#pragma unroll
  for (int e = 0; e < V; ++e) acc[S][e] = init[e];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[S][e] += in[j][e] * taps[j][e];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[S1][e] += in[j][e] * taps[3 + j][e];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[S2][e] += in[j][e] * taps[6 + j][e];
}

__global__ void __launch_bounds__(NTHREADS) dw_fwd_kernel(const bf16* __restrict__ x,
                                                          const bf16* __restrict__ k,
                                                          const bf16* __restrict__ bias,
                                                          bf16* __restrict__ out, int H, int W,
                                                          int C, int th, int tiles_w) {
  constexpr int V = FWD_V, CG = Tile<V>::CG;
  __shared__ __align__(16) bf16 ring[STAGES * HALO * CG];
  const Tile<V> tl(H, th, tiles_w);
  const size_t plane = static_cast<size_t>(H) * W * C;
  const bf16* const src[1] = {x + tl.b * plane};
  first_rows<V, 1>(ring, src, tl, H, W, C);
  float taps[9][V], b0[V], acc[3][V] = {}, in[3][V];
  load_taps<V>(k, C, tl.c, taps);
#pragma unroll
  for (int e = 0; e < V; ++e) b0[e] = tl.c < C ? __bfloat162float(bias[tl.c + e]) : 0.f;
  const bool active = tl.c < C && tl.w0 + tl.col < W;
  bf16* dst = out + tl.b * plane + (static_cast<size_t>(tl.h0) * W + tl.w0 + tl.col) * C + tl.c;
  const size_t row_stride = static_cast<size_t>(W) * C;

  auto step = [&](auto slot, int t) {
    constexpr int S = decltype(slot)::value;
    const bf16* row = next_row<V, 1>(ring, src, tl, t, H, W, C);
#pragma unroll
    for (int j = 0; j < 3; ++j) unpack<V>(row + j * CG, in[j]);
    conv_step<S, V>(acc, in, taps, b0);
    if (t >= 2 && active) store<V>(dst + (t - 2) * row_stride, acc[(S + 1) % 3]);
  };
#pragma unroll 1
  for (int t = 0; t < tl.n_in; t += 3) {  // three steps per trip: the slots stay static
    step(std::integral_constant<int, 0>(), t);
    if (t + 1 < tl.n_in) step(std::integral_constant<int, 1>(), t + 1);
    if (t + 2 < tl.n_in) step(std::integral_constant<int, 2>(), t + 2);
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(NTHREADS) dw_bwd_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ x, const bf16* __restrict__ kdx,
    bf16* __restrict__ dx, float* __restrict__ partial, int H, int W, int C, int th,
    int tiles_w) {
  constexpr int V = BWD_V, CG = Tile<V>::CG;
  constexpr int SRC_G = 0, SRC_X = 1;
  __shared__ __align__(16) bf16 ring[STAGES * 2 * HALO * CG];
  const Tile<V> tl(H, th, tiles_w);
  const size_t plane = static_cast<size_t>(H) * W * C;
  const bf16* const src[2] = {g + tl.b * plane, x + tl.b * plane};
  first_rows<V, 2>(ring, src, tl, H, W, C);
  float taps[9][V], acc[3][V] = {}, gin[3][V];
  float xw[3][3][V] = {};  // the last three x rows (slot t % 3), their three columns
  float gprev[V] = {};     // g's centre value of the row above, where this tile owns it
  float dw[9][V] = {}, db[V] = {};
  const float zero[V] = {};
  load_taps<V>(kdx, C, tl.c, taps);
  const bool active = tl.c < C && tl.w0 + tl.col < W;
  bf16* dst = dx + tl.b * plane + (static_cast<size_t>(tl.h0) * W + tl.w0 + tl.col) * C + tl.c;
  const size_t row_stride = static_cast<size_t>(W) * C;

  // Step t: input row t of g and x (image row h0 - 1 + t). dx as the forward; then the
  // g row above it (row t - 1, owned when 1 <= t - 1 <= rows: else gprev is 0) times the
  // x rows t - 2, t - 1, t (tap rows 0, 1, 2) at columns col - 1, col, col + 1.
  auto step = [&](auto slot, int t) {
    constexpr int S = decltype(slot)::value;
    const bf16* row = next_row<V, 2>(ring, src, tl, t, H, W, C);
    const bf16* grow = row + SRC_G * HALO * CG;
    const bf16* xrow = row + SRC_X * HALO * CG;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      unpack<V>(grow + j * CG, gin[j]);
      unpack<V>(xrow + j * CG, xw[S][j]);
    }
    conv_step<S, V>(acc, gin, taps, zero);
    if (t >= 2 && active) store<V>(dst + (t - 2) * row_stride, acc[(S + 1) % 3]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) dw[3 * i + j][e] += gprev[e] * xw[(S + 1 + i) % 3][j][e];
    const bool owned = t >= 1 && t <= tl.rows;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      db[e] += gprev[e];
      gprev[e] = owned ? gin[1][e] : 0.f;
    }
  };
#pragma unroll 1
  for (int t = 0; t < tl.n_in; t += 3) {
    step(std::integral_constant<int, 0>(), t);
    if (t + 1 < tl.n_in) step(std::integral_constant<int, 1>(), t + 1);
    if (t + 2 < tl.n_in) step(std::integral_constant<int, 2>(), t + 2);
  }

  // The block's dw and db, in a fixed order: the warp's two columns (lanes l and l ^ 16
  // hold the same channels), then the four warps in order. Out-of-image columns and
  // channels beyond C hold zeros (the ring's zero fill).
  static_assert(sizeof(ring) >= NTHREADS / 32 * PARTS * CG * sizeof(float),
                "the warps' sums must fit in the ring");
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring; it becomes the warps' sums
  float* red = reinterpret_cast<float*>(ring);  // [warp][PARTS][CG]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float s = p < 9 ? dw[p][e] : db[e];
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 16) red[(warp * PARTS + p) * CG + lane * V + e] = s;
    }
  }
  __syncthreads();
  float* out = partial + (static_cast<size_t>(tl.b) * gridDim.x + blockIdx.x) * PARTS * C;
  for (int i = threadIdx.x; i < PARTS * CG; i += NTHREADS) {
    const int p = i / CG, ch = i % CG;
    if (tl.c0 + ch >= C) continue;
    float s = red[p * CG + ch];
#pragma unroll
    for (int w = 1; w < NTHREADS / 32; ++w) s += red[(w * PARTS + p) * CG + ch];
    out[static_cast<size_t>(p) * C + tl.c0 + ch] = s;
  }
}

// sums[i] = sum over the n_partials rows of partial (n_partials, n) at column i: thread
// slice s sums rows s, s + 8, ... in order, then slice 0 adds the eight slices in order.
__global__ void __launch_bounds__(RED_POS* RED_SLICES) dw_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ sums, int n_partials, int n) {
  __shared__ float red[RED_SLICES][RED_POS];
  const int s = threadIdx.x / RED_POS, lane = threadIdx.x % RED_POS;
  const int i = blockIdx.x * RED_POS + lane;
  float acc = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int p = s; p < n_partials; p += RED_SLICES) acc += partial[static_cast<size_t>(p) * n + i];
  }
  red[s][lane] = acc;
  __syncthreads();
  if (s == 0 && i < n) {
    float t = red[0][lane];
#pragma unroll
    for (int k = 1; k < RED_SLICES; ++k) t += red[k][lane];
    sums[i] = t;
  }
}

// Whether the launch plan (ops/dwconv.py:dwconv_plan) is one for these tiles: `tiles`
// tiles of `size` cover n once.
bool covers(int n, int tiles, int size) {
  return tiles >= 1 && (tiles - 1) * size < n && n <= tiles * size;
}

bool bad_launch(int B, int H, int W, int C, int th, int tiles_w, int tiles_h, int groups,
                int cg) {
  return C % 8 || B < 1 || B > 65535 || groups > 65535 || !covers(W, tiles_w, TW) ||
         !covers(H, tiles_h, th) || !covers(C, groups, cg);
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x, out (B, H, W, C); k (3, 3, C) with tap index 3*i + j; bias (C). All bf16, contiguous,
// 16-byte aligned; C % 8 == 0. The launch plan: th output rows per tile, tiles_w x tiles_h
// tiles per image and `groups` channel groups; a plan that is not one for this kernel's
// tiles is refused. Returns a cudaError_t code (0 on success).
int uttk_dwconv3x3(const void* x, const void* k, const void* bias, void* out, int B, int H,
                   int W, int C, int th, int tiles_w, int tiles_h, int groups, void* stream) {
  if (bad_launch(B, H, W, C, th, tiles_w, tiles_h, groups, FWD_V * NV))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles_w * tiles_h, groups, B);
  dw_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), H, W, C, th, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// The backward: g, x, dx (B, H, W, C) bf16; kdx (3, 3, C) bf16, the taps of dx's conv (the
// forward's flipped in both spatial axes); partial (n_partials, 10, C) f32 scratch with
// n_partials = B * tiles_h * tiles_w; sums (10, C) f32: dw's 9 taps, then db. The plan as
// the forward's. Two launches: the fused pass, then the fixed-order sum of the partials.
int uttk_dwconv3x3_backward(const void* g, const void* x, const void* kdx, void* dx,
                            void* partial, void* sums, int B, int H, int W, int C, int th,
                            int tiles_w, int tiles_h, int groups, int n_partials,
                            void* stream) {
  if (bad_launch(B, H, W, C, th, tiles_w, tiles_h, groups, BWD_V * NV) ||
      n_partials != B * tiles_w * tiles_h)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dw_bwd_kernel<<<dim3(tiles_w * tiles_h, groups, B), NTHREADS, 0, st>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(x), static_cast<const bf16*>(kdx),
      static_cast<bf16*>(dx), static_cast<float*>(partial), H, W, C, th, tiles_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = PARTS * C;
  dw_sum_kernel<<<(n + RED_POS - 1) / RED_POS, RED_POS * RED_SLICES, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), n_partials, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
