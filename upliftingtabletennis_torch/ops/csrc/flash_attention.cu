// K3: flash cross-attention for Hopper (sm_90a).
//
//   out[b, n, h] = softmax_m(q[b, n, h] . k[b, m, h] * scale) . v[b, :, h]
//
// f32 logits and softmax, f32 accumulation, bf16 in and out. Replaces the
// Pallas TPU kernel upliftingtabletennis_tpu/ops/flash_attention.py
// (`_flash_kernel`, called from `flash_cross_attention`), which the
// SegFormer block runs when ToMe merges the queries: many queries (up to
// 53,760 per frame at b2 stage 1, 1600x896) against few keys (Nkv <= ~2,040).
//
// What bounds it: the QK^T and PV products (4 * Nq * Nkv * hd operations per
// (sample, head)) and the Nq * Nkv exponentials; q is read once and the
// output written once, so the bytes are far below the operations. Only the
// warpgroup products (wgmma) reach the tensor cores' full rate.
//
// Design (the FlashAttention-3 arrangement, hopper.cuh's primitives):
//   - a persistent block per SM walks over tiles of (128 query rows, head,
//     sample): two consumer warpgroups own 64 rows each, one producer warp (a
//     third warpgroup, its registers lowered with setmaxnreg and given to the
//     consumers) keeps TMA loads in flight;
//   - TMA reads the (B, N, h, hd) layout directly through 4-D tensor maps
//     (hd, h, N, B): each tile's q into one of two buffers (the next tile's q
//     loads while this one runs), K and V in chunks of BN = 128 keys through a
//     ring of STAGES stages with full / empty mbarriers that runs on from one
//     tile to the next. Boxes that reach beyond Nq or Nkv read zeros, never the
//     next sample. Tiles are stored with TMA's swizzle of one row (128 B at
//     hd = 64, 64 B at hd = 32), which the wgmma descriptors name;
//   - S = q K^T: wgmma m64n128k16, both operands from shared memory, K stored
//     [key][dim] (K-major). The logits stay in registers: online softmax in
//     base 2 with the scale folded into one FFMA and one ex2.approx.ftz per
//     logit; keys beyond Nkv are set to -inf in the last chunk only;
//   - O += P V: wgmma m64n{hd}k16 with P repacked from the S accumulators as
//     the register A operand (bf16, as the plain version rounds the weights)
//     and V read from its [key][dim] tile as a transposed (N-major) B;
//   - overlap inside a warpgroup: the products S of chunk c + 1 and O += P_c V_c
//     are issued together, and the softmax of chunk c + 1 runs while
//     O += P_c V_c is on the tensor cores; across the two: they take turns to
//     issue their products (named barriers), so one's softmax runs under the
//     other's products;
//   - epilogue: O / l rounded to bf16 is staged in the warpgroup's output tile,
//     swizzled as TMA reads it, and written by a TMA store, which clips at Nq;
//     the store drains while the next tile runs.
#include <cmath>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

constexpr int BM = 128;      // query rows per block
constexpr int BN = 128;      // keys per K/V chunk
constexpr int STAGES = 4;    // K/V ring depth
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int NTHREADS = CONSUMERS + 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int ROW = 2 * HD;  // bytes per row of a tile, and its swizzle
  static constexpr int Q = BM * ROW, KV = BN * ROW, O = 64 * ROW;
  // two q buffers, the K and V rings, one output tile per consumer warpgroup; barriers
  static constexpr int KRING = 2 * Q, VRING = KRING + STAGES * KV, OUT = VRING + STAGES * KV;
  static constexpr int BARS = OUT + 2 * O;  // q_full[2], q_empty[2], k_full[], v_full[], empty[]
  static constexpr int BYTES = 1024 + BARS + 8 * (4 + 3 * STAGES);  // + 1024 to align the base
  static_assert(ROW == 64 || ROW == 128, "hd is 32 or 64");
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, int Nq, int Nkv, int heads,
                       int B, float scale2) {
  using S = Smem<HD>;
  constexpr int ROW = S::ROW;
  constexpr uint32_t LAYOUT = uttk::swizzle_layout(ROW);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = uttk::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic address
  auto q_s = [&](int qb) { return base + qb * S::Q; };
  auto k_s = [&](int s) { return base + S::KRING + s * S::KV; };
  auto v_s = [&](int s) { return base + S::VRING + s * S::KV; };
  const uint32_t bars = base + S::BARS;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + 2 * STAGES + s); };

  // persistent: this block takes tiles blockIdx.x, + gridDim.x, ...; a tile is (128 query
  // rows, head, sample), the rows fastest, so that neighbouring blocks share K/V in L2
  const int n_mt = (Nq + BM - 1) / BM, ntiles = n_mt * heads * B;
  const int nch = (Nkv + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      uttk::mbar_init(q_full(qb), 1);
      uttk::mbar_init(q_empty(qb), 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      uttk::mbar_init(k_full(s), 1);
      uttk::mbar_init(v_full(s), 1);
      uttk::mbar_init(empty(s), 2);
    }
    uttk::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every load
    uttk::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      int kv = 0;  // chunks loaded so far, over all of this block's tiles
      for (int tile = blockIdx.x, i = 0; tile < ntiles; tile += gridDim.x, ++i) {
        const int m0 = (tile % n_mt) * BM, h = (tile / n_mt) % heads, b = tile / (n_mt * heads);
        const int qb = i & 1;
        if (i >= 2) uttk::mbar_wait(q_empty(qb), ((i >> 1) - 1) & 1);
        uttk::mbar_expect_tx(q_full(qb), S::Q);
        uttk::tma_load_4d(q_s(qb), &qmap, q_full(qb), 0, h, m0, b);
        for (int c = 0; c < nch; ++c, ++kv) {
          const int s = kv % STAGES;
          if (kv >= STAGES) uttk::mbar_wait(empty(s), ((kv / STAGES) - 1) & 1);
          uttk::mbar_expect_tx(k_full(s), S::KV);
          uttk::tma_load_4d(k_s(s), &kmap, k_full(s), 0, h, c * BN, b);
          uttk::mbar_expect_tx(v_full(s), S::KV);
          uttk::tma_load_4d(v_s(s), &vmap, v_full(s), 0, h, c * BN, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows 64 wg .. + 63 of each tile
    uttk::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
    const bool leader = (threadIdx.x & 127) == 0;
    float o[HD / 2];
    float m_lo, m_hi;  // running max of rows g and g + 8 (base 2)
    float l_lo, l_hi;  // this thread's part of the running sums
    float sacc[BN / 2];                        // logits, then probabilities, of one chunk
    uint32_t pa[BN / 16][4];                   // the probabilities as PV's A fragments
    uint32_t q_wg = 0;                         // this warpgroup's rows of the tile's q
    int kv0 = 0;                               // chunks consumed before this tile

    // Each product is fenced as CUTLASS fences its accumulators: no instruction of the
    // thread touches them between the issue and the commit.
    auto issue_s = [&](int c) {  // S = q K_c^T, asynchronous
      const int s = (kv0 + c) % STAGES;
      uttk::mbar_wait(k_full(s), ((kv0 + c) / STAGES) & 1);
      uttk::fence_operands(sacc);
      uttk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        uttk::wgmma_ss_n128(sacc, uttk::wgmma_desc(q_wg + 32 * kk, 16, 8 * ROW, LAYOUT),
                            uttk::wgmma_desc(k_s(s) + 32 * kk, 16, 8 * ROW, LAYOUT), kk > 0);
      uttk::wgmma_commit();
      uttk::fence_operands(sacc);
    };
    // online softmax of chunk c's logits in place, keys beyond Nkv -> -inf. Base 2 with
    // the scale folded in: p = 2^(s * scale2 - m), m the running max of s * scale2 (scale2
    // > 0, so that is scale2 times the max of s); the maxima and sums run in four chains
    // per row. Returns the factors that rescale the rows' earlier sums.
    auto softmax = [&](int c, float& a_lo, float& a_hi) {
      if (c == nch - 1 && c * BN + BN > Nkv) {  // the last chunk: keys beyond Nkv
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int key = c * BN + 8 * j + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (key + (i & 1) >= Nkv) sacc[4 * j + i] = -INFINITY;
        }
      }
      float mx[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[0][k] = mx[1][k] = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0][j & 3] = fmaxf(mx[0][j & 3], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1][j & 3] = fmaxf(mx[1][j & 3], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      // every chunk holds at least one valid key, so the new max is finite
      const float r_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
      const float r_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
      const float mn_lo = fmaxf(m_lo, scale2 * uttk::quad_max(r_lo));
      const float mn_hi = fmaxf(m_hi, scale2 * uttk::quad_max(r_hi));
      a_lo = uttk::exp2_ftz(m_lo - mn_lo);
      a_hi = uttk::exp2_ftz(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum[2][4] = {};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sacc[4 * j] = uttk::exp2_ftz(fmaf(sacc[4 * j], scale2, -mn_lo));
        sacc[4 * j + 1] = uttk::exp2_ftz(fmaf(sacc[4 * j + 1], scale2, -mn_lo));
        sacc[4 * j + 2] = uttk::exp2_ftz(fmaf(sacc[4 * j + 2], scale2, -mn_hi));
        sacc[4 * j + 3] = uttk::exp2_ftz(fmaf(sacc[4 * j + 3], scale2, -mn_hi));
        sum[0][j & 3] += sacc[4 * j] + sacc[4 * j + 1];
        sum[1][j & 3] += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      l_lo = l_lo * a_lo + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
      l_hi = l_hi * a_hi + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
    };
    // keys 16 kk .. 16 kk + 15 are the A fragment of step kk: n8 blocks 2 kk and 2 kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = uttk::pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = uttk::pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
    };
    auto issue_pv = [&](int c) {  // O += P_c V_c, asynchronous
      const int s = (kv0 + c) % STAGES;
      uttk::mbar_wait(v_full(s), ((kv0 + c) / STAGES) & 1);
      uttk::fence_operands(o);
      uttk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        uttk::wgmma_rs<HD, 1>(
            o, pa[kk], uttk::wgmma_desc(v_s(s) + kk * 16 * ROW, BN * ROW, 8 * ROW, LAYOUT), 1);
      uttk::wgmma_commit();
      uttk::fence_operands(o);
    };

    // Chunk c: S of chunk c + 1 and O += P_c V_c go to the tensor cores together; the
    // softmax of chunk c + 1 runs while O += P_c V_c is in flight; then O is rescaled.
    // (The last chunk is peeled so that every wait covers the same groups on every path.)
    // The two warpgroups take turns to issue their products (named barriers 3 and 4, a
    // ping-pong), so one's softmax runs while the other's products hold the tensor cores.
    const int mine = 3 + wg, other = 4 - wg;
    if (wg == 1) uttk::named_bar_arrive(other, CONSUMERS);  // warpgroup 0 issues first
    unsigned char* out_g = gbase + S::OUT + wg * S::O;
    for (int tile = blockIdx.x, i = 0; tile < ntiles; tile += gridDim.x, ++i) {
      const int m0 = (tile % n_mt) * BM, h = (tile / n_mt) % heads, b = tile / (n_mt * heads);
      const int qb = i & 1;
      q_wg = q_s(qb) + wg * 64 * ROW;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
      m_lo = m_hi = -INFINITY;
      l_lo = l_hi = 0.f;
      float a_lo, a_hi;
      uttk::mbar_wait(q_full(qb), (i >> 1) & 1);
      issue_s(0);
      uttk::wgmma_wait<0>();
      uttk::fence_operands(sacc);
      softmax(0, a_lo, a_hi);
      pack_p();
      for (int c = 0; c + 1 < nch; ++c) {
        uttk::named_bar_sync(mine, CONSUMERS);
        issue_s(c + 1);
        issue_pv(c);
        uttk::named_bar_arrive(other, CONSUMERS);
        uttk::wgmma_wait<1>();  // S of chunk c + 1 has landed
        uttk::fence_operands(sacc);
        softmax(c + 1, a_lo, a_hi);
        uttk::wgmma_wait<0>();  // O += P_c V_c is done: its stage goes back to the producer
        uttk::fence_operands(o);
        if (leader) uttk::mbar_arrive(empty((kv0 + c) % STAGES));
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= a_lo;
          o[4 * j + 1] *= a_lo;
          o[4 * j + 2] *= a_hi;
          o[4 * j + 3] *= a_hi;
        }
        pack_p();
      }
      uttk::named_bar_sync(mine, CONSUMERS);
      issue_pv(nch - 1);
      uttk::named_bar_arrive(other, CONSUMERS);
      uttk::wgmma_wait<0>();
      uttk::fence_operands(o);
      if (leader) {  // the tile's q and last stage go back to the producer
        uttk::mbar_arrive(empty((kv0 + nch - 1) % STAGES));
        uttk::mbar_arrive(q_empty(qb));
      }
      kv0 += nch;

      // normalise; stage this warpgroup's rows (bf16, swizzled as TMA reads them), once the
      // previous tile's store has read the staging tile; TMA store, which clips at Nq
      const float inv_lo = 1.f / uttk::quad_sum(l_lo), inv_hi = 1.f / uttk::quad_sum(l_hi);
      if (leader) uttk::bulk_wait_read();
      uttk::named_bar_sync(1 + wg, 128);
      const int r = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const uint32_t col = 2 * (8 * j + 2 * t);
        *reinterpret_cast<uint32_t*>(out_g + uttk::swizzle<ROW>(r * ROW + col)) =
            uttk::pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
        *reinterpret_cast<uint32_t*>(out_g + uttk::swizzle<ROW>((r + 8) * ROW + col)) =
            uttk::pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
      }
      uttk::fence_proxy_async();
      uttk::named_bar_sync(1 + wg, 128);
      if (leader) {
        uttk::tma_store_4d(&omap, base + S::OUT + wg * S::O, 0, h, m0 + 64 * wg, b);
        uttk::bulk_commit();
      }
    }
    if (wg == 0) uttk::named_bar_sync(mine, CONSUMERS);  // warpgroup 1's last turn
    if (leader) uttk::bulk_wait();
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Nq, int Nkv,
           int heads, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<HD>;
  constexpr int smem = Smem<HD>::BYTES;
  uttk_host::Occupancy occ;
  int err = uttk_host::prepare<flash_attention_kernel<HD>>(smem, NTHREADS, &occ);
  if (err != 0) return err;
  const uint64_t tok = 2ull * heads * HD;  // bytes from one token to the next
  const uint64_t dq[4] = {HD, (uint64_t)heads, (uint64_t)Nq, (uint64_t)B};
  const uint64_t dk[4] = {HD, (uint64_t)heads, (uint64_t)Nkv, (uint64_t)B};
  const uint64_t sq[3] = {2ull * HD, tok, tok * Nq}, sk[3] = {2ull * HD, tok, tok * Nkv};
  const uint32_t bq[4] = {HD, 1, BM, 1}, bk[4] = {HD, 1, BN, 1}, bo[4] = {HD, 1, 64, 1};
  CUtensorMap qm, km, vm, om;
  if ((err = uttk_host::tensor_map_4d(&qm, q, dq, sq, bq, 2 * HD)) != 0) return err;
  if ((err = uttk_host::tensor_map_4d(&km, k, dk, sk, bk, 2 * HD)) != 0) return err;
  if ((err = uttk_host::tensor_map_4d(&vm, v, dk, sk, bk, 2 * HD)) != 0) return err;
  if ((err = uttk_host::tensor_map_4d(&om, out, dq, sq, bo, 2 * HD)) != 0) return err;
  const long long ntiles = (long long)((Nq + BM - 1) / BM) * heads * B;
  const long long cap = (long long)occ.blocks_per_sm * occ.sms;
  const dim3 grid(static_cast<unsigned>(ntiles < cap ? ntiles : cap));
  kernel<<<grid, NTHREADS, smem, stream>>>(qm, km, vm, om, Nq, Nkv, heads, B, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q, out (B, Nq, heads, hd); k, v (B, Nkv, heads, hd). All bf16, contiguous,
// 16-byte aligned. hd is 32 or 64; Nq >= 1, Nkv >= 1, B * heads * ceil(Nq / 128) < 2^31;
// scale > 0.
// Returns a cudaError_t code (0 on success).
int uttk_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Nq,
                         int Nkv, int heads, int hd, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nq < 1 || Nkv < 1 || B < 1 || heads < 1 || !(scale > 0.f) ||
      (long long)((Nq + BM - 1) / BM) * heads * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, Nq, Nkv, heads, scale, st);
    case 64: return launch<64>(q, k, v, out, B, Nq, Nkv, heads, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
