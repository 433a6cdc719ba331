// K1: fused SegFormer attention half-block for Hopper (sm_90a), kernel bodies.
//
//   out = x + concat_h softmax(q_h k_h^T / sqrt(hd)) v_h . Wp + bp,
//   q = LN(x) . Wq + bq          (LN eps given, f32; logits/softmax in f32)
//
// Replaces the Pallas TPU kernel upliftingtabletennis_tpu/ops/fused_attention.py
// (`_kernel`, called from `fused_attention_block`). K/V arrive already
// projected (the sr-conv, its LayerNorm and the kv projection stay torch
// ops, as they are XLA ops in the JAX model). `fused_attention.cu` exports
// the production entry point (MODE 0); `fused_attention_probe.cu` exports
// the phase-probe variants (the TPU probe tools/probe_attn_phases.py):
// MODE 1 replaces the softmax by w = logits / Nkv (no max, no exp); the
// probe's no_ln skips the LayerNorm launch and attends from x itself. Both
// compute the wrong function on purpose and exist only to be timed against
// the production path.
//
// What bounds it (b2 ball shapes, Nkv = 1400, hd = 64): the operations. At
// stage 1 (C = 64, one head) the QK^T and PV products need 0.136 ms of
// tensor-core time per batch of 4 and the B * N * Nkv exponentials 0.12 ms
// of the SFU (16 results per clock per SM), so both units bound it and the
// design spends one exp2 per logit, nothing more. At stages 2-4 the tensor
// cores bound it (the projections add 4 * N * C^2). x is read about twice,
// O once, out written once: bytes stay below the operations.
//
// Design (two or three launches per call, one launch count):
//   1. ln_kernel (tiles.cuh): y = LN(x) in bf16, where the plain version
//      rounds it, once per row (the heads' blocks would otherwise each
//      normalise the same rows again).
//   2. attn_kernel: one block of 8 warps per (128 query rows, head, sample),
//      each warp owning 16 rows, two blocks per SM: 352 blocks at b2's stage 4
//      (N = 1400, 8 heads, batch 4), 2,800 at stage 1. Every block streams its
//      head's whole K/V from L2 (1 GB per call at stage 1); blocks of 256 rows
//      halve that but measured 5-18% slower at every b2 stage, and warps of 32
//      rows (two tiles sharing each K/V fragment, half the ldmatrix traffic)
//      measured the same as these (PERF.md): the products and the
//      softmax of a chunk run one after the other in each warp.
//      a. q_h = y . Wq_h^T + bq_h: y and the head's Wq rows stream in
//         64-channel chunks through a 2-stage cp.async ring into shared
//         memory, staged once per block and shared by its 8 warps; ldmatrix
//         + mma.sync. q never leaves registers: the f32 accumulators + bq
//         are rounded to bf16 and repacked as the A fragments of q_h . K^T.
//      b. Online softmax (base 2, one exp2 per logit as a single MUFU.EX2 with
//         denormal results flushed, the scale folded into its argument) over 64-key chunks of K/V that stream through a
//         3-stage cp.async ring issued at the kernel's start: two chunks are
//         in flight while one is multiplied. K loads with ldmatrix, V with
//         ldmatrix.trans (no transposing copy). Keys beyond Nkv read as zeros
//         and, in the last chunk only, their logits are -inf.
//      c. O_h = P V / l rounded to bf16 (where the plain version rounds the
//         head outputs) into the scratch O (B, N, C), columns h*hd.
//   3. The out-projection x + O . Wp^T + bp: gemm_kernel (tiles.cuh), 128 x
//      128 tiles, the residual in its epilogue.
//   The out-projection needs every head's O. With one head (b2's and b0's
//   stage 1, where N is largest) the attention kernel applies it to its own
//   rows from O in registers, Wp staged in the freed Wq ring: no O in
//   device memory and no third launch. With several heads a second kernel
//   costs one write and one read of O (B * N * C bf16: 2 x 11.5 MB at b2's
//   stage 2, batch 4, about 7 us of device-memory time) and a launch; a
//   thread-block cluster of the heads' blocks reducing through distributed
//   shared memory would save that, but it was not built (PERF.md).
// Products are mma.sync.m16n8k16 from shared memory; wgmma is left to a
// later PR.
#pragma once

#include <cmath>

#include "tiles.cuh"

namespace uttk {
namespace k1 {

constexpr int BKV = 64;       // keys per K/V chunk
constexpr int KV_STAGES = 3;  // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
enum Mode { FULL = 0, NO_SOFTMAX = 1 };

constexpr size_t attn_smem(int hd) {
  return sizeof(bf16) * (2 * (size_t)(BM + hd) * LDK + KV_STAGES * 2 * (size_t)BKV * (hd + PAD));
}

// y (B, N, C) = LN(x); o (B, N, C) the head outputs. grid (ceil(N / BM), heads, B).
// PROJ (one head, C == HD): the block also applies the out-projection to its
// rows, out = x + O . Wp^T + bp, with O in registers (no O, no second kernel);
// Wp is staged in the Wq ring once the q-projection is done.
template <int HD, int MODE, bool PROJ>
__global__ void __launch_bounds__(NTHREADS, 2)
attn_kernel(const bf16* __restrict__ y, const bf16* __restrict__ wq,
            const bf16* __restrict__ bq, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, const bf16* __restrict__ x,
            const bf16* __restrict__ wp, const bf16* __restrict__ bp, bf16* __restrict__ out,
            int N, int C, int heads, int Nkv, float scale) {
  constexpr int LDH = HD + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);  // 2 x BM x LDK: chunks of y
  bf16* ws = ys + 2 * BM * LDK;               // 2 x HD x LDK: chunks of Wq_h
  bf16* ks = ws + 2 * HD * LDK;               // KV_STAGES x BKV x LDH: K chunks, [key][dim]
  bf16* vs = ks + KV_STAGES * BKV * LDH;      // KV_STAGES x BKV x LDH: V chunks, [key][dim]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row0 = (long long)blockIdx.x * BM;
  const bf16* yb = y + (size_t)b * N * C;
  const bf16* wqh = wq + (size_t)h * HD * C;  // rows h*HD.. of Wq (C_out, C_in)
  const size_t ld = (size_t)heads * HD;       // elements from one token to the next in K/V
  const bf16* kb = k + (size_t)b * Nkv * ld + h * HD;
  const bf16* vb = v + (size_t)b * Nkv * ld + h * HD;

  auto load_kv = [&](int c) {  // K/V chunk c into its ring stage
    const int st = c % KV_STAGES;
    for (int e = threadIdx.x; e < BKV * (HD / 8); e += NTHREADS) {
      const int j = e / (HD / 8), c8 = (e % (HD / 8)) * 8;
      const int key = c * BKV + j;
      const bool valid = key < Nkv;
      const size_t off = (size_t)(valid ? key : 0) * ld + c8;
      cp_async16(ks + st * BKV * LDH + j * LDH + c8, kb + off, valid);
      cp_async16(vs + st * BKV * LDH + j * LDH + c8, vb + off, valid);
    }
  };
  const int nkc = (C + KC - 1) / KC, nch = (Nkv + BKV - 1) / BKV;
#pragma unroll
  for (int c = 0; c < KV_STAGES - 1; ++c) {
    if (c < nch) load_kv(c);
    cp_async_commit();
  }
  load_chunk(ys, yb, row0, BM, N, C, 0);
  load_chunk(ws, wqh, 0, HD, HD, C, 0);
  cp_async_commit();

  // a: q_h = y . Wq_h^T for this warp's 16 rows, in f32 accumulators
  float qacc[1][HD / 8][4];
  zero_acc(qacc);
  for (int kc = 0; kc < nkc; ++kc) {
    const int st = kc & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk kc landed everywhere; chunk kc - 1's stage is free
    if (kc + 1 < nkc) {
      load_chunk(ys + (st ^ 1) * BM * LDK, yb, row0, BM, N, C, (kc + 1) * KC);
      load_chunk(ws + (st ^ 1) * HD * LDK, wqh, 0, HD, HD, C, (kc + 1) * KC);
    }
    cp_async_commit();
    warp_mma<1, HD / 8, KC / 16>(qacc, ys + st * BM * LDK + warp * 16 * LDK, LDK,
                                 ws + st * HD * LDK, LDK);
  }
  // + bq, rounded to bf16, repacked as the A fragments of q_h . K^T
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const float2 b0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(bq + h * HD + kk * 16 + 2 * t));
    const float2 b1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(bq + h * HD + kk * 16 + 8 + 2 * t));
    qa[kk][0] = pack_bf16(qacc[0][2 * kk][0] + b0.x, qacc[0][2 * kk][1] + b0.y);
    qa[kk][1] = pack_bf16(qacc[0][2 * kk][2] + b0.x, qacc[0][2 * kk][3] + b0.y);
    qa[kk][2] = pack_bf16(qacc[0][2 * kk + 1][0] + b1.x, qacc[0][2 * kk + 1][1] + b1.y);
    qa[kk][3] = pack_bf16(qacc[0][2 * kk + 1][2] + b1.x, qacc[0][2 * kk + 1][3] + b1.y);
  }

  // b: attention over K/V chunks. Logits in base 2 with the scale folded in:
  // p = 2^(s * scale2 - m * scale2), m the running max of the raw q.k.
  // MODE NO_SOFTMAX: p = q.k * scale / Nkv, unnormalised (zero keys give 0).
  const float scale2 = MODE == NO_SOFTMAX ? scale / Nkv : scale * LOG2E;
  float oacc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (raw q.k) of rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this lane's part of the running sums
  const int kn = (lane & 7) + ((lane >> 4) << 3), kd = ((lane >> 3) & 1) << 3;  // K: ldmatrix
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vd = (lane >> 4) * 8;      // V: .trans
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<KV_STAGES - 2>();
    __syncthreads();  // chunk c landed everywhere; chunk c - 1's stage is free
    if (c + KV_STAGES - 1 < nch) load_kv(c + KV_STAGES - 1);
    if (PROJ && c == 0) load_chunk(ws, wp, 0, HD, HD, HD, 0);  // the Wq ring is free now
    cp_async_commit();
    const int st = c % KV_STAGES;
    const bf16* kc_ = ks + st * BKV * LDH;
    const bf16* vc_ = vs + st * BKV * LDH;

    // S = q_h . K^T: 16 rows x BKV keys as BKV / 8 accumulator tiles
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    {  // the next K fragment loads while this one's two products issue
      constexpr int NF = (BKV / 16) * (HD / 16);
      uint32_t kf[2][4];
      ldmatrix_x4(kf[0], kc_ + kn * LDH + kd);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int nj = i / (HD / 16), kk = i % (HD / 16);
        if (i + 1 < NF)
          ldmatrix_x4(kf[(i + 1) & 1],
                      kc_ + ((i + 1) / (HD / 16) * 16 + kn) * LDH + (i + 1) % (HD / 16) * 16 + kd);
        mma_16816(s[2 * nj], qa[kk], kf[i & 1][0], kf[i & 1][1]);
        mma_16816(s[2 * nj + 1], qa[kk], kf[i & 1][2], kf[i & 1][3]);
      }
    }
    if (MODE == NO_SOFTMAX) {
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= scale2;
    } else {
      if ((c + 1) * BKV > Nkv) {  // the last chunk holds keys beyond Nkv
        const int kv0 = c * BKV;
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kv0 + nt * 8 + 2 * t + (i & 1) >= Nkv) s[nt][i] = -INFINITY;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
      // every chunk holds at least one valid key, so the new max is finite
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float a_lo = exp2_ftz((m_lo - mn_lo) * scale2), a_hi = exp2_ftz((m_hi - mn_hi) * scale2);
      m_lo = mn_lo;
      m_hi = mn_hi;
      const float ms_lo = mn_lo * scale2, ms_hi = mn_hi * scale2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        s[nt][0] = exp2_ftz(fmaf(s[nt][0], scale2, -ms_lo));
        s[nt][1] = exp2_ftz(fmaf(s[nt][1], scale2, -ms_lo));
        s[nt][2] = exp2_ftz(fmaf(s[nt][2], scale2, -ms_hi));
        s[nt][3] = exp2_ftz(fmaf(s[nt][3], scale2, -ms_hi));
        sum_lo += s[nt][0] + s[nt][1];
        sum_hi += s[nt][2] + s[nt][3];
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        oacc[dt][0] *= a_lo;
        oacc[dt][1] *= a_lo;
        oacc[dt][2] *= a_hi;
        oacc[dt][3] *= a_hi;
      }
    }
    // O += P . V: the probabilities of keys 16kk..16kk+15 form one A fragment;
    // one ldmatrix.x4.trans gives the B fragments of two 8-column tiles of V,
    // and the next one loads while this one's two products issue
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    {
      constexpr int NF = (BKV / 16) * (HD / 16);
      uint32_t vf[2][4];
      ldmatrix_x4_trans(vf[0], vc_ + vr * LDH + vd);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int kk = i / (HD / 16), dj = i % (HD / 16);
        if (i + 1 < NF)
          ldmatrix_x4_trans(vf[(i + 1) & 1],
                            vc_ + ((i + 1) / (HD / 16) * 16 + vr) * LDH + (i + 1) % (HD / 16) * 16 + vd);
        mma_16816(oacc[2 * dj], pa[kk], vf[i & 1][0], vf[i & 1][1]);
        mma_16816(oacc[2 * dj + 1], pa[kk], vf[i & 1][2], vf[i & 1][3]);
      }
    }
  }

  // c: O_h = P V / l, rounded to bf16 (where the plain version rounds the head outputs)
  const float inv_lo = MODE == NO_SOFTMAX ? 1.f : 1.f / quad_sum(l_lo);
  const float inv_hi = MODE == NO_SOFTMAX ? 1.f : 1.f / quad_sum(l_hi);
  const long long row = row0 + warp * 16 + g;
  if (PROJ) {  // out = x + O . Wp^T + bp for this warp's rows; O repacked as A fragments
    uint32_t oa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      oa[kk][0] = pack_bf16(oacc[2 * kk][0] * inv_lo, oacc[2 * kk][1] * inv_lo);
      oa[kk][1] = pack_bf16(oacc[2 * kk][2] * inv_hi, oacc[2 * kk][3] * inv_hi);
      oa[kk][2] = pack_bf16(oacc[2 * kk + 1][0] * inv_lo, oacc[2 * kk + 1][1] * inv_lo);
      oa[kk][3] = pack_bf16(oacc[2 * kk + 1][2] * inv_hi, oacc[2 * kk + 1][3] * inv_hi);
    }
    cp_async_wait_all();
    __syncthreads();  // Wp landed everywhere
    float pacc[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) pacc[nt][0] = pacc[nt][1] = pacc[nt][2] = pacc[nt][3] = 0.f;
#pragma unroll
    for (int nj = 0; nj < HD / 16; ++nj)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t wf[4];
        ldmatrix_x4(wf, ws + (nj * 16 + kn) * LDK + kk * 16 + kd);
        mma_16816(pacc[2 * nj], oa[kk], wf[0], wf[1]);
        mma_16816(pacc[2 * nj + 1], oa[kk], wf[2], wf[3]);
      }
    const size_t base = ((size_t)b * N + row) * C + 2 * t;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const float2 bb = unpack_bf16(*reinterpret_cast<const uint32_t*>(bp + nt * 8 + 2 * t));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        if (row + 8 * hi >= N) continue;
        const size_t off = base + (size_t)8 * hi * C + nt * 8;
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + off));
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(
            xv.x + (pacc[nt][2 * hi] + bb.x), xv.y + (pacc[nt][2 * hi + 1] + bb.y));
      }
    }
    return;
  }
  bf16* o_lo = o + ((size_t)b * N + row) * C + h * HD + 2 * t;
  bf16* o_hi = o_lo + 8 * (size_t)C;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    if (row < N)
      *reinterpret_cast<uint32_t*>(o_lo + dt * 8) = pack_bf16(oacc[dt][0] * inv_lo, oacc[dt][1] * inv_lo);
    if (row + 8 < N)
      *reinterpret_cast<uint32_t*>(o_hi + dt * 8) = pack_bf16(oacc[dt][2] * inv_hi, oacc[dt][3] * inv_hi);
  }
}

template <int HD, int MODE, bool PROJ>
int launch_attn(const bf16* y, const void* wq, const void* bq, const void* k, const void* v,
                void* o, const bf16* x, const void* wp, const void* bp, void* out, int B, int N,
                int C, int heads, int Nkv, float scale, cudaStream_t stream) {
  constexpr size_t smem = attn_smem(HD);
  static_assert(smem <= SMEM_LIMIT, "attention tile exceeds shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<HD, MODE, PROJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BM - 1) / BM, heads, B);
  attn_kernel<HD, MODE, PROJ><<<grid, NTHREADS, smem, stream>>>(
      y, static_cast<const bf16*>(wq), static_cast<const bf16*>(bq), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), x, static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bp), static_cast<bf16*>(out), N, C, heads, Nkv, scale);
  return static_cast<int>(cudaGetLastError());
}

// x, out, y, o (B, N, C); gamma, beta, bq, bp (C); wq, wp (C_out, C_in);
// k, v (B, Nkv, heads, HD). y (LN(x)) and o (the head outputs) are the
// caller's scratch. normalize = false skips the LayerNorm and attends from x
// itself (the probe's no_ln).
template <int HD, int MODE>
int launch(const void* x, const void* gamma, const void* beta, const void* wq, const void* bq,
           const void* k, const void* v, const void* wp, const void* bp, void* y, void* o,
           void* out, int B, int N, int C, int heads, int Nkv, float eps, float scale,
           bool normalize, cudaStream_t stream) {
  if (B < 1 || N < 1 || Nkv < 1 || C != heads * HD || C % 16 || heads > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* yb = xb;
  if (normalize) {
    const int err = launch_ln(xb, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                              static_cast<bf16*>(y), (long long)B * N, C, eps, stream);
    if (err) return err;
    yb = static_cast<const bf16*>(y);
  }
  if (heads == 1)  // the out-projection inside the attention kernel
    return launch_attn<HD, MODE, true>(yb, wq, bq, k, v, nullptr, xb, wp, bp, out, B, N, C, heads,
                                       Nkv, scale, stream);
  const int err = launch_attn<HD, MODE, false>(yb, wq, bq, k, v, o, nullptr, nullptr, nullptr,
                                               nullptr, B, N, C, heads, Nkv, scale, stream);
  if (err) return err;
  return launch_gemm<EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wp), static_cast<const bf16*>(bp),
      xb, static_cast<bf16*>(out), (long long)B * N, C, C, stream);
}

}  // namespace k1
}  // namespace uttk
