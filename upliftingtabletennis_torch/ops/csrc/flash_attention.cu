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
// output written once, so the bytes are far below the operations.
//
// Design. The TPU kernel keeps a head's whole K/V resident and softmaxes in
// one pass; here K+V of one head is 358 KB at b2 (Nkv = 1400, hd = 64),
// above the 227 KB a block may use. So the kernel is K1's inner loop
// (fused_attention.cu) without the LayerNorm, the projections and the
// residual:
//   - one block of 8 warps owns BM = 128 query rows of one (sample, head);
//     each warp owns 16 rows and keeps their q as mma A fragments in
//     registers for the whole block, read straight from the (B, N, h, hd)
//     layout (no transpose);
//   - K and V stream through shared memory in chunks of BN = 64 keys,
//     double-buffered with cp.async (the next chunk loads while the warps
//     compute on this one); keys beyond Nkv are zero-filled by the copy and
//     their logits set to -inf;
//   - the logits, the probabilities and the running output stay in
//     registers in the mma.sync.m16n8k16 accumulator layout (online
//     softmax, FlashAttention-2 arrangement); V is kept [key][dim] and its
//     B fragments load transposed with ldmatrix.trans;
//   - query rows beyond Nq read zeros and are not stored.
// No TMA, wgmma or warp specialisation yet.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;  // query rows per block
constexpr int BN = 64;   // keys per K/V chunk
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int PAD = 8;  // bf16 row padding of the shared K/V tiles
constexpr float LOG2E = 1.4426950408889634f;

// max / sum over the 4 lanes of a quad (the lanes that hold one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four transposed 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 tile (bf16 in, f32 accumulation). Fragment
// layout (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int Nq, int Nkv,
                       int heads, float scale2) {
  constexpr int LDH = HD + PAD;
  __shared__ __align__(128) bf16 ks[2][BN * LDH];  // K chunks, [key][dim]
  __shared__ __align__(128) bf16 vs[2][BN * LDH];  // V chunks, [key][dim]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t ld = (size_t)heads * HD;  // elements from one token to the next
  const bf16* kb = k + (size_t)b * Nkv * ld + h * HD;
  const bf16* vb = v + (size_t)b * Nkv * ld + h * HD;

  // K/V chunk c into buffer buf: BN keys x HD / 8 pieces of 16 bytes each
  auto load_chunk = [&](int c, int buf) {
    for (int e = threadIdx.x; e < BN * (HD / 8); e += NTHREADS) {
      const int j = e / (HD / 8), c8 = (e % (HD / 8)) * 8;
      const int key = c * BN + j;
      const bool valid = key < Nkv;
      const size_t off = (size_t)(valid ? key : 0) * ld + c8;
      cp_async16(&ks[buf][j * LDH + c8], kb + off, valid);
      cp_async16(&vs[buf][j * LDH + c8], vb + off, valid);
    }
  };
  const int nch = (Nkv + BN - 1) / BN;
  load_chunk(0, 0);
  cp_async_commit();

  // this warp's 16 query rows as A fragments (zeros beyond Nq)
  const int row = blockIdx.x * BM + warp * 16 + g;
  const bool ok_lo = row < Nq, ok_hi = row + 8 < Nq;
  const bf16* q_lo = q + ((size_t)b * Nq + (ok_lo ? row : 0)) * ld + h * HD + 2 * t;
  const bf16* q_hi = q + ((size_t)b * Nq + (ok_hi ? row + 8 : 0)) * ld + h * HD + 2 * t;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qa[kk][0] = ok_lo ? ld32(q_lo + kk * 16) : 0u;
    qa[kk][1] = ok_hi ? ld32(q_hi + kk * 16) : 0u;
    qa[kk][2] = ok_lo ? ld32(q_lo + kk * 16 + 8) : 0u;
    qa[kk][3] = ok_hi ? ld32(q_hi + kk * 16 + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8 (base 2)
  float l_lo = 0.f, l_hi = 0.f;              // this lane's part of the running sums

  for (int c = 0; c < nch; ++c) {
    const int buf = c & 1;
    if (c + 1 < nch) load_chunk(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const bf16* kc = ks[buf];
    const bf16* vc = vs[buf];
    const int kv0 = c * BN;

    // S = q . K^T: 16 rows x BN keys as BN / 8 accumulator tiles
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* k0 = kc + (nt * 8 + g) * LDH + kk * 16 + 2 * t;
        mma_16816(s[nt], qa[kk], ld32(k0), ld32(k0 + 8));
      }
    }
    // logits in base 2: s2 = q.k * scale * log2(e), p = 2^(s2 - m2)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int key = kv0 + nt * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = key + (i & 1) < Nkv ? s[nt][i] * scale2 : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    // every chunk holds at least one valid key, so the new max is finite
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= a_lo;
      o[dt][1] *= a_lo;
      o[dt][2] *= a_hi;
      o[dt][3] *= a_hi;
    }
    // O += P . V: the probabilities of keys 16kk..16kk+15 form one A fragment;
    // one ldmatrix.x4.trans gives the B fragments of two 8-column tiles of V
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vc + (kk * 16 + lrow) * LDH + dt * 8 + lcol);
        mma_16816(o[dt], pa, vb4[0], vb4[1]);
        mma_16816(o[dt + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

  // normalise and store this warp's rows
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  bf16* o_lo = out + ((size_t)b * Nq + row) * ld + h * HD + 2 * t;
  bf16* o_hi = o_lo + 8 * ld;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    if (ok_lo)
      *reinterpret_cast<uint32_t*>(o_lo + dt * 8) = pack_bf16(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (ok_hi)
      *reinterpret_cast<uint32_t*>(o_hi + dt * 8) = pack_bf16(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Nq, int Nkv,
           int heads, float scale, cudaStream_t stream) {
  const dim3 grid((Nq + BM - 1) / BM, B * heads);
  flash_attention_kernel<HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Nq, Nkv, heads, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q, out (B, Nq, heads, hd); k, v (B, Nkv, heads, hd). All bf16, contiguous,
// 32-byte aligned. hd is 32 or 64; Nq >= 1, Nkv >= 1, B * heads <= 65535.
// Returns a cudaError_t code (0 on success).
int uttk_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Nq,
                         int Nkv, int heads, int hd, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nq < 1 || Nkv < 1 || B * heads < 1 || B * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, Nq, Nkv, heads, scale, st);
    case 64: return launch<64>(q, k, v, out, B, Nq, Nkv, heads, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
