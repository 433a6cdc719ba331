// Building blocks shared by K1 (fused_attention.cu) and K2 (fused_ffn.cu) on
// Hopper (sm_90a): cp.async copies, ldmatrix fragment loads, the
// mma.sync.m16n8k16 bf16 product, a warp's tile product from shared memory,
// the LayerNorm kernel (rows of x -> LN(x) in bf16, where the plain versions
// round it), and one streamed tile product with a bias (+ residual) epilogue:
// K1's out-projection and K2's fc1 and fc2 at the wide widths.
//
// Shared tiles keep rows of 64 bf16 plus 8 of padding (144 bytes), so the
// eight row addresses of an ldmatrix fall in eight different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace uttk {

constexpr int PAD = 8;         // bf16 row padding of shared tiles
constexpr int KC = 64;         // depth of one streamed chunk of a product
constexpr int LDK = KC + PAD;  // row stride of a streamed chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BM = 128;        // rows of a block's tile (query rows, pixels)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; valid = false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// 2^x with results below 2^-126 flushed to zero: one MUFU.EX2. exp2f (without
// --use_fast_math) wraps the same instruction in three more to produce
// denormal results, which no softmax term of an f32 sum whose largest term is
// 1 can feel.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 4 lanes of a quad (the lanes that hold one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sum over the 8 lanes of an aligned group of 8
__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// acc[mi][ni] += A[16 MT x 16 KS] . B[8 NT x 16 KS]^T for one warp, both
// operands in shared memory, A row-major [m][k] and B row-major [n][k] (the
// torch Linear layout, and K as [key][dim]). NT is even: one ldmatrix.x4
// gives the B fragments of two 8-column tiles. The fragments of step ks + 1
// load while the products of step ks issue (the asm is volatile, so program
// order is issue order: a product right after its own load would wait for it).
template <int MT, int NT, int KS>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb) {
  static_assert(NT % 2 == 0, "NT must be even");
  const int lane = threadIdx.x & 31;
  const int ar = lane & 15, ac = (lane >> 4) << 3;
  const int bn = (lane & 7) + ((lane >> 4) << 3), bk = ((lane >> 3) & 1) << 3;
  uint32_t af[2][MT][4], bf[2][NT / 2][4];
  auto load = [&](int ks, int buf) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(af[buf][mi], a + (mi * 16 + ar) * lda + ks * 16 + ac);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) ldmatrix_x4(bf[buf][nj], b + (nj * 16 + bn) * ldb + ks * 16 + bk);
  };
  load(0, 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks + 1 < KS) load(ks + 1, (ks + 1) & 1);
    const int cur = ks & 1;
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_16816(acc[mi][2 * nj], af[cur][mi], bf[cur][nj][0], bf[cur][nj][1]);
        mma_16816(acc[mi][2 * nj + 1], af[cur][mi], bf[cur][nj][2], bf[cur][nj][3]);
      }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

constexpr int LN_ROWS = 32;  // rows per block of ln_kernel: 8 warps x 4 rows

// y = LN(x) rounded to bf16, rows of C channels (C % 8 == 0). Eight lanes
// share a row (4 rows per warp, LN_ROWS per block) and read it with 16-byte
// loads; the sums are shifted by the row's first element, so var =
// E[(x - s)^2] - E[x - s]^2 keeps its digits when the mean is large next to
// the spread; then the row again (from L1) is normalised and stored.
__global__ void __launch_bounds__(NTHREADS)
ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
          const bf16* __restrict__ beta, bf16* __restrict__ y, long long M, int C, float eps) {
  const int lane = threadIdx.x & 31, sub = lane & 7;
  const long long row = (long long)blockIdx.x * LN_ROWS + (threadIdx.x >> 3);
  const bool valid = row < M;  // the 8 lanes of a group agree
  const bf16* xr = x + (valid ? row : 0) * C;
  const float shift = valid ? __bfloat162float(xr[0]) : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int v = sub; valid && v < C / 8; v += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]);
      const float d0 = f.x - shift, d1 = f.y - shift;
      s1 += d0 + d1;
      s2 += d0 * d0 + d1 * d1;
    }
  }
  s1 = oct_sum(s1) / C;  // every lane of the warp reaches the shuffles
  s2 = oct_sum(s2) / C;
  if (!valid) return;
  const float mean = shift + s1, rstd = rsqrtf(fmaxf(s2 - s1 * s1, 0.f) + eps);
  bf16* yr = y + row * C;
  for (int v = sub; v < C / 8; v += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const uint4 gu = *reinterpret_cast<const uint4*>(gamma + v * 8);
    const uint4 bu = *reinterpret_cast<const uint4*>(beta + v * 8);
    uint32_t w[4] = {u.x, u.y, u.z, u.w};
    const uint32_t gw[4] = {gu.x, gu.y, gu.z, gu.w}, bw[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]), g2 = unpack_bf16(gw[i]), b2 = unpack_bf16(bw[i]);
      w[i] = pack_bf16((f.x - mean) * rstd * g2.x + b2.x, (f.y - mean) * rstd * g2.y + b2.y);
    }
    *reinterpret_cast<uint4*>(yr + v * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

inline int launch_ln(const bf16* x, const bf16* gamma, const bf16* beta, bf16* y, long long M,
                     int C, float eps, cudaStream_t stream) {
  const long long blocks = (M + LN_ROWS - 1) / LN_ROWS;
  if (blocks > 0x7fffffffLL || C % 8) return static_cast<int>(cudaErrorInvalidValue);
  ln_kernel<<<static_cast<unsigned>(blocks), NTHREADS, 0, stream>>>(x, gamma, beta, y, M, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// Rows [row0, row0 + rows) x channels [c0, c0 + KC) of a row-major (n_rows, K)
// matrix into a shared chunk (row stride LDK) with cp.async; rows beyond
// n_rows and channels beyond K read as zeros. K % 8 == 0.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, long long row0, int rows,
                                           long long n_rows, int K, int c0) {
  for (int e = threadIdx.x; e < rows * (KC / 8); e += blockDim.x) {
    const int r = e >> 3, c = c0 + (e & 7) * 8;
    const long long row = row0 + r;
    const bool valid = row < n_rows && c < K;
    cp_async16(dst + r * LDK + (e & 7) * 8, src + (valid ? row * K + c : 0), valid);
  }
}

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RESIDUAL = 1 };

// The streamed product's tile: 128 x 128 per block of 8 warps as 2 (rows) x 4
// (columns), each warp a 64 x 32 tile (4 x 4 mma tiles), 64-deep chunks
// through a 3-stage cp.async ring (two chunks in flight while one is
// multiplied), two blocks per SM.
constexpr int G_BM = 128, G_BN = 128, G_KC = KC, G_LD = G_KC + PAD, G_STAGES = 3;
constexpr int G_THREADS = NTHREADS;
constexpr int G_LDC = G_BN + 4;  // f32 row stride of the output tile staged for the epilogue

constexpr size_t gemm_smem() { return sizeof(bf16) * G_STAGES * (size_t)(G_BM + G_BN) * G_LD; }
static_assert(sizeof(float) * G_BM * G_LDC <= gemm_smem(), "the epilogue tile must fit the ring");

// out[M, Nout] = epilogue(A . B^T + bias), bf16 out, f32 accumulation, A (M, K)
// and B (Nout, K) row-major bf16. EPI_BIAS writes acc + bias; EPI_BIAS_RESIDUAL
// writes res + (acc + bias), res (M, Nout). Requires K % 8 == 0 and Nout % 8
// == 0; rows, columns and depth beyond M, Nout and K read as zeros.
template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bw,
            const bf16* __restrict__ bias, const bf16* __restrict__ res, bf16* __restrict__ out,
            long long M, int K, int Nout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // G_STAGES x G_BM x G_LD
  bf16* bs = as + G_STAGES * G_BM * G_LD;     // G_STAGES x G_BN x G_LD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const long long row0 = (long long)blockIdx.x * G_BM;
  const int col0 = blockIdx.y * G_BN;
  const int nk = (K + G_KC - 1) / G_KC;
  auto load = [&](int kc) {  // chunk kc into its stage
    const int st = kc % G_STAGES;
    load_chunk(as + st * G_BM * G_LD, A, row0, G_BM, M, K, kc * G_KC);
    load_chunk(bs + st * G_BN * G_LD, Bw, col0, G_BN, Nout, K, kc * G_KC);
  };
#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  float acc[4][4][4];
  zero_acc(acc);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();  // chunk kc landed everywhere; chunk kc - 1's stage is free
    if (kc + G_STAGES - 1 < nk) load(kc + G_STAGES - 1);
    cp_async_commit();
    const int st = kc % G_STAGES;
    warp_mma<4, 4, G_KC / 16>(acc, as + st * G_BM * G_LD + wm * 64 * G_LD, G_LD,
                              bs + st * G_BN * G_LD + wn * 32 * G_LD, G_LD);
  }

  // The tile (f32, + bias) goes through shared memory, so the stores (and the
  // residual's loads) are whole 16-byte row pieces; each output rounds once.
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring
  float* cs = reinterpret_cast<float*>(smem);  // G_BM x G_LDC f32
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int cl = wn * 32 + ni * 8 + 2 * t;
    const float2 bb = col0 + cl < Nout ? unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + col0 + cl))
                                       : make_float2(0.f, 0.f);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<float2*>(cs + (wm * 64 + mi * 16 + g + hi * 8) * G_LDC + cl) =
            make_float2(acc[mi][ni][2 * hi] + bb.x, acc[mi][ni][2 * hi + 1] + bb.y);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G_BM * (G_BN / 8); e += G_THREADS) {
    const int r = e / (G_BN / 8), c = (e % (G_BN / 8)) * 8;
    const long long row = row0 + r;
    if (row >= M || col0 + c >= Nout) continue;
    const float4 lo = *reinterpret_cast<const float4*>(cs + r * G_LDC + c);
    const float4 hi = *reinterpret_cast<const float4*>(cs + r * G_LDC + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (EPI == EPI_BIAS_RESIDUAL) {
      const uint4 ru = *reinterpret_cast<const uint4*>(res + row * Nout + col0 + c);
      const uint32_t rw[4] = {ru.x, ru.y, ru.z, ru.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 rf = unpack_bf16(rw[j]);
        v[2 * j] = rf.x + v[2 * j];
        v[2 * j + 1] = rf.y + v[2 * j + 1];
      }
    }
    *reinterpret_cast<uint4*>(out + row * Nout + col0 + c) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  }
}

template <int EPI>
int launch_gemm(const bf16* A, const bf16* Bw, const bf16* bias, const bf16* res, bf16* out,
                long long M, int K, int Nout, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem();
  static_assert(smem <= SMEM_LIMIT, "product tile exceeds shared memory");
  const long long mb = (M + G_BM - 1) / G_BM;
  if (mb > 0x7fffffffLL || (Nout + G_BN - 1) / G_BN > 65535 || K % 8 || Nout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(mb), (Nout + G_BN - 1) / G_BN);
  gemm_kernel<EPI><<<grid, G_THREADS, smem, stream>>>(A, Bw, bias, res, out, M, K, Nout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace uttk
