// Where the time of the port's streamed product (gemm_kernel, ops/csrc/tiles.cuh:
// K1's out-projection, K2's split-route fc1 and fc2) goes on the card: its main
// loop and epilogue with the chunk loads, the products or the stores left out,
// on the same 128 x 128 tiles, 8 warps and 3-stage ring. Built and run by
// gemm_phases.py; prints one line per shape.
#include <cstdio>

#include "tiles.cuh"

using namespace uttk;

// PARTS: 1 the chunk loads, 2 the products, 4 the stores of the output tile
template <int PARTS>
__global__ void __launch_bounds__(G_THREADS, 2)
phase_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bw, bf16* __restrict__ out,
             int M, int K, int Nout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + G_STAGES * G_BM * G_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const long long row0 = (long long)blockIdx.x * G_BM;
  const int col0 = blockIdx.y * G_BN, nk = K / G_KC;
  auto load = [&](int kc) {
    const int st = kc % G_STAGES, k0 = kc * G_KC;
    for (int e = threadIdx.x; e < (G_BM + G_BN) * (G_KC / 8); e += G_THREADS) {
      const int r = e >> 3, c = k0 + (e & 7) * 8;
      const bool is_a = r < G_BM;
      const long long row = is_a ? row0 + r : col0 + (r - G_BM);
      bf16* dst = (is_a ? as + st * G_BM * G_LD + r * G_LD : bs + st * G_BN * G_LD + (r - G_BM) * G_LD) +
                  (e & 7) * 8;
      cp_async16(dst, (is_a ? A : Bw) + row * K + c, true);
    }
  };
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if ((PARTS & 1) && s < nk) load(s);
    cp_async_commit();
  }
  float acc[4][4][4];
  zero_acc(acc);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    if ((PARTS & 1) && kc + G_STAGES - 1 < nk) load(kc + G_STAGES - 1);
    cp_async_commit();
    const int st = kc % G_STAGES;
    if (PARTS & 2)
      warp_mma<4, 4, G_KC / 16>(acc, as + st * G_BM * G_LD + wm * 64 * G_LD, G_LD,
                                bs + st * G_BN * G_LD + wn * 32 * G_LD, G_LD);
  }
  float sum = 0.f;
  for (int mi = 0; mi < 4; ++mi)
    for (int ni = 0; ni < 4; ++ni) sum += acc[mi][ni][0] + acc[mi][ni][3];
  if (PARTS & 4) {  // as the production epilogue: 16-byte row pieces
    for (int e = threadIdx.x; e < G_BM * (G_BN / 8); e += G_THREADS) {
      const int r = e / (G_BN / 8), c = (e % (G_BN / 8)) * 8;
      const uint32_t w = pack_bf16(sum, sum);
      *reinterpret_cast<uint4*>(out + (row0 + r) * Nout + col0 + c) = make_uint4(w, w, w, w);
    }
  } else if (sum == 12345.f) {
    out[lane] = __float2bfloat16(sum);
  }
}

template <int PARTS>
float time_us(const bf16* A, const bf16* B, bf16* C, int M, int N, int K) {
  const size_t smem = gemm_smem();
  cudaFuncSetAttribute(phase_kernel<PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(M / G_BM, N / G_BN);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 3; ++i) phase_kernel<PARTS><<<grid, G_THREADS, smem>>>(A, B, C, M, K, N);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) phase_kernel<PARTS><<<grid, G_THREADS, smem>>>(A, B, C, M, K, N);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return 1e3f * ms / 20;
}

int main(int argc, char** argv) {
  // (M, N, K): b2's stage-3 fc1 and stage-4 fc2 at batch 4 (M rounded to the tile), a square one
  const int shapes[3][3] = {{22400, 1280, 320}, {5632, 512, 2048}, {8192, 8192, 4096}};
  for (const auto& s : shapes) {
    const int M = s[0], N = s[1], K = s[2];
    bf16 *A, *B, *C;
    cudaMalloc(&A, (size_t)M * K * 2);
    cudaMalloc(&B, (size_t)N * K * 2);
    cudaMalloc(&C, (size_t)M * N * 2);
    cudaMemset(A, 0, (size_t)M * K * 2);
    cudaMemset(B, 0, (size_t)N * K * 2);
    const float all = time_us<7>(A, B, C, M, N, K), lm = time_us<3>(A, B, C, M, N, K);
    const float l = time_us<1>(A, B, C, M, N, K), m = time_us<2>(A, B, C, M, N, K);
    const double tiles_bytes = 2.0 * (M / G_BM) * (N / G_BN) * (double)(G_BM + G_BN) * K;
    printf("{\"M\": %d, \"N\": %d, \"K\": %d, \"all_us\": %.2f, \"loads_products_us\": %.2f, "
           "\"loads_us\": %.2f, \"products_us\": %.2f, \"tflops\": %.1f, \"products_tflops\": %.1f, "
           "\"loads_tb_per_s\": %.2f, \"error\": \"%s\"}\n",
           M, N, K, all, lm, l, m, 2.0 * M * N * K / all / 1e6, 2.0 * M * N * K / m / 1e6,
           tiles_bytes / l / 1e6, cudaGetErrorString(cudaGetLastError()));
    cudaFree(A);
    cudaFree(B);
    cudaFree(C);
  }
  return 0;
}
