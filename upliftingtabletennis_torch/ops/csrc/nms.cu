// K6: box-NMS suppression mask and greedy resolve for Hopper (sm_90a).
//
//   mask[i, w] bit b = (j = 64 w + b) > i  and  IoU(box i, box j) >= thresh
//   keep[order[i]]   = box i (score order) is not suppressed by a kept box before it
//
// IoU with the +1-pixel convention of the reference's cpu_nms:
//   inter = max(min(x2) - max(x1) + 1, 0) * max(min(y2) - max(y1) + 1, 0)
//   IoU   = inter / (area_i + area_j - inter),  area = (x2 - x1 + 1) (y2 - y1 + 1)
// Replaces the Pallas TPU kernel upliftingtabletennis_tpu/ops/nms.py
// (`_iou_tile_kernel`, called from `_overlap_matrix_pallas`) and the greedy
// `fori_loop` of `nms_mask` there.
//
// Exactness: the decision has to match the JAX package's f32 arithmetic bit for
// bit, ties included (an IoU of exactly the threshold suppresses). nvcc would
// contract area_i + area_j - w * h into an FMA, which rounds once where the
// reference rounds twice, so every operation is an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc never
// contracts.
//
// What bounds it: the mask is about 20 f32 operations per pair of boxes
// (N (N - 1) / 2 pairs) and writes N * ceil(N / 64) words; both are far below
// the card's rates at the N of a detector (hundreds to thousands of boxes).
// The resolve is serial in i: N dependent steps, each a read of bit i and, if
// box i survives, an OR of its row into the running `removed` words.
//
// Design: the two-phase bitmask of the reference's CUDA NMS
// (vit_pose/vit_utils/nms/nms_kernel.cu), with the resolve on the card.
//   1. overlap_kernel: one block of 64 threads per (64-row, 64-column) tile of
//      the boxes in score order. The tile's column boxes and their areas sit in
//      shared memory; each thread owns one row and writes one uint64 word of
//      the (N, ceil(N / 64)) mask. Tiles left of the diagonal hold no pair
//      j > i and write zero words. No padding to 128, as the TPU tiles had.
//   2. resolve_kernel: one block, over chunks of up to 64 rows that lie within
//      one word (the chunk's diagonal word). All its threads copy the chunk's
//      rows of the mask (only the words at or right of the diagonal one: the
//      others are zero) and its slice of `order` into shared memory. One thread
//      then makes the serial scan on the diagonal word alone, in a register: a
//      row not yet removed is kept and ORs in its diagonal word, which is all
//      that decides the chunk's later rows. Then every thread ORs the kept rows
//      into the words right of the diagonal, a word per thread, and the chunk's
//      keep flags go straight into the original indexing.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr int TILE = 64;                // boxes per row or column tile: one bit each in a word
constexpr int RESOLVE_THREADS = 256;    // the copy of a row chunk and the OR of its kept rows
constexpr int RESOLVE_SMEM = 48 * 1024; // keep word, removed words, a chunk of mask rows and of order
constexpr int MAX_ROWS_PER_CHUNK = TILE;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(r, c) >= thresh, in the reference's order of f32 operations
__device__ __forceinline__ bool overlaps(float4 r, float area_r, float4 c, float area_c,
                                         float thresh) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 1.0f), 0.0f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_r, area_c), inter)) >= thresh;
}

__global__ void __launch_bounds__(TILE) overlap_kernel(const float4* __restrict__ boxes, int n,
                                                       int words, float thresh,
                                                       u64* __restrict__ mask) {
  const int row_tile = blockIdx.y, col_tile = blockIdx.x;
  const int i = row_tile * TILE + threadIdx.x;
  if (col_tile < row_tile) {  // every j < i here: no bit to set
    if (i < n) mask[(size_t)i * words + col_tile] = 0ull;
    return;
  }
  __shared__ float4 col_box[TILE];
  __shared__ float col_area[TILE];
  const int j0 = col_tile * TILE;
  const int cols = min(TILE, n - j0);
  if (threadIdx.x < cols) {
    const float4 b = boxes[j0 + threadIdx.x];
    col_box[threadIdx.x] = b;
    col_area[threadIdx.x] = box_area(b);
  }
  __syncthreads();
  if (i >= n) return;
  const float4 r = boxes[i];
  const float area_r = box_area(r);
  u64 bits = 0ull;
  for (int c = (col_tile == row_tile) ? threadIdx.x + 1 : 0; c < cols; ++c) {
    if (overlaps(r, area_r, col_box[c], col_area[c], thresh)) bits |= 1ull << c;
  }
  mask[(size_t)i * words + col_tile] = bits;
}

__global__ void __launch_bounds__(RESOLVE_THREADS) resolve_kernel(
    const u64* __restrict__ mask, const int64_t* __restrict__ order, int n, int words,
    int rows_per_chunk, uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];  // all of it dynamic, at most RESOLVE_SMEM bytes
  u64& chunk_kept = smem[0];     // the scan's keep bits of the current chunk
  u64* removed = smem + 1;       // [words]
  int64_t* chunk_order = reinterpret_cast<int64_t*>(removed + words);  // [rows_per_chunk]
  u64* rows = removed + words + rows_per_chunk;  // [rows_per_chunk][words - w0] of the chunk
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  for (int r0 = 0; r0 < n; r0 += rows_per_chunk) {
    const int nr = min(rows_per_chunk, n - r0);
    const int w0 = r0 / TILE;  // the chunk's diagonal word; the words left of it are zero
    const int span = words - w0;
    __syncthreads();  // the previous chunk is done with `rows`, `chunk_order` and `removed`
    for (int t = threadIdx.x; t < nr; t += blockDim.x) chunk_order[t] = order[r0 + t];
    for (int t = threadIdx.x; t < nr * span; t += blockDim.x) {
      const int rr = t / span, w = t - rr * span;
      rows[t] = mask[(size_t)(r0 + rr) * words + w0 + w];
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // the serial scan, on the diagonal word alone, in a register
      u64 cur = removed[w0], kept = 0ull;
      for (int rr = 0; rr < nr; ++rr) {
        if (!((cur >> ((r0 + rr) % TILE)) & 1ull)) {
          kept |= 1ull << rr;
          cur |= rows[rr * span];  // row rr's bits j > i of the diagonal word
        }
      }
      removed[w0] = cur;
      chunk_kept = kept;
    }
    __syncthreads();
    const u64 kept = chunk_kept;
    for (int t = threadIdx.x; t < nr; t += blockDim.x) keep[chunk_order[t]] = (kept >> t) & 1ull;
    for (int w = w0 + 1 + threadIdx.x; w < words; w += blockDim.x) {  // OR in the kept rows
      u64 acc = removed[w];
      for (u64 k = kept; k; k &= k - 1) {
        acc |= rows[(__ffsll(static_cast<long long>(k)) - 1) * span + w - w0];
      }
      removed[w] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* uttk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// boxes (n, 4) f32 (x1, y1, x2, y2) in descending score order, contiguous and
// 16-byte aligned; mask (n, ceil(n / 64)) uint64. 1 <= n <= uttk_nms_max_boxes().
// Returns a cudaError_t code (0 on success).
int uttk_nms_overlap(const void* boxes, int n, float thresh, void* mask, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  overlap_kernel<<<dim3(words, words), TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), n, words, thresh, static_cast<u64*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// The largest n the resolve takes: the chunk's keep word, the removed words,
// one mask row and one entry of order must fit in its shared memory.
int uttk_nms_max_boxes() { return ((RESOLVE_SMEM / 8 - 2) / 2) * TILE; }

// mask (n, ceil(n / 64)) uint64 from uttk_nms_overlap; order (n,) int64, the
// original index of each box in score order; keep (n,) uint8, written at
// order[i] for every i. 1 <= n <= uttk_nms_max_boxes(). Returns a cudaError_t code.
int uttk_nms_resolve(const void* mask, const void* order, int n, void* keep, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  const int fit = (RESOLVE_SMEM / 8 - 1 - words) / (words + 1);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rows = MAX_ROWS_PER_CHUNK;  // a power of two: no chunk straddles two words
  while (rows > fit) rows /= 2;
  const size_t smem = (size_t)(1 + words + rows + rows * words) * sizeof(u64);
  resolve_kernel<<<1, RESOLVE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const int64_t*>(order), n, words, rows,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
