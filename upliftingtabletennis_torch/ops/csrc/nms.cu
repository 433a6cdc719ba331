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
// The resolve is serial in i: N dependent steps, each a test of bit i and, if
// box i survives, an OR of its row into the running `removed` words. Its floor
// is N times the latency of one step, not the card's rates; serial_chain_kernel
// measures that latency.
//
// Design: the two-phase bitmask of the reference's CUDA NMS
// (vit_pose/vit_utils/nms/nms_kernel.cu), with the resolve on the card.
//   1. overlap_kernel: one block of 64 threads per (64-row, 64-column) tile of
//      the boxes in score order, on or right of the diagonal only (a tile left
//      of it holds no pair j > i). The tile's column boxes and their areas sit in
//      shared memory; each thread owns one row and writes one uint64 word of
//      the (N, ceil(N / 64)) mask, and the zero word of its mirror tile left of
//      the diagonal, so every word is written once and no block does nothing.
//   2. resolve_kernel: one block over chunks of 64 rows, chunk k holding the rows
//      whose diagonal word is word k. Lane 0 of warp 0 carries the serial chain: it
//      holds the chunk's 64 diagonal words in registers and scans them (a row not
//      yet removed is kept and ORs in its diagonal word, which is all that decides
//      the chunk's later rows); then warp 0 ORs the kept rows' next word (word k + 1,
//      the next chunk's diagonal word, two rows per lane) into a register, so the next
//      scan starts at once. The other warps stage each chunk's diagonal and next
//      words in shared memory two chunks ahead (double buffered), write the keep
//      flags, and OR the kept rows into the words right of the next one while warp 0
//      scans the next chunk; their loads that do not need the keep bits (the staged
//      words, the order) go out before they wait for them. Named barriers,
//      alternating by the chunk's parity, order the two sides: warp 0 publishes
//      chunk k's keep bits (A), and waits before chunk k + 2 for the other warps to
//      have finished chunk k (B), which is what chunk k + 2's diagonal word and staged
//      words need.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr int TILE = 64;               // boxes per row or column tile: one bit each in a word
constexpr int RESOLVE_THREADS = 256;   // warp 0 scans; the other 7 warps stage, OR and write
constexpr int OR_THREADS = RESOLVE_THREADS - 32;
constexpr int ROW_GROUPS = 4;          // the OR: each word's 64 rows in 4 groups of 16
constexpr int WORD_SLOTS = OR_THREADS / ROW_GROUPS;
constexpr int MAX_WORDS = 3071;        // the `removed` words in shared memory: 196,544 boxes
constexpr int BAR_A = 1, BAR_B = 3;    // named barriers A(k) = BAR_A + k % 2, B(k) = BAR_B + k % 2

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

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(RESOLVE_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(RESOLVE_THREADS) : "memory");
}

// Block b of the upper triangle of tiles, row by row: (row_tile, col_tile), col >= row.
__device__ __forceinline__ void triangle_tile(long long b, int words, int& row, int& col) {
  // tiles before row r: r * words - r (r - 1) / 2; invert in doubles, then correct
  const double w = words + 0.5;
  int r = static_cast<int>(w - sqrt(w * w - 2.0 * static_cast<double>(b)));
  auto before = [&](long long rr) { return rr * words - rr * (rr - 1) / 2; };
  while (r > 0 && before(r) > b) --r;
  while (before(r + 1) <= b) ++r;
  row = r;
  col = r + static_cast<int>(b - before(r));
}

__global__ void __launch_bounds__(TILE) overlap_kernel(const float4* __restrict__ boxes, int n,
                                                       int words, float thresh,
                                                       u64* __restrict__ mask) {
  int row_tile, col_tile;
  triangle_tile(blockIdx.x, words, row_tile, col_tile);
  __shared__ float4 col_box[TILE];
  __shared__ float col_area[TILE];
  const int j0 = col_tile * TILE;
  const int cols = min(TILE, n - j0);
  if (threadIdx.x < cols) {
    const float4 b = boxes[j0 + threadIdx.x];
    col_box[threadIdx.x] = b;
    col_area[threadIdx.x] = box_area(b);
    // the mirror tile (rows of col_tile, word row_tile) lies left of the diagonal: zero
    if (col_tile > row_tile) mask[static_cast<size_t>(j0 + threadIdx.x) * words + row_tile] = 0ull;
  }
  __syncthreads();
  const int i = row_tile * TILE + threadIdx.x;
  if (i >= n) return;
  const float4 r = boxes[i];
  const float area_r = box_area(r);
  u64 bits = 0ull;
  for (int c = (col_tile == row_tile) ? threadIdx.x + 1 : 0; c < cols; ++c) {
    if (overlaps(r, area_r, col_box[c], col_area[c], thresh)) bits |= 1ull << c;
  }
  mask[static_cast<size_t>(i) * words + col_tile] = bits;
}

// One chunk's serial scan: row rr's diagonal word holds only bits above rr, so bit rr of
// `cur` is final once rows 0 ... rr - 1 are done; a row not yet removed ORs in its word,
// and the rows kept are the bits left clear.
__device__ __forceinline__ u64 scan_chunk(u64 cur, const u64 (&diag)[TILE]) {
#pragma unroll
  for (int rr = 0; rr < TILE; ++rr)
    if (!((cur >> rr) & 1ull)) cur |= diag[rr];
  return cur;
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ u64 sm_cycles() {
  u64 t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t)::"memory");
  return t;
}

// The resolve's serial chain alone, to measure the latency of one step: one thread holds
// 64 diagonal words in registers and runs `chunks` dependent scans over them (each starting
// from the last one's top bit), with no loads, barriers or other warps. It writes the final
// word, then the nanoseconds (%globaltimer) and SM cycles (%clock64) the chain took.
__global__ void __launch_bounds__(32) serial_chain_kernel(const u64* __restrict__ words,
                                                          int chunks, u64* __restrict__ out) {
  if (threadIdx.x) return;
  u64 diag[TILE];
#pragma unroll
  for (int rr = 0; rr < TILE; ++rr) diag[rr] = words[rr];
  u64 cur = 0ull;
  const u64 t0 = global_ns(), c0 = sm_cycles();
#pragma unroll 1
  for (int k = 0; k < chunks; ++k) cur = scan_chunk(cur >> 63, diag);
  out[0] = cur;  // stored before the clocks are read again: the chain is done
  const u64 c1 = sm_cycles(), t1 = global_ns();
  out[1] = t1 - t0;
  out[2] = c1 - c0;
}

struct Stage {
  u64 diag[TILE];  // word k of the chunk's rows (0 past n)
  u64 next[TILE];  // word k + 1 (0 past n or past the last word)
};

// Row t of chunk k: its diagonal word (word k) and next word (word k + 1), 0 past n or
// past the last word.
__device__ __forceinline__ void chunk_words(const u64* __restrict__ mask, int n, int words,
                                            int k, int t, u64& diag, u64& next) {
  const int r = k * TILE + t;
  const bool in = r < n;
  diag = in ? mask[static_cast<size_t>(r) * words + k] : 0ull;
  next = in && k + 1 < words ? mask[static_cast<size_t>(r) * words + k + 1] : 0ull;
}

__global__ void __launch_bounds__(RESOLVE_THREADS) resolve_kernel(
    const u64* __restrict__ mask, const int64_t* __restrict__ order, int n, int words,
    uint8_t* __restrict__ keep) {
  __shared__ u64 removed[MAX_WORDS];  // OR of the kept rows of the chunks done so far
  __shared__ Stage stage[2];          // chunk k in stage[k % 2]
  __shared__ u64 kept_bits[2];        // chunk k's keep bits in kept_bits[k % 2]
  for (int w = threadIdx.x; w < words; w += RESOLVE_THREADS) removed[w] = 0ull;
  if (threadIdx.x < 2 * TILE && threadIdx.x / TILE < words) {  // chunks 0 and 1
    const int k = threadIdx.x / TILE, t = threadIdx.x % TILE;
    chunk_words(mask, n, words, k, t, stage[k].diag[t], stage[k].next[t]);
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // warp 0: the serial chain (lane 0) and the next chunk's head start
    const int lane = threadIdx.x;
    u64 carry = 0ull;  // the previous chunk's kept rows ORed over this chunk's diagonal word
    for (int k = 0; k < words; ++k) {
      if (k >= 2) bar_sync(BAR_B + k % 2);  // chunk k - 2's OR and chunk k's stage are done
      const Stage& s = stage[k % 2];
      const u64 next0 = s.next[lane], next1 = s.next[lane + 32];
      u64 kept = 0ull;
      if (lane == 0) {
        u64 diag[TILE];
#pragma unroll
        for (int rr = 0; rr < TILE; ++rr) diag[rr] = s.diag[rr];
        u64 cur = removed[k] | carry;
        // Whether any row of the chunk overlaps a later one: a chunk where none does
        // skips the scan, and the test needs all 64 words, so the chain below runs on
        // registers (with the loads left to meet it, each step would wait for one).
        u64 any[8] = {};
#pragma unroll
        for (int rr = 0; rr < TILE; ++rr) any[rr % 8] |= diag[rr];
        if ((any[0] | any[1] | any[2] | any[3] | any[4] | any[5] | any[6] | any[7]) != 0ull)
          cur = scan_chunk(cur, diag);
        const int nr = min(TILE, n - k * TILE);
        kept = ~cur & (nr == TILE ? ~0ull : (1ull << nr) - 1);
        kept_bits[k % 2] = kept;
      }
      // the kept rows' next words, lanes l and l + 32 each, ORed across the warp
      kept = __shfl_sync(0xffffffffu, kept, 0);
      const u64 part = (((kept >> lane) & 1ull) ? next0 : 0ull) |
                       (((kept >> (lane + 32)) & 1ull) ? next1 : 0ull);
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(part));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(part >> 32));
      carry = static_cast<u64>(hi) << 32 | lo;
      bar_arrive(BAR_A + k % 2);  // chunk k's keep bits are published
    }
    return;
  }

  // warps 1-7: staging two chunks ahead, the keep flags, the OR right of the next word
  const int t = threadIdx.x - 32;
  const int grp = t / WORD_SLOTS, slot = t % WORD_SLOTS;
  constexpr int GROUP_ROWS = TILE / ROW_GROUPS;
  for (int k = 0; k < words; ++k) {
    // the loads that do not need chunk k's keep bits go out before waiting for them: the
    // staged words of chunk k + 2 and the order of chunk k's rows
    const int r0 = k * TILE;
    const bool ahead = k + 2 < words, row = t < TILE && r0 + t < n;
    u64 diag = 0ull, next = 0ull;
    int64_t dst = 0;
    if (ahead && t < TILE) chunk_words(mask, n, words, k + 2, t, diag, next);
    if (row) dst = order[r0 + t];
    bar_sync(BAR_A + k % 2);  // chunk k's keep bits; warp 0 is done with stage[k % 2]
    const u64 kept = kept_bits[k % 2] >> (grp * GROUP_ROWS);
    if (ahead && t < TILE) {
      stage[k % 2].diag[t] = diag;
      stage[k % 2].next[t] = next;
    }
    if (row) keep[dst] = (kept_bits[k % 2] >> t) & 1ull;
    const u64* rows = mask + static_cast<size_t>(r0 + grp * GROUP_ROWS) * words;
    for (int w = k + 2 + slot; w < words; w += WORD_SLOTS) {
      u64 acc = 0ull;
#pragma unroll
      for (int m = 0; m < GROUP_ROWS; ++m)
        if ((kept >> m) & 1ull) acc |= rows[static_cast<size_t>(m) * words + w];
      if (acc) atomicOr(&removed[w], acc);
    }
    if (ahead) bar_arrive(BAR_B + k % 2);
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
  const long long words = (n + TILE - 1) / TILE;
  overlap_kernel<<<static_cast<unsigned>(words * (words + 1) / 2), TILE, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), n, static_cast<int>(words), thresh,
      static_cast<u64*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// The largest n the resolve takes: its `removed` words must fit in shared memory.
int uttk_nms_max_boxes() { return MAX_WORDS * TILE; }

// The serial chain alone (serial_chain_kernel), for measurement: words (64,) uint64, the
// diagonal words of one chunk; out (3,) uint64 gets the final word, the chain's nanoseconds
// and its SM cycles over chunks * 64 steps. Returns a cudaError_t code.
int uttk_nms_serial_chain(const void* words, int chunks, void* out, void* stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  serial_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(words), chunks, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// mask (n, ceil(n / 64)) uint64 from uttk_nms_overlap; order (n,) int64, the
// original index of each box in score order; keep (n,) uint8, written at
// order[i] for every i. 1 <= n <= uttk_nms_max_boxes(). Returns a cudaError_t code.
int uttk_nms_resolve(const void* mask, const void* order, int n, void* keep, void* stream) {
  const int words = (n + TILE - 1) / TILE;
  if (n < 1 || words > MAX_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<<<1, RESOLVE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const int64_t*>(order), n, words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
