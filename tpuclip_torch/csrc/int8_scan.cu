// int8 scan kernels for the PyTorch port (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, every entry point returns cudaGetLastError().
// No fast-math flags: the epilogue's float(int32) * scale must round exactly
// as the plain PyTorch versions in tpuclip_torch/ops/topk_int8.py do.
//
// Replaces (TPU Pallas kernels):
//   tpuclip/ops/topk_int8.py:_int8_scores_kernel  -> int8_scores_kernel
//   tpuclip/ops/topk_int8.py:_int8_packed_kernel  -> int8_packed_kernel
//   tpuclip/ops/topk_int8.py:_int8_topk_kernel    -> int8_topk_kernel
//
// What bounds them on the H100: the scan reads the whole int8 matrix once
// per call, N x D bytes (about 1.15 GB at 1M x 1152, ~0.35 ms at 3.35 TB/s);
// queries and scales are small. The dot products are 2 * Q * N * D integer
// operations (37 GOP at Q = 16), far below the int8 tensor-core rate, so
// done on tensor cores the scan stays memory-bound up to Q = 64.
//
// The scan: the matrix is row-major (N, D) int8, K-major, as the tensor
// cores take it. A warp computes a 16-row x 8-query tile with mma.sync
// m16n8k32 (int8 in, exact int32 accumulation): per 128-byte slice of K each
// lane loads 16 + 16 contiguous bytes of two rows straight from global
// memory (every 32-byte sector used whole) and the same byte positions of
// its query from shared memory. A dot product is a sum over K, so the mma's
// logical K positions may come from any fixed permutation of the physical
// bytes, as long as rows and queries use the same one; the one used keeps
// every load 16 bytes wide. Queries sit in shared memory for the whole
// block.
//
// Kernels 2 and 3 (per-tile top-k_tile of a 2048-row tile) never write the
// (Q, N) scores: a block scans one tile for its qb queries into shared
// memory (packed int32 keys, or exact f32 scores), then selects. What would
// bound them beside the scan is that selection: the TPU kernel's k_tile
// rounds of max-and-mask, carried over as one warp per query reading the
// whole tile every round, cost k_tile x 2048 shared-memory reads in
// sequence while the block's other warps waited. Here the selection is a
// radix threshold select, then an in-order collect and a one-warp bitonic
// sort (tile_select.cuh, shared with kernel 4): a few passes over 2048 keys,
// whatever k_tile is. Kernel 2's packed keys are unique, so equal keys arise
// only in kernel 3, whose ties go to the lowest row.
//
// What then bounds them is the scan's loads in flight. Shared memory is
// sized from the block's queries: qb x 2048 x 4 bytes of keys, then the qb
// query rows, which the selection reuses as its workspace once the scan is
// done. Up to 8 queries a block has 8 warps (9.4 KB at Q = 1: the 489 tiles
// of a 1M-row matrix are resident at once, ~32 warps per SM). Above 8, a
// block takes 16 queries (two mma groups), so a tile is read once per 16
// queries; their 128 KB of keys leave one block per SM, which gets 32 warps
// to keep the SM's loads in flight (8-query blocks re-read each tile from L2
// once per 8 queries; 16-query blocks of 8 or 16 warps, and a second K slice
// in flight per warp, measured slower: PERF.md). Blocks that share rows are
// adjacent in launch order, so a second query chunk finds the rows in L2.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tile_select.cuh"

namespace {

constexpr int kRowsPerWarp = 16;     // mma M
constexpr int kKSlice = 128;         // bytes of K per load step (4 mma K-steps)
constexpr int kScoreGroups = 4;      // kernel 1: 4 x 8 = 32 queries per block
constexpr unsigned kIdxMask = (1u << 13) - 1u;

// Shared-memory row stride of a query: D rounded up to the K slice, plus
// 64 bytes so the query rows of one mma start in different bank halves.
__host__ __device__ __forceinline__ int query_stride(int dim) {
  return (dim + kKSlice - 1) / kKSlice * kKSlice + 64;
}

// Copies queries [q0, q0 + nq) into `rows` shared-memory rows of
// query_stride(dim) bytes, zero-filling each row's tail and rows past nq.
__device__ __forceinline__ void load_queries(const int8_t* __restrict__ q, int q0, int nq,
                                             int rows, int dim, int8_t* __restrict__ qs) {
  const int stride_words = query_stride(dim) / 4;
  const int dim_words = dim / 4;
  const int* src = reinterpret_cast<const int*>(q + static_cast<size_t>(q0) * dim);
  int* dst = reinterpret_cast<int*>(qs);
  for (int i = threadIdx.x; i < rows * stride_words; i += kThreads) {
    const int r = i / stride_words;
    const int w = i % stride_words;
    dst[i] = (r < nq && w < dim_words) ? src[static_cast<size_t>(r) * dim_words + w] : 0;
  }
}

__device__ __forceinline__ int4 load16(const int8_t* __restrict__ row, int off, int dim,
                                       bool row_ok) {
  if (row_ok && off < dim) return __ldg(reinterpret_cast<const int4*>(row + off));
  return make_int4(0, 0, 0, 0);
}

// c += a (16x32, rows g / g+8) * b (32x8, column g), int8 in, int32 exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// int32 dots of rows [row0, row0 + 16) with `groups` groups of 8 queries in
// shared memory. Lane (g = lane / 4, t = lane % 4) ends with, for group j,
// acc[j] = {dot(row0+g, 8j+2t), dot(row0+g, 8j+2t+1),
//           dot(row0+g+8, 8j+2t), dot(row0+g+8, 8j+2t+1)}
// (the mma's accumulator layout). Rows at or past n_rows read as zero.
template <int kGroups>
__device__ __forceinline__ void mma_rows(const int8_t* __restrict__ m, int n_rows, int dim,
                                         int row0, const int8_t* __restrict__ qs, int groups,
                                         int lane, int (&acc)[kGroups][4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const bool ok_lo = row0 + g < n_rows;
  const bool ok_hi = row0 + g + 8 < n_rows;
  const int8_t* r_lo = m + static_cast<size_t>(ok_lo ? row0 + g : 0) * dim;
  const int8_t* r_hi = m + static_cast<size_t>(ok_hi ? row0 + g + 8 : 0) * dim;
  const int stride = query_stride(dim);
  for (int kb = 0; kb < dim; kb += kKSlice) {
    // Bytes [kb + 16t, +16) and [kb + 64 + 16t, +16) of each row: word i of
    // the first half is mma step i's low-K operand, word i of the second
    // half its high-K operand; the query words come from the same bytes.
    const int4 lo_a = load16(r_lo, kb + 16 * t, dim, ok_lo);
    const int4 lo_b = load16(r_lo, kb + 64 + 16 * t, dim, ok_lo);
    const int4 hi_a = load16(r_hi, kb + 16 * t, dim, ok_hi);
    const int4 hi_b = load16(r_hi, kb + 64 + 16 * t, dim, ok_hi);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      if (j < groups) {
        const int8_t* qrow = qs + (j * kQueriesPerMma + g) * stride + kb + 16 * t;
        const int4 qa = *reinterpret_cast<const int4*>(qrow);
        const int4 qb = *reinterpret_cast<const int4*>(qrow + 64);
        mma_s8(acc[j], lo_a.x, hi_a.x, lo_b.x, hi_b.x, qa.x, qb.x);
        mma_s8(acc[j], lo_a.y, hi_a.y, lo_b.y, hi_b.y, qa.y, qb.y);
        mma_s8(acc[j], lo_a.z, hi_a.z, lo_b.z, hi_b.z, qa.z, qb.z);
        mma_s8(acc[j], lo_a.w, hi_a.w, lo_b.w, hi_b.w, qa.w, qb.w);
      }
    }
  }
}

// The f32 score exactly as the TPU kernel and the plain version form it:
// float(int32 dot) * scale, -inf past n_valid.
__device__ __forceinline__ float score_of(int dot, float scale, bool valid) {
  return valid ? __fmul_rn(__int2float_rn(dot), scale) : __uint_as_float(0xff800000u);
}

// tpuclip/ops/topk_int8.py:_pack_keys, bit for bit: the monotonic unsigned
// float order, low 13 bits replaced by 8191 - lane (ties to the lowest
// lane), biased back to signed.
__device__ __forceinline__ int pack_key(float s, int lane_in_tile) {
  unsigned u = __float_as_uint(s);
  u ^= (u >> 31) ? 0xFFFFFFFFu : 0x80000000u;
  u = (u & ~kIdxMask) | (kIdxMask - (static_cast<unsigned>(lane_in_tile) & kIdxMask));
  return static_cast<int>(u ^ 0x80000000u);
}

// Kernel 1. Grid: one block per (128-row block, group of 32 queries), query
// group fastest. out (n_q, n_rows) f32.
__global__ void __launch_bounds__(kThreads)
    int8_scores_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ m,
                       const float* __restrict__ scales, float* __restrict__ out, int n_q,
                       int n_rows, int dim, int n_valid, int n_qgroups) {
  extern __shared__ int4 smem_scores[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem_scores);
  constexpr int kGroupQueries = kScoreGroups * kQueriesPerMma;
  const int q0 = (blockIdx.x % n_qgroups) * kGroupQueries;
  const int nq = min(kGroupQueries, n_q - q0);
  load_queries(q, q0, nq, kGroupQueries, dim, qs);
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = ((blockIdx.x / n_qgroups) * kWarps + warp) * kRowsPerWarp;
  if (row0 >= n_rows) return;
  int acc[kScoreGroups][4];
  const int groups = (nq + kQueriesPerMma - 1) / kQueriesPerMma;
  mma_rows<kScoreGroups>(m, min(n_rows, n_valid), dim, row0, qs, groups, lane, acc);

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kScoreGroups; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r >> 1) * 8;
      const int qi = j * kQueriesPerMma + 2 * t + (r & 1);
      if (qi < nq && row < n_rows) {
        const bool valid = row < n_valid;
        out[static_cast<size_t>(q0 + qi) * n_rows + row] =
            score_of(acc[j][r], valid ? scales[row] : 0.0f, valid);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 2 and 3: scan of one tile, then a threshold selection per query.
// ---------------------------------------------------------------------------

// As mma_rows, for a block that holds only its own nq queries: a query row
// at or past nq is zero registers, not a shared-memory row.
template <int kGroups>
__device__ __forceinline__ void mma_rows_nq(const int8_t* __restrict__ m, int n_rows, int dim,
                                            int row0, const int8_t* __restrict__ qs, int nq,
                                            int lane, int (&acc)[kGroups][4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const bool ok_lo = row0 + g < n_rows;
  const bool ok_hi = row0 + g + 8 < n_rows;
  const int8_t* r_lo = m + static_cast<size_t>(ok_lo ? row0 + g : 0) * dim;
  const int8_t* r_hi = m + static_cast<size_t>(ok_hi ? row0 + g + 8 : 0) * dim;
  const int stride = query_stride(dim);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int kb = 0; kb < dim; kb += kKSlice) {
    const int4 lo_a = load16(r_lo, kb + 16 * t, dim, ok_lo);
    const int4 lo_b = load16(r_lo, kb + 64 + 16 * t, dim, ok_lo);
    const int4 hi_a = load16(r_hi, kb + 16 * t, dim, ok_hi);
    const int4 hi_b = load16(r_hi, kb + 64 + 16 * t, dim, ok_hi);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      if (j * kQueriesPerMma < nq) {
        const int qi = j * kQueriesPerMma + g;
        const int8_t* qrow = qs + qi * stride + kb + 16 * t;
        const int4 qa = qi < nq ? *reinterpret_cast<const int4*>(qrow) : zero;
        const int4 qb = qi < nq ? *reinterpret_cast<const int4*>(qrow + 64) : zero;
        mma_s8(acc[j], lo_a.x, hi_a.x, lo_b.x, hi_b.x, qa.x, qb.x);
        mma_s8(acc[j], lo_a.y, hi_a.y, lo_b.y, hi_b.y, qa.y, qb.y);
        mma_s8(acc[j], lo_a.z, hi_a.z, lo_b.z, hi_b.z, qa.z, qb.z);
        mma_s8(acc[j], lo_a.w, hi_a.w, lo_b.w, hi_b.w, qa.w, qb.w);
      }
    }
  }
}

// Copies the block's nq query rows into shared memory (query_stride(dim)
// bytes each, zero past dim), with all kBlockThreads threads.
template <int kBlockThreads>
__device__ __forceinline__ void load_block_queries(const int8_t* __restrict__ q, int q0, int nq,
                                                   int dim, int8_t* __restrict__ qs) {
  const int stride_words = query_stride(dim) / 4;
  const int dim_words = dim / 4;
  const int* src = reinterpret_cast<const int*>(q + static_cast<size_t>(q0) * dim);
  int* dst = reinterpret_cast<int*>(qs);
  for (int i = threadIdx.x; i < nq * stride_words; i += kBlockThreads) {
    const int w = i % stride_words;
    dst[i] = w < dim_words ? src[static_cast<size_t>(i / stride_words) * dim_words + w] : 0;
  }
}

// Scans tile rows [base, base + tile) for the block's nq <= 8 kGroups
// queries and hands each (query, tile-local row, score) to `put`. Each of
// the block's warps takes 16-row blocks in turn.
template <int kGroups, class Put>
__device__ __forceinline__ void scan_tile(const int8_t* __restrict__ m,
                                          const float* __restrict__ scales, int n_rows, int dim,
                                          int n_valid, int base, int tile,
                                          const int8_t* __restrict__ qs, int nq, const Put& put) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int dot_limit = min(n_rows, n_valid);
  for (int s = warp * kRowsPerWarp; s < tile; s += block_warps(kGroups) * kRowsPerWarp) {
    int acc[kGroups][4];
    mma_rows_nq<kGroups>(m, dot_limit, dim, base + s, qs, nq, lane, acc);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int local = s + g + (r >> 1) * 8;
        const int qi = j * kQueriesPerMma + 2 * t + (r & 1);
        if (qi < nq) {
          const bool valid = base + local < n_valid;
          put(qi, local, score_of(acc[j][r], valid ? scales[base + local] : 0.0f, valid));
        }
      }
    }
  }
}

// Kernel 2. Grid: one block of block_warps(kGroups) warps per (tile, chunk
// of qb <= 8 kGroups queries), query chunk fastest. Shared memory: qb x tile int32
// keys, then the qb query rows, later the selection's workspace. out (n_q,
// tiles * k_pad) int32: per tile, the top k_tile keys descending, then
// INT32_MIN padding to k_pad.
template <int kTeam, int kGroups>
__global__ void __launch_bounds__(block_warps(kGroups) * kWarp)
    int8_packed_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ m,
                       const float* __restrict__ scales, int* __restrict__ out, int n_q,
                       int n_rows, int dim, int n_valid, int tile, int k_tile, int k_pad,
                       int qb, int n_qchunks) {
  extern __shared__ int4 smem_packed[];
  int* keys = reinterpret_cast<int*>(smem_packed);
  unsigned char* region = reinterpret_cast<unsigned char*>(keys + qb * tile);
  const int tile_idx = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * qb;
  const int nq = min(qb, n_q - q0);
  const int8_t* qs = reinterpret_cast<const int8_t*>(region);
  load_block_queries<block_warps(kGroups) * kWarp>(q, q0, nq, dim, reinterpret_cast<int8_t*>(region));
  __syncthreads();
  scan_tile<kGroups>(m, scales, n_rows, dim, n_valid, tile_idx * tile, tile, qs, nq,
            [&](int qi, int local, float score) { keys[qi * tile + local] = pack_key(score, local); });
  __syncthreads();  // the keys are complete and the query rows dead

  const size_t row_len = static_cast<size_t>(n_rows / tile) * k_pad;
  const size_t first = static_cast<size_t>(q0) * row_len + static_cast<size_t>(tile_idx) * k_pad;
  static_assert(kTeam == kWarp || kGroups == 1, "the block selects as one team only at 8 warps");
  if constexpr (kTeam == kThreads) {
    for (int qi = 0; qi < nq; ++qi) {
      select_topk<kTeam>(PackedKeys{keys + qi * tile}, PackedOut{out + first + qi * row_len},
                         tile, k_tile, k_pad, region);
    }
  } else {
    const int warp = threadIdx.x / kWarp;
    for (int qi = warp; qi < nq; qi += block_warps(kGroups)) {
      select_topk<kTeam>(PackedKeys{keys + qi * tile}, PackedOut{out + first + qi * row_len},
                         tile, k_tile, k_pad, region + warp * kWarpWorkspace);
    }
  }
}

// Kernel 3. Grid, block and shared memory as kernel 2, with qb x tile f32
// scores.
// out_s / out_i (n_q, tiles * k_pad): per tile, its top k_tile (score, row)
// pairs ordered (score desc, row asc), then (-inf, INT32_MAX) to k_pad.
// The scores are kernel 1's, exact; only the selection's key differs from
// kernel 2, which ranks truncated packed keys.
template <int kTeam, int kGroups>
__global__ void __launch_bounds__(block_warps(kGroups) * kWarp)
    int8_topk_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ m,
                     const float* __restrict__ scales, float* __restrict__ out_s,
                     int* __restrict__ out_i, int n_q, int n_rows, int dim, int n_valid, int tile,
                     int k_tile, int k_pad, int qb, int n_qchunks) {
  extern __shared__ int4 smem_topk[];
  float* sc = reinterpret_cast<float*>(smem_topk);
  unsigned char* region = reinterpret_cast<unsigned char*>(sc + qb * tile);
  const int tile_idx = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * qb;
  const int nq = min(qb, n_q - q0);
  const int base = tile_idx * tile;
  const int8_t* qs = reinterpret_cast<const int8_t*>(region);
  load_block_queries<block_warps(kGroups) * kWarp>(q, q0, nq, dim, reinterpret_cast<int8_t*>(region));
  __syncthreads();
  scan_tile<kGroups>(m, scales, n_rows, dim, n_valid, base, tile, qs, nq,
            [&](int qi, int local, float score) { sc[qi * tile + local] = score; });
  __syncthreads();

  const size_t row_len = static_cast<size_t>(n_rows / tile) * k_pad;
  const size_t first = static_cast<size_t>(q0) * row_len + static_cast<size_t>(tile_idx) * k_pad;
  static_assert(kTeam == kWarp || kGroups == 1, "the block selects as one team only at 8 warps");
  if constexpr (kTeam == kThreads) {
    for (int qi = 0; qi < nq; ++qi) {
      const size_t o = first + qi * row_len;
      select_topk<kTeam>(ExactScores{sc + qi * tile}, ExactOut{out_s + o, out_i + o, sc + qi * tile, base},
                         tile, k_tile, k_pad, region);
    }
  } else {
    const int warp = threadIdx.x / kWarp;
    for (int qi = warp; qi < nq; qi += block_warps(kGroups)) {
      const size_t o = first + qi * row_len;
      select_topk<kTeam>(ExactScores{sc + qi * tile}, ExactOut{out_s + o, out_i + o, sc + qi * tile, base},
                         tile, k_tile, k_pad, region + warp * kWarpWorkspace);
    }
  }
}

bool select_args_ok(int n_q, int n_rows, int tile, int k_tile, int k_pad) {
  return n_q >= 1 && tile > 0 && tile % kRowsPerWarp == 0 && n_rows % tile == 0 && k_tile >= 1 &&
         k_tile <= tile && k_tile <= k_pad;
}

}  // namespace

extern "C" {

// scores (n_q, n_rows) f32 of q (n_q, dim) int8 against m (n_rows, dim)
// int8; dim % 16 == 0, both 16-byte aligned.
int tpuclip_int8_scores(const void* q, const void* m, const void* scales, void* out, int n_q,
                        int n_rows, int dim, int n_valid, void* stream) {
  constexpr int kGroupQueries = kScoreGroups * kQueriesPerMma;
  const int n_qgroups = (n_q + kGroupQueries - 1) / kGroupQueries;
  const int rows_per_block = kWarps * kRowsPerWarp;
  const int n_row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(kGroupQueries) * query_stride(dim);
  if (smem > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_scores_kernel<<<n_row_blocks * n_qgroups, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(m),
      static_cast<const float*>(scales), static_cast<float*>(out), n_q, n_rows, dim, n_valid,
      n_qgroups);
  return static_cast<int>(cudaGetLastError());
}

// Per-tile packed top-k_tile keys (n_q, (n_rows / tile) * k_pad) int32;
// dim % 16 == 0, tile % 16 == 0, 1 <= k_tile <= min(tile, k_pad).
int tpuclip_int8_candidates_packed(const void* q, const void* m, const void* scales, void* out,
                                   int n_q, int n_rows, int dim, int n_valid, int tile,
                                   int k_tile, int k_pad, void* stream) {
  if (!select_args_ok(n_q, n_rows, tile, k_tile, k_pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelectLaunch launch = select_launch(n_q, tile, query_stride(dim), k_tile);
  if (launch.qb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = launch.groups == 2 ? int8_packed_kernel<kWarp, 2>
                      : launch.warp_teams ? int8_packed_kernel<kWarp, 1>
                                          : int8_packed_kernel<kThreads, 1>;
  const cudaError_t err = allow_smem(kernel, launch.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qchunks = (n_q + launch.qb - 1) / launch.qb;
  kernel<<<(n_rows / tile) * n_qchunks, block_warps(launch.groups) * kWarp, launch.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(m),
      static_cast<const float*>(scales), static_cast<int*>(out), n_q, n_rows, dim, n_valid,
      tile, k_tile, k_pad, launch.qb, n_qchunks);
  return static_cast<int>(cudaGetLastError());
}

// Per-tile top-k_tile exact (score, row) candidates: out_s (n_q, (n_rows /
// tile) * k_pad) f32, out_i the same shape int32; dim % 16 == 0,
// tile % 16 == 0, 1 <= k_tile <= min(tile, k_pad).
int tpuclip_int8_candidates(const void* q, const void* m, const void* scales, void* out_s,
                            void* out_i, int n_q, int n_rows, int dim, int n_valid, int tile,
                            int k_tile, int k_pad, void* stream) {
  if (!select_args_ok(n_q, n_rows, tile, k_tile, k_pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelectLaunch launch = select_launch(n_q, tile, query_stride(dim), k_tile);
  if (launch.qb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = launch.groups == 2 ? int8_topk_kernel<kWarp, 2>
                      : launch.warp_teams ? int8_topk_kernel<kWarp, 1>
                                          : int8_topk_kernel<kThreads, 1>;
  const cudaError_t err = allow_smem(kernel, launch.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qchunks = (n_q + launch.qb - 1) / launch.qb;
  kernel<<<(n_rows / tile) * n_qchunks, block_warps(launch.groups) * kWarp, launch.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(m),
      static_cast<const float*>(scales), static_cast<float*>(out_s), static_cast<int*>(out_i),
      n_q, n_rows, dim, n_valid, tile, k_tile, k_pad, launch.qb, n_qchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
