// bf16 scan + per-tile top-k for the PyTorch port (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces (TPU Pallas kernel):
//   tpuclip/ops/topk.py:_iterative_topk_kernel -> topk_tiles_kernel
//
// What it computes: for each query and each tile of `tile` rows, the fp32
// dots of the bf16 query with the bf16 rows (fp32 accumulation), -inf for
// rows at or past n_valid, and the tile's top k ordered (score desc, row
// asc), as (score, row) pairs. The wrapper (tpuclip_torch/ops/topk.py)
// merges the tiles' candidates into the exact top-k, as _final_merge does.
//
// What bounds it on the H100: the scan reads the valid bf16 rows once per
// call, N x D x 2 bytes (2.3 GB at 1M x 1152, ~0.69 ms at 3.35 TB/s). The
// dots are 2 * Q * N * D flops (37 GFLOP at Q = 16), far below the bf16
// tensor-core rate, so on tensor cores the scan stays memory-bound.
//
// Design for that bound: kernel 3's (int8_scan.cu), in bf16. The matrix is
// row-major (N, D), K-major as the tensor cores take it. A warp computes a
// 16-row x 8-query tile with mma.sync m16n8k16 (bf16 in, fp32
// accumulation); per 64-element slice of K each lane loads 16 + 16
// contiguous bytes of two rows straight from global memory and the same
// element positions of its query from shared memory. A dot product is a sum
// over K, so the mma's logical K positions may come from any fixed
// permutation of the physical elements, as long as rows and queries use the
// same one; the one used keeps every load 16 bytes wide. A block owns one
// tile and qb queries; the tile's exact f32 scores stay in shared memory, so
// the (Q, N) score matrix is never written, and each query's top k is taken
// by tile_select.cuh's radix threshold select (a few passes over the 2048
// scores, whatever k is) instead of the TPU kernel's k rounds of a max over
// the whole tile. Shared memory is sized from the block's queries (qb x
// 2048 x 4 bytes, then the qb query rows, reused as the selection's
// workspace): 10.5 KB at Q = 1, so the 489 tiles of a 1M-row matrix are
// resident at once, ~30 warps per SM of loads in flight. Above 8 queries a
// block takes 16 (two mma groups share each row fragment, 32 warps), so a
// tile is read once per 16 queries. Rows at or past n_valid are not read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tile_select.cuh"

namespace {

constexpr int kRowsPerWarp = 16;  // mma M
constexpr int kKSlice = 64;       // bf16 elements of K per load step (4 mma K-steps)

// Shared-memory row stride of a query, in elements: D rounded up to the K
// slice, plus 32 elements so two query rows of one mma start in different
// bank halves.
__host__ __device__ __forceinline__ int query_stride(int dim) {
  return (dim + kKSlice - 1) / kKSlice * kKSlice + 32;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* __restrict__ row, int off, int dim,
                                        bool row_ok) {
  if (row_ok && off < dim) return __ldg(reinterpret_cast<const uint4*>(row + off));
  return make_uint4(0u, 0u, 0u, 0u);
}

// c += a (16x16, rows g / g+8) * b (16x8, column g); bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// fp32 dots of rows [row0, row0 + 16) with the block's nq queries in
// shared memory, in kGroups groups of 8. Lane (g = lane / 4, t = lane % 4)
// ends with, for group j,
// acc[j] = {dot(row0+g, 8j+2t), dot(row0+g, 8j+2t+1),
//           dot(row0+g+8, 8j+2t), dot(row0+g+8, 8j+2t+1)}
// (the mma's accumulator layout). Rows at or past n_rows read as zero; a
// query at or past nq is zero registers.
template <int kGroups>
__device__ __forceinline__ void mma_rows(const __nv_bfloat16* __restrict__ m, int n_rows, int dim,
                                         int row0, const __nv_bfloat16* __restrict__ qs, int nq,
                                         int lane, float (&acc)[kGroups][4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const bool ok_lo = row0 + g < n_rows;
  const bool ok_hi = row0 + g + 8 < n_rows;
  const __nv_bfloat16* r_lo = m + static_cast<size_t>(ok_lo ? row0 + g : 0) * dim;
  const __nv_bfloat16* r_hi = m + static_cast<size_t>(ok_hi ? row0 + g + 8 : 0) * dim;
  const int stride = query_stride(dim);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int kb = 0; kb < dim; kb += kKSlice) {
    // Elements [kb + 8t, +8) and [kb + 32 + 8t, +8) of each row: each 32-bit
    // word pair (x, y) / (z, w) is one mma step's low-K and high-K operand;
    // the query words come from the same elements.
    const uint4 lo_a = load16(r_lo, kb + 8 * t, dim, ok_lo);
    const uint4 lo_b = load16(r_lo, kb + 32 + 8 * t, dim, ok_lo);
    const uint4 hi_a = load16(r_hi, kb + 8 * t, dim, ok_hi);
    const uint4 hi_b = load16(r_hi, kb + 32 + 8 * t, dim, ok_hi);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      if (j * kQueriesPerMma < nq) {
        const int qi = j * kQueriesPerMma + g;
        const __nv_bfloat16* qrow = qs + qi * stride + kb + 8 * t;
        const uint4 qa = qi < nq ? *reinterpret_cast<const uint4*>(qrow) : zero;
        const uint4 qb = qi < nq ? *reinterpret_cast<const uint4*>(qrow + 32) : zero;
        mma_bf16(acc[j], lo_a.x, hi_a.x, lo_a.y, hi_a.y, qa.x, qa.y);
        mma_bf16(acc[j], lo_a.z, hi_a.z, lo_a.w, hi_a.w, qa.z, qa.w);
        mma_bf16(acc[j], lo_b.x, hi_b.x, lo_b.y, hi_b.y, qb.x, qb.y);
        mma_bf16(acc[j], lo_b.z, hi_b.z, lo_b.w, hi_b.w, qb.z, qb.w);
      }
    }
  }
}

// Copies the block's nq query rows into shared memory (query_stride(dim)
// elements each, zero past dim), with all kBlockThreads threads.
template <int kBlockThreads>
__device__ __forceinline__ void load_block_queries(const __nv_bfloat16* __restrict__ q, int q0,
                                                   int nq, int dim, __nv_bfloat16* __restrict__ qs) {
  const int stride_words = query_stride(dim) / 2;
  const int dim_words = dim / 2;
  const unsigned* src = reinterpret_cast<const unsigned*>(q + static_cast<size_t>(q0) * dim);
  unsigned* dst = reinterpret_cast<unsigned*>(qs);
  for (int i = threadIdx.x; i < nq * stride_words; i += kBlockThreads) {
    const int w = i % stride_words;
    dst[i] = w < dim_words ? src[static_cast<size_t>(i / stride_words) * dim_words + w] : 0u;
  }
}

// Grid: one block of block_warps(kGroups) warps per (tile, chunk of qb <=
// 8 kGroups queries), query chunk fastest, so the blocks that share a tile
// run together and a second chunk finds its rows in L2. Shared memory: qb x
// tile f32 scores, then the qb query rows, later the selection's workspace.
// out_s / out_i (n_q, tiles * k): per tile, its top k (score, row) pairs
// ordered (score desc, row asc).
// Launch bounds: 64 registers a thread either way, so that four 8-warp
// blocks (Q <= 8) or one 32-warp block share an SM.
template <int kTeam, int kGroups>
__global__ void __launch_bounds__(block_warps(kGroups) * kWarp, kGroups == 1 ? 4 : 1)
    topk_tiles_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ m,
                      float* __restrict__ out_s, int* __restrict__ out_i, int n_q, int n_rows,
                      int dim, int n_valid, int tile, int k, int qb, int n_qchunks) {
  constexpr int kBlockWarps = block_warps(kGroups);
  extern __shared__ uint4 smem_tiles[];
  float* sc = reinterpret_cast<float*>(smem_tiles);
  unsigned char* region = reinterpret_cast<unsigned char*>(sc + qb * tile);
  const int tile_idx = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * qb;
  const int nq = min(qb, n_q - q0);
  const int base = tile_idx * tile;
  const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(region);
  load_block_queries<kBlockWarps * kWarp>(q, q0, nq, dim, reinterpret_cast<__nv_bfloat16*>(region));
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int dot_limit = min(n_rows, n_valid);
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int s = warp * kRowsPerWarp; s < tile; s += kBlockWarps * kRowsPerWarp) {
    float acc[kGroups][4];
    mma_rows<kGroups>(m, dot_limit, dim, base + s, qs, nq, lane, acc);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int local = s + g + (r >> 1) * 8;
        const int qi = j * kQueriesPerMma + 2 * t + (r & 1);
        if (qi < nq) sc[qi * tile + local] = base + local < n_valid ? acc[j][r] : neg_inf;
      }
    }
  }
  __syncthreads();  // the scores are complete and the query rows dead

  const int tiles = (n_rows + tile - 1) / tile;
  const size_t row_len = static_cast<size_t>(tiles) * k;
  const size_t first = static_cast<size_t>(q0) * row_len + static_cast<size_t>(tile_idx) * k;
  static_assert(kTeam == kWarp || kGroups == 1, "the block selects as one team only at 8 warps");
  if constexpr (kTeam == kThreads) {
    for (int qi = 0; qi < nq; ++qi) {
      const size_t o = first + qi * row_len;
      select_topk<kTeam>(ExactScores{sc + qi * tile}, ExactOut{out_s + o, out_i + o, sc + qi * tile, base},
                         tile, k, k, region);
    }
  } else {
    for (int qi = warp; qi < nq; qi += kBlockWarps) {
      const size_t o = first + qi * row_len;
      select_topk<kTeam>(ExactScores{sc + qi * tile}, ExactOut{out_s + o, out_i + o, sc + qi * tile, base},
                         tile, k, k, region + warp * kWarpWorkspace);
    }
  }
}

}  // namespace

extern "C" {

// Per-tile top-k candidates of q (n_q, dim) bf16 against m (n_rows, dim)
// bf16: out_s (n_q, ceil(n_rows / tile) * k) f32, out_i the same shape
// int32. dim % 8 == 0, both 16-byte aligned, 1 <= k <= tile, tile % 16 == 0.
int tpuclip_topk_tiles(const void* q, const void* m, void* out_s, void* out_i, int n_q,
                       int n_rows, int dim, int n_valid, int tile, int k, void* stream) {
  if (n_q < 1 || n_rows < 1 || tile <= 0 || tile % kRowsPerWarp != 0 || k < 1 || k > tile ||
      dim % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelectLaunch launch = select_launch(n_q, tile, query_stride(dim) * 2, k);
  if (launch.qb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = launch.groups == 2 ? topk_tiles_kernel<kWarp, 2>
                      : launch.warp_teams ? topk_tiles_kernel<kWarp, 1>
                                          : topk_tiles_kernel<kThreads, 1>;
  const cudaError_t err = allow_smem(kernel, launch.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qchunks = (n_q + launch.qb - 1) / launch.qb;
  const int tiles = (n_rows + tile - 1) / tile;
  kernel<<<tiles * n_qchunks, block_warps(launch.groups) * kWarp, launch.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(m),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_q, n_rows, dim, n_valid, tile, k,
      launch.qb, n_qchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
