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
// What bounds it on the H100: the scan reads the whole bf16 matrix once per
// call, N x D x 2 bytes (2.3 GB at 1M x 1152, ~0.7 ms at 3.35 TB/s). The
// dots are 2 * Q * N * D flops (37 GFLOP at Q = 16), far below the bf16
// tensor-core rate, so on tensor cores the scan stays memory-bound. The
// per-tile selection is k rounds of a warp-wide max over the tile's scores
// in shared memory: cheap at small k, comparable to the scan at k = 128.
//
// Design for that bound: the layout and load pattern of int8_scan.cu's
// kernels, in bf16. The matrix is row-major (N, D), K-major as the tensor
// cores take it. A warp computes a 16-row x 8-query tile with mma.sync
// m16n8k16 (bf16 in, fp32 accumulation); per 64-element slice of K each lane
// loads 16 + 16 contiguous bytes of two rows straight from global memory and
// the same element positions of its query from shared memory. A dot product
// is a sum over K, so the mma's logical K positions may come from any fixed
// permutation of the physical elements, as long as rows and queries use the
// same one; the one used keeps every load 16 bytes wide. A block owns one
// tile and up to 8 queries: the tile's scores stay in shared memory (8 x
// 2048 x 4 bytes) and one warp per query extracts the top k, so the (Q, N)
// score matrix is never written. Later work: TMA loads, wgmma, a pipelined
// K loop, and a cheaper selection than k rounds at large k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = 16;    // mma M
constexpr int kQueriesPerTile = 8;  // mma N: queries sharing one tile
constexpr int kKSlice = 64;         // bf16 elements of K per load step (4 mma K-steps)
// A taken score in shared memory: a NaN no dot of finite values produces.
constexpr unsigned kTaken = 0x7fffffffu;

// Shared-memory row stride of a query, in elements: D rounded up to the K
// slice, plus 32 elements so two query rows of one mma start in different
// bank halves.
__host__ __device__ __forceinline__ int query_stride(int dim) {
  return (dim + kKSlice - 1) / kKSlice * kKSlice + 32;
}

// Copies queries [q0, q0 + nq) into kQueriesPerTile shared-memory rows of
// query_stride(dim) elements, zero-filling each row's tail and rows past nq.
__device__ __forceinline__ void load_queries(const __nv_bfloat16* __restrict__ q, int q0, int nq,
                                             int dim, __nv_bfloat16* __restrict__ qs) {
  const int stride_words = query_stride(dim) / 2;
  const int dim_words = dim / 2;
  const unsigned* src = reinterpret_cast<const unsigned*>(q + static_cast<size_t>(q0) * dim);
  unsigned* dst = reinterpret_cast<unsigned*>(qs);
  for (int i = threadIdx.x; i < kQueriesPerTile * stride_words; i += kThreads) {
    const int r = i / stride_words;
    const int w = i % stride_words;
    dst[i] = (r < nq && w < dim_words) ? src[static_cast<size_t>(r) * dim_words + w] : 0u;
  }
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

// fp32 dots of rows [row0, row0 + 16) with the 8 queries in shared memory.
// Lane (g = lane / 4, t = lane % 4) ends with
// acc = {dot(row0+g, 2t), dot(row0+g, 2t+1), dot(row0+g+8, 2t), dot(row0+g+8, 2t+1)}
// (the mma's accumulator layout). Rows at or past n_rows read as zero.
__device__ __forceinline__ void mma_rows(const __nv_bfloat16* __restrict__ m, int n_rows, int dim,
                                         int row0, const __nv_bfloat16* __restrict__ qs, int lane,
                                         float (&acc)[4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  const bool ok_lo = row0 + g < n_rows;
  const bool ok_hi = row0 + g + 8 < n_rows;
  const __nv_bfloat16* r_lo = m + static_cast<size_t>(ok_lo ? row0 + g : 0) * dim;
  const __nv_bfloat16* r_hi = m + static_cast<size_t>(ok_hi ? row0 + g + 8 : 0) * dim;
  const __nv_bfloat16* qrow = qs + g * query_stride(dim) + 8 * t;
#pragma unroll 2
  for (int kb = 0; kb < dim; kb += kKSlice) {
    // Elements [kb + 8t, +8) and [kb + 32 + 8t, +8) of each row: each 32-bit
    // word pair (x, y) / (z, w) is one mma step's low-K and high-K operand;
    // the query words come from the same elements.
    const uint4 lo_a = load16(r_lo, kb + 8 * t, dim, ok_lo);
    const uint4 lo_b = load16(r_lo, kb + 32 + 8 * t, dim, ok_lo);
    const uint4 hi_a = load16(r_hi, kb + 8 * t, dim, ok_hi);
    const uint4 hi_b = load16(r_hi, kb + 32 + 8 * t, dim, ok_hi);
    const uint4 qa = *reinterpret_cast<const uint4*>(qrow + kb);
    const uint4 qb = *reinterpret_cast<const uint4*>(qrow + kb + 32);
    mma_bf16(acc, lo_a.x, hi_a.x, lo_a.y, hi_a.y, qa.x, qa.y);
    mma_bf16(acc, lo_a.z, hi_a.z, lo_a.w, hi_a.w, qa.z, qa.w);
    mma_bf16(acc, lo_b.x, hi_b.x, lo_b.y, hi_b.y, qb.x, qb.y);
    mma_bf16(acc, lo_b.z, hi_b.z, lo_b.w, hi_b.w, qb.z, qb.w);
  }
}

// A unique key per (score, row), larger for a higher score and, among equal
// scores, for a lower row: the float's monotonic bits above the inverted
// row. -0.0 counts as +0.0; a taken slot is below every real key.
__device__ __forceinline__ long long order_key(unsigned bits, int row) {
  if (bits == kTaken) return LLONG_MIN;
  if (bits == 0x80000000u) bits = 0u;
  const unsigned mono = bits ^ ((bits >> 31) ? 0xFFFFFFFFu : 0x80000000u);
  const unsigned long long u = (static_cast<unsigned long long>(mono ^ 0x80000000u) << 32) |
                               (0xFFFFFFFFu - static_cast<unsigned>(row));
  return static_cast<long long>(u);
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other > v ? other : v;
  }
  return v;
}

// Grid: one block per (tile, chunk of up to 8 queries), query chunk fastest.
// Shared memory: 8 x tile f32 scores, then 8 query rows.
// out_s / out_i (n_q, tiles * k): per tile, its top k (score, row) pairs
// ordered (score desc, row asc).
__global__ void __launch_bounds__(kThreads)
    topk_tiles_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ m,
                      float* __restrict__ out_s, int* __restrict__ out_i, int n_q, int n_rows,
                      int dim, int n_valid, int tile, int k, int n_qchunks) {
  extern __shared__ uint4 smem_tiles[];
  float* scores = reinterpret_cast<float*>(smem_tiles);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(scores + kQueriesPerTile * tile);
  const int tile_idx = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * kQueriesPerTile;
  const int nq = min(kQueriesPerTile, n_q - q0);
  load_queries(q, q0, nq, dim, qs);
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int base = tile_idx * tile;
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int s = warp * kRowsPerWarp; s < tile; s += kWarps * kRowsPerWarp) {
    float acc[4];
    mma_rows(m, n_rows, dim, base + s, qs, lane, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int local = s + g + (r >> 1) * 8;
      const int qi = 2 * t + (r & 1);
      if (qi < nq) scores[qi * tile + local] = base + local < n_valid ? acc[r] : neg_inf;
    }
  }
  __syncthreads();

  // One warp per query: k rounds of a warp-wide max over the tile's keys.
  // Keys are unique, so exactly one lane owns each maximum; it writes the
  // pair out and marks its slot taken (it alone reads slots i = lane mod 32).
  // Every lane joins the full-mask shuffle, including a lane whose slots are
  // all taken (pos = -1, possible once k > tile / 32).
  const int tiles = (n_rows + tile - 1) / tile;
  for (int qi = warp; qi < nq; qi += kWarps) {
    float* sq = scores + qi * tile;
    const size_t o = static_cast<size_t>(q0 + qi) * tiles * k + static_cast<size_t>(tile_idx) * k;
    for (int r = 0; r < k; ++r) {
      long long best = LLONG_MIN;
      int pos = -1;
      for (int i = lane; i < tile; i += kWarp) {
        const long long key = order_key(__float_as_uint(sq[i]), base + i);
        if (key > best) {
          best = key;
          pos = i;
        }
      }
      const long long top = warp_max(best);
      if (pos >= 0 && best == top) {
        out_s[o + r] = sq[pos];
        out_i[o + r] = base + pos;
        sq[pos] = __uint_as_float(kTaken);
      }
      __syncwarp();
    }
  }
}

size_t smem_optin() {
  int device = 0;
  int bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<size_t>(bytes);
}

}  // namespace

extern "C" {

// Per-tile top-k candidates of q (n_q, dim) bf16 against m (n_rows, dim)
// bf16: out_s (n_q, ceil(n_rows / tile) * k) f32, out_i the same shape
// int32. dim % 8 == 0, both 16-byte aligned, 1 <= k <= tile, tile % 128 == 0.
int tpuclip_topk_tiles(const void* q, const void* m, void* out_s, void* out_i, int n_q,
                       int n_rows, int dim, int n_valid, int tile, int k, void* stream) {
  if (tile % (kWarps * kRowsPerWarp) != 0 || k < 1 || k > tile || dim % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kQueriesPerTile) * tile * sizeof(float) +
                      static_cast<size_t>(kQueriesPerTile) * query_stride(dim) * 2;
  if (smem > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qchunks = (n_q + kQueriesPerTile - 1) / kQueriesPerTile;
  const int tiles = (n_rows + tile - 1) / tile;
  topk_tiles_kernel<<<tiles * n_qchunks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(m),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_q, n_rows, dim, n_valid, tile, k,
      n_qchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
