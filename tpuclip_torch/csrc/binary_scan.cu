// Packed-binary scan kernels for the PyTorch port (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, every entry point returns cudaGetLastError().
//
// Replaces (TPU Pallas kernels):
//   tpuclip/ops/hamming.py:_binary_scores_kernel  -> tpuclip_binary_scores
//   tpuclip/ops/hamming.py:_binary_topk_q1_kernel -> tpuclip_binary_topk_q1
//   tpuclip/ops/hamming.py:_binary_topk_kernel    -> tpuclip_binary_topk
//
// What they compute: a row's score is popcount(query AND row) over W packed
// uint32 words, the reference's binary dot. Kernel 5 writes every row's
// score as f32 (-inf at or past n_valid). Kernels 6 (one query) and 7 (a
// batch) write the exact top-k of every row ordered (score desc, row asc),
// for any k up to N, rows at or past n_valid scoring INT32_MIN.
//
// What bounds them on the H100: each pass reads the packed matrix once,
// N x W x 4 bytes (1.44 GB at 10M x 1152 bits, ~0.43 ms at 3.35 TB/s). The
// popcounts are Q x N x W (0.36 G at Q = 1), so one query is memory-bound;
// at Q = 16 the popcount rate (16 per SM per clock) is the limit.
//
// Design for that bound: the matrix is row-major (N, W), rows in their
// original order (the TPU's (W, 8, N/8) sublane grouping is not carried
// over). A block stages 256 rows at a time into shared memory with
// coalesced 16-byte loads and gives each thread one row, so each row's
// words are read from device memory once per pass, whatever Q is. Top-k
// needs no per-tile extraction: scores are integers in [0, 32W], so
//   1. a histogram pass counts, per chunk of rows, the rows of each score;
//   2. a prefix pass turns the counts into each (chunk, score)'s first
//      output rank: rows of higher scores first, then earlier chunks;
//   3. a collect pass re-scores the rows in order and writes every row whose
//      rank is below k at its rank; rows of one score within a chunk take
//      consecutive ranks in row order (warp match + a running count).
// Two reads of the matrix, no sort, exact ties. Later work: a pipelined
// staging ring, and a single pass when k is small.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;  // rows per staged sub-tile, one per thread
constexpr int kMaxWords = 64;             // W <= 64: D <= 2048 bits
constexpr int kBatchQueries = 8;          // kernel 7: queries sharing one read of the rows

__host__ __device__ __forceinline__ int score_bins(int w) { return 32 * w + 2; }

// A row's histogram bin: 0 for a row at or past n_valid, score + 1 otherwise.
__device__ __forceinline__ int bin_of(int score, bool valid) { return valid ? score + 1 : 0; }

// Copies rows [row0, row0 + n) of words (n_rows, w) into shared memory.
// row0 % kThreads == 0 and words 16-byte aligned, so the block's first word
// is 16-byte aligned.
__device__ __forceinline__ void stage_rows(const unsigned* __restrict__ words, int w, int row0,
                                           int n, unsigned* __restrict__ tile) {
  const size_t first = static_cast<size_t>(row0) * w;
  const int n_words = n * w;
  const int n_vec = n_words / 4;
  const uint4* src = reinterpret_cast<const uint4*>(words + first);
  uint4* dst = reinterpret_cast<uint4*>(tile);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) dst[i] = __ldg(src + i);
  for (int i = n_vec * 4 + threadIdx.x; i < n_words; i += kThreads) {
    tile[i] = __ldg(words + first + i);
  }
}

// Loads kQ query rows of w words (zero past nq) into shared memory.
template <int kQ>
__device__ __forceinline__ void load_queries(const unsigned* __restrict__ q, int q0, int nq, int w,
                                             unsigned* __restrict__ qs) {
  for (int i = threadIdx.x; i < kQ * w; i += kThreads) {
    qs[i] = i / w < nq ? q[static_cast<size_t>(q0) * w + i] : 0u;
  }
}

// acc[j] = popcount(row AND query j) for this thread's staged row.
template <int kQ>
__device__ __forceinline__ void popcounts(const unsigned* __restrict__ tile,
                                          const unsigned* __restrict__ qs, int w, int (&acc)[kQ]) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = 0;
  const unsigned* row = tile + threadIdx.x * w;
  for (int i = 0; i < w; ++i) {
    const unsigned x = row[i];
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] += __popc(x & qs[j * w + i]);
  }
}

// Kernel 5: out (n_rows,) f32 scores of one query. Grid-stride over sub-tiles.
__global__ void __launch_bounds__(kThreads)
    binary_scores_kernel(const unsigned* __restrict__ q, const unsigned* __restrict__ words,
                         float* __restrict__ out, int n_rows, int w, int n_valid) {
  extern __shared__ uint4 smem_scores[];
  unsigned* tile = reinterpret_cast<unsigned*>(smem_scores);
  unsigned* qs = tile + kThreads * w;
  load_queries<1>(q, 0, 1, w, qs);
  const int n_sub = (n_rows + kThreads - 1) / kThreads;
  for (int sub = blockIdx.x; sub < n_sub; sub += gridDim.x) {
    const int row0 = sub * kThreads;
    const int n = min(kThreads, n_rows - row0);
    __syncthreads();  // the previous sub-tile's reads are done
    stage_rows(words, w, row0, n, tile);
    __syncthreads();
    if (threadIdx.x < n) {
      int acc[1];
      popcounts<1>(tile, qs, w, acc);
      const int row = row0 + threadIdx.x;
      out[row] = row < n_valid ? static_cast<float>(acc[0]) : __uint_as_float(0xff800000u);
    }
  }
}

// Pass 1 of kernels 6/7. Grid: one block per (chunk, group of kQ queries),
// query group fastest. hist (n_q, n_chunks + 1, bins): this pass fills rows
// [0, n_chunks) with the chunk's count of each bin.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
    binary_hist_kernel(const unsigned* __restrict__ q, const unsigned* __restrict__ words,
                       int* __restrict__ hist, int n_q, int n_rows, int w, int n_valid,
                       int chunk_rows, int n_chunks, int n_qgroups) {
  extern __shared__ uint4 smem_hist[];
  unsigned* tile = reinterpret_cast<unsigned*>(smem_hist);
  unsigned* qs = tile + kThreads * w;
  int* h = reinterpret_cast<int*>(qs + kQ * w);
  const int bins = score_bins(w);
  const int chunk = blockIdx.x / n_qgroups;
  const int q0 = (blockIdx.x % n_qgroups) * kQ;
  const int nq = min(kQ, n_q - q0);
  load_queries<kQ>(q, q0, nq, w, qs);
  for (int i = threadIdx.x; i < kQ * bins; i += kThreads) h[i] = 0;
  const int row_end = min(n_rows, (chunk + 1) * chunk_rows);
  for (int row0 = chunk * chunk_rows; row0 < row_end; row0 += kThreads) {
    const int n = min(kThreads, row_end - row0);
    __syncthreads();
    stage_rows(words, w, row0, n, tile);
    __syncthreads();
    if (threadIdx.x < n) {
      int acc[kQ];
      popcounts<kQ>(tile, qs, w, acc);
      const bool valid = row0 + static_cast<int>(threadIdx.x) < n_valid;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (j < nq) atomicAdd(&h[j * bins + bin_of(acc[j], valid)], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * bins; i += kThreads) {
    const int j = i / bins;
    hist[(static_cast<size_t>(q0 + j) * (n_chunks + 1) + chunk) * bins + i % bins] = h[i];
  }
}

// Pass 2a. Grid: (ceil(bins / kThreads), n_q). In place, per (query, bin):
// hist[c][b] becomes the count of bin-b rows in chunks before c, and row
// n_chunks the bin's total.
__global__ void __launch_bounds__(kThreads)
    binary_prefix_kernel(int* __restrict__ hist, int n_chunks, int bins) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= bins) return;
  int* p = hist + static_cast<size_t>(blockIdx.y) * (n_chunks + 1) * bins + b;
  int run = 0;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) {
    const int count = p[static_cast<size_t>(c) * bins];
    p[static_cast<size_t>(c) * bins] = run;
    run += count;
  }
  p[static_cast<size_t>(n_chunks) * bins] = run;
}

// Pass 2b. Grid: n_q blocks of one warp. Row n_chunks of each query's
// histogram becomes, per bin, the count of rows in higher bins (an
// exclusive suffix sum): each lane takes a segment of bins.
__global__ void binary_offsets_kernel(int* __restrict__ hist, int n_chunks, int bins) {
  int* total = hist + (static_cast<size_t>(blockIdx.x) * (n_chunks + 1) + n_chunks) * bins;
  const int lane = threadIdx.x;
  const int seg = (bins + kWarp - 1) / kWarp;
  const int lo = min(bins, lane * seg);
  const int hi = min(bins, lo + seg);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += total[b];
  int above = sum;  // inclusive suffix over lanes >= lane
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int v = __shfl_down_sync(0xffffffffu, above, o);
    if (lane + o < kWarp) above += v;
  }
  above -= sum;
  for (int b = hi - 1; b >= lo; --b) {
    const int count = total[b];
    total[b] = above;
    above += count;
  }
}

// Pass 3. Same grid as pass 1. Each (query, bin) starts at the rank that
// passes 2a/2b give this chunk and counts up in row order; a row whose rank
// is below k is written there. out_m (n_q, k) int32 scores (INT32_MIN past
// n_valid), out_r (n_q, k) int64 rows.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
    binary_collect_kernel(const unsigned* __restrict__ q, const unsigned* __restrict__ words,
                          const int* __restrict__ hist, int* __restrict__ out_m,
                          long long* __restrict__ out_r, int n_q, int n_rows, int w, int n_valid,
                          int chunk_rows, int n_chunks, int n_qgroups, int k) {
  extern __shared__ uint4 smem_collect[];
  unsigned* tile = reinterpret_cast<unsigned*>(smem_collect);
  unsigned* qs = tile + kThreads * w;
  int* next = reinterpret_cast<int*>(qs + kQ * w);  // next rank per (query, bin)
  const int bins = score_bins(w);
  const int chunk = blockIdx.x / n_qgroups;
  const int q0 = (blockIdx.x % n_qgroups) * kQ;
  const int nq = min(kQ, n_q - q0);
  load_queries<kQ>(q, q0, nq, w, qs);
  for (int i = threadIdx.x; i < nq * bins; i += kThreads) {
    const int* hq = hist + static_cast<size_t>(q0 + i / bins) * (n_chunks + 1) * bins;
    next[i] = hq[static_cast<size_t>(chunk) * bins + i % bins] +
              hq[static_cast<size_t>(n_chunks) * bins + i % bins];
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row_end = min(n_rows, (chunk + 1) * chunk_rows);
  for (int row0 = chunk * chunk_rows; row0 < row_end; row0 += kThreads) {
    const int n = min(kThreads, row_end - row0);
    __syncthreads();
    stage_rows(words, w, row0, n, tile);
    __syncthreads();
    const bool exists = static_cast<int>(threadIdx.x) < n;
    const int row = row0 + threadIdx.x;
    int acc[kQ];
    if (exists) popcounts<kQ>(tile, qs, w, acc);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (j >= nq) break;  // nq is the same for the whole block
      int* nj = next + j * bins;
      const int bin = exists ? bin_of(acc[j], row < n_valid) : 0;
      // Ranks only grow, so a row whose bin is already at k stays out.
      const bool cand = exists && nj[bin] < k;
      if (!__syncthreads_or(cand)) continue;
      // Warps in row order; within a warp, lanes of one bin rank by lane.
      for (int turn = 0; turn < kWarps; ++turn) {
        if (warp == turn) {
          const unsigned mask = __ballot_sync(0xffffffffu, cand);
          if (cand) {
            const unsigned peers = __match_any_sync(mask, bin);
            const int rank = __popc(peers & ((1u << lane) - 1u));
            const int pos = nj[bin] + rank;
            __syncwarp(mask);
            if (rank == 0) nj[bin] += __popc(peers);
            if (pos < k) {
              const size_t o = static_cast<size_t>(q0 + j) * k + pos;
              out_m[o] = bin > 0 ? bin - 1 : INT_MIN;
              out_r[o] = row;
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

int sm_count() {
  int device = 0;
  int count = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  return count;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kQ>
int binary_topk(const void* q, const void* words, void* hist, void* out_m, void* out_r, int n_q,
                int n_rows, int w, int n_valid, int k, int chunk_rows, void* stream) {
  if (w < 1 || w > kMaxWords || chunk_rows % kThreads != 0 || k < 1 || k > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bins = score_bins(w);
  const int n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const int n_qgroups = (n_q + kQ - 1) / kQ;
  const size_t smem = static_cast<size_t>(kThreads) * w * 4 + static_cast<size_t>(kQ) * w * 4 +
                      static_cast<size_t>(kQ) * bins * 4;
  cudaError_t err = allow_smem(binary_hist_kernel<kQ>, smem);
  if (err == cudaSuccess) err = allow_smem(binary_collect_kernel<kQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned* qw = static_cast<const unsigned*>(q);
  const unsigned* mw = static_cast<const unsigned*>(words);
  int* h = static_cast<int*>(hist);
  binary_hist_kernel<kQ><<<n_chunks * n_qgroups, kThreads, smem, s>>>(
      qw, mw, h, n_q, n_rows, w, n_valid, chunk_rows, n_chunks, n_qgroups);
  binary_prefix_kernel<<<dim3((bins + kThreads - 1) / kThreads, n_q), kThreads, 0, s>>>(
      h, n_chunks, bins);
  binary_offsets_kernel<<<n_q, kWarp, 0, s>>>(h, n_chunks, bins);
  binary_collect_kernel<kQ><<<n_chunks * n_qgroups, kThreads, smem, s>>>(
      qw, mw, h, static_cast<int*>(out_m), static_cast<long long*>(out_r), n_q, n_rows, w,
      n_valid, chunk_rows, n_chunks, n_qgroups, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel 5: scores (n_rows,) f32 of q (w,) against words (n_rows, w), both
// uint32; words 16-byte aligned.
int tpuclip_binary_scores(const void* q, const void* words, void* out, int n_rows, int w,
                          int n_valid, void* stream) {
  if (w < 1 || w > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kThreads) + 1) * w * 4;
  cudaError_t err = allow_smem(binary_scores_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sub = (n_rows + kThreads - 1) / kThreads;
  const int grid = n_sub < sm_count() * 8 ? n_sub : sm_count() * 8;
  binary_scores_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(q), static_cast<const unsigned*>(words),
      static_cast<float*>(out), n_rows, w, n_valid);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 6: exact top-k of one query q (w,) over words (n_rows, w). hist is
// int32 scratch of (n_chunks + 1) * (32w + 2) entries, n_chunks =
// ceil(n_rows / chunk_rows); out_m (k,) int32, out_r (k,) int64.
int tpuclip_binary_topk_q1(const void* q, const void* words, void* hist, void* out_m,
                           void* out_r, int n_rows, int w, int n_valid, int k, int chunk_rows,
                           void* stream) {
  return binary_topk<1>(q, words, hist, out_m, out_r, 1, n_rows, w, n_valid, k, chunk_rows,
                        stream);
}

// Kernel 7: the same for n_q queries q (n_q, w); hist holds n_q such
// blocks, out_m / out_r are (n_q, k).
int tpuclip_binary_topk(const void* q, const void* words, void* hist, void* out_m, void* out_r,
                        int n_q, int n_rows, int w, int n_valid, int k, int chunk_rows,
                        void* stream) {
  return binary_topk<kBatchQueries>(q, words, hist, out_m, out_r, n_q, n_rows, w, n_valid, k,
                                    chunk_rows, stream);
}

}  // extern "C"
