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
// What bounds them on the H100: the packed matrix, N x W x 4 bytes (1.44 GB
// at 10M x 1152 bits, ~0.43 ms at 3.35 TB/s). Kernel 5 popcounts with
// __popc, 16 per SM per clock (~0.086 ms per query at 10M x 36 words,
// 1.98 GHz), so one query is bound by the bytes. Kernels 6 and 7 do the
// same AND + popcount on the binary tensor cores (mma.sync m16n8k256 b1,
// .and.popc), whose rate the published tables do not give: chip_smoke.py
// measures it, and with it the bytes bound kernels 6 and 7 at every Q up to
// 64 (PERF.md). Their other traffic is the scratch: a uint16 per (query,
// row) written once and read back once by the collect (2 x 20 MB a query at
// 10M rows).
//
// Design for that bound: the matrix is row-major (N, W), rows in their
// original order (the TPU's (W, 8, N/8) sublane grouping is not carried
// over). Scores are integers in [0, 32W], so the top-k needs no sort: a
// histogram of the scores says which bin holds the k-th row, and every row
// of a higher bin is in. Kernels 6 and 7 run three passes on the stream,
// after a memset of the histograms:
//   1. (pass 1) each (row, query) score is computed once, from one read of
//      the words per 16 queries. A block takes one chunk of rows and up to
//      16 queries (a template: one 8-query mma tile up to Q = 8, held to 64
//      registers so that 4 blocks per SM keep the loads in flight that the
//      bytes need; two tiles above). Each warp stages its own 32 rows of a
//      256-row sub-tile into shared memory with coalesced 16-byte loads (a
//      row stride that keeps the mma's loads free of bank conflicts) and
//      only warp barriers, so one warp's loads overlap another's products;
//      it scores them as two 16-row tiles, one b1 mma per 256-bit slice of
//      the words. Each (row, query) bin (score + 1, or 0 past n_valid) is
//      written as a uint16 into a (Q, N) scratch and counted in the chunk's
//      shared histogram, one atomic each into 16-bit counters packed two to
//      a word (aggregating a warp's equal bins with __match_any_sync
//      measured 10% slower on random bits). At the end the block stores the
//      chunk's nonzero counts and adds them to the query's totals;
//   2. (pass 2) one block per query turns the totals into each bin's first
//      output rank (rows of higher bins first), finds the threshold bin T
//      that holds rank k - 1 and the highest bin in use, and, for those bins
//      only, turns the chunks' counts into each chunk's first rank in the
//      bin;
//   3. (pass 3) one block per (chunk, query) reads back the uint16 bins of
//      its rows, not the words: no popcount, 2 bytes a row. A chunk whose
//      rows cannot reach rank k returns at once. The others list their rows
//      of bins T and above in row order (a block prefix count) and give each
//      the next rank of its bin (warp match + a running count); a row whose
//      rank is below k is written there. Ties therefore go to the lowest
//      row, as the plain version orders them.
// No sort, exact ties; the collect's cost follows the rows at or above the
// threshold bin, not N (PERF.md).
//
// Scratch (the wrapper allocates it; the kernels allocate nothing), in this
// order, int32 then uint16:
//   hist  (n_q, bins, n_chunks + 1) per-chunk counts, then first ranks
//   tot   (n_q, bins)               totals, then first ranks of each bin
//   meta  (n_q, 4)                  threshold bin, highest bin
//   bins  (n_q, round_up(n_rows, 8)) uint16, 16-byte aligned
// bins = 32W + 2; chunk_rows <= 65,280 keeps a chunk's counts in 16 bits. At
// 10M rows and 528 chunks that is 22.4 MB a query (1.44 GB at Q = 64).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;  // rows per staged sub-tile, one per thread
constexpr int kMaxWords = 64;             // W <= 64: D <= 2048 bits
constexpr int kMmaQueries = 8;            // pass 1: the N of one b1 mma
constexpr int kSliceWords = 8;            // pass 1: 256 bits, the K of one b1 mma
constexpr int kMaxChunkRows = 255 * kThreads;  // 65,280: 16-bit histogram counters
constexpr int kCollectRows = 8 * kThreads;     // pass 3: rows a block reads at once (11 bits)
constexpr int kThresholdThreads = 1024;        // pass 2: one block per query

__host__ __device__ __forceinline__ int score_bins(int w) { return 32 * w + 2; }

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

// ---------------------------------------------------------------------------
// Kernels 6 and 7
// ---------------------------------------------------------------------------

// Words between two staged rows in pass 1, the least >= w that is 4 mod 8:
// lane (g, t) of an mma reads word t (+ 8i, + 4) of row g, so the 32 lanes
// hit banks 4g' + t for 8 distinct g' and read free of bank conflicts.
__host__ __device__ __forceinline__ int tile_stride(int w) { return (w + 3) / 8 * 8 + 4; }

__host__ __device__ __forceinline__ int packed_bins(int w) { return (score_bins(w) + 1) / 2; }

// Offsets into the scratch (layout in the header).
struct Scratch {
  int* hist;
  int* tot;
  int* meta;
  unsigned short* bins;
  size_t zero_bytes;  // hist + tot + meta, cleared before pass 1
};

__host__ __device__ __forceinline__ int bins_stride(int n_rows) { return (n_rows + 7) / 8 * 8; }

Scratch scratch_layout(void* base, int n_q, int n_rows, int w, int n_chunks) {
  const size_t bins = score_bins(w);
  const size_t n_hist = static_cast<size_t>(n_q) * bins * (n_chunks + 1);
  const size_t n_tot = static_cast<size_t>(n_q) * bins;
  const size_t ints = n_hist + n_tot + static_cast<size_t>(n_q) * 4;
  Scratch s;
  s.hist = static_cast<int*>(base);
  s.tot = s.hist + n_hist;
  s.meta = s.tot + n_tot;
  s.zero_bytes = ints * 4;
  s.bins = reinterpret_cast<unsigned short*>(static_cast<char*>(base) + (s.zero_bytes + 15) / 16 * 16);
  return s;
}

// One warp copies rows [row0, row0 + n) of words (n_rows, w), n <= 32,
// into shared memory at tile_stride(w) words a row. row0 % kWarp == 0 and
// words 16-byte aligned, so with w % 4 == 0 every source 16-byte group is
// aligned.
__device__ __forceinline__ void stage_warp_rows(const unsigned* __restrict__ words, int w,
                                                int stride, int row0, int n, int lane,
                                                unsigned* __restrict__ tile) {
  const size_t first = static_cast<size_t>(row0) * w;
  if (w % 4 == 0) {
    const int w4 = w / 4;
    const int s4 = stride / 4;
    const uint4* src = reinterpret_cast<const uint4*>(words + first);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int i = lane; i < n * w4; i += kWarp) {
      const int r = i / w4;
      dst[r * s4 + i - r * w4] = __ldg(src + i);
    }
  } else {
    for (int i = lane; i < n * w; i += kWarp) {
      const int r = i / w;
      tile[r * stride + i - r * w] = __ldg(words + first + i);
    }
  }
}

// D += popcount(A AND B) on the binary tensor cores: A 16 x 256 bits (rows),
// B 256 x 8 bits (queries), D 16 x 8 int32. Lane (g = lane / 4, t = lane %
// 4) holds a0 / a2 = row g's bits 32t.. / 128 + 32t.., a1 / a3 the same of
// row g + 8, b0 / b1 query g's bits 32t.. / 128 + 32t.., and d = (row g,
// query 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A popcount is a sum
// over K, so any fixed assignment of words to K positions serves, as long as
// rows and queries share it: lane t takes words t and t + 4 of each 8-word
// slice.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__host__ __device__ __forceinline__ int word_slices(int w) {
  return (w + kSliceWords - 1) / kSliceWords;
}

// Pass 1's shared memory with kTiles query tiles a block: the staged rows,
// the staged queries, and the histograms of a block's queries (kTiles x 8,
// or fewer when n_q is).
template <int kTiles>
size_t bins_smem(int w, int n_q) {
  const int group = kTiles * kMmaQueries;
  return (static_cast<size_t>(kThreads) * tile_stride(w) +
          static_cast<size_t>(group) * word_slices(w) * kSliceWords +
          static_cast<size_t>(n_q < group ? n_q : group) * packed_bins(w)) * 4;
}

// Pass 1. Grid: n_chunks * n_groups blocks, group fastest (the groups of a
// chunk read its rows at about the same time). Block b scores the up to
// kTiles x 8 queries from (b % n_groups) * kTiles * 8 over the rows of chunk
// b / n_groups: warp i stages rows 32i .. 32i + 31 of each 256-row sub-tile
// on its own (warp barriers only, so one warp's loads overlap another's
// products), then scores them as two 16-row tiles against each 8-query tile
// with one b1 mma per 256-bit slice of the words (the last slice's words
// past w meet zero query words). At least 4 blocks per SM with one tile
// (<= 64 registers: the bytes need the warps in flight), 2 with two (their
// shared memory allows no more).
template <int kTiles>
__global__ void __launch_bounds__(kThreads, kTiles == 1 ? 4 : 2)
    binary_bins_kernel(const unsigned* __restrict__ q, const unsigned* __restrict__ words,
                       Scratch sc, int n_q, int n_groups, int n_rows, int w, int n_valid,
                       int chunk_rows, int n_chunks) {
  extern __shared__ uint4 smem_bins[];
  const int stride = tile_stride(w);
  const int n_slices = word_slices(w);
  const int qw = n_slices * kSliceWords;  // words of a staged query, zero past w
  unsigned* tile = reinterpret_cast<unsigned*>(smem_bins);
  unsigned* qs = tile + kThreads * stride;
  constexpr int kGroup = kTiles * kMmaQueries;
  unsigned* h = qs + kGroup * qw;  // (nq, packed_bins) words: bin b in half b % 2 of word b / 2
  const int bins = score_bins(w);
  const int hw = packed_bins(w);
  const int chunk = blockIdx.x / n_groups;
  const int q0 = (blockIdx.x % n_groups) * kGroup;
  const int nq = min(kGroup, n_q - q0);
  for (int i = threadIdx.x; i < kGroup * qw; i += kThreads) {
    const int j = i / qw;
    const int c = i - j * qw;
    qs[i] = j < nq && c < w ? q[static_cast<size_t>(q0 + j) * w + c] : 0u;
  }
  for (int i = threadIdx.x; i < nq * hw; i += kThreads) h[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n_tiles = (nq + kMmaQueries - 1) / kMmaQueries;  // the same for the whole block
  unsigned bq[kTiles][kMaxWords / kSliceWords][2];         // B fragments of every slice
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int sl = 0; sl < kMaxWords / kSliceWords; ++sl) {
      const unsigned* qr = qs + (nt * kMmaQueries + g) * qw + sl * kSliceWords + t;
      const bool used = nt < n_tiles && sl < n_slices;
      bq[nt][sl][0] = used ? qr[0] : 0u;
      bq[nt][sl][1] = used ? qr[4] : 0u;
    }
  }
  unsigned* rows = tile + warp * kWarp * stride;  // this warp's 32 staged rows
  const size_t n_stride = bins_stride(n_rows);
  const int row_end = min(n_rows, (chunk + 1) * chunk_rows);
  for (int row0 = chunk * chunk_rows + warp * kWarp; row0 < row_end; row0 += kThreads) {
    const int n = min(kWarp, row_end - row0);
    __syncwarp();  // the previous rows' reads are done
    stage_warp_rows(words, w, stride, row0, n, lane, rows);
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // Rows past n hold stale words, and the last slice reads up to 7
      // words past a row's end (still inside shared memory): never used.
      const unsigned* lo = rows + (mt * 16 + g) * stride + t;
      const unsigned* hi = lo + 8 * stride;
      int d[kTiles][4] = {};
#pragma unroll
      for (int sl = 0; sl < kMaxWords / kSliceWords; ++sl) {
        if (sl < n_slices) {
          const int o = sl * kSliceWords;
          const unsigned a0 = lo[o], a1 = hi[o], a2 = lo[o + 4], a3 = hi[o + 4];
#pragma unroll
          for (int nt = 0; nt < kTiles; ++nt) {
            if (nt < n_tiles) mma_and_popc(d[nt], a0, a1, a2, a3, bq[nt][sl][0], bq[nt][sl][1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + (e >> 1) * 8;
          const int j = nt * kMmaQueries + 2 * t + (e & 1);
          if (nt < n_tiles && r < n && j < nq) {
            const int row = row0 + r;
            const int bin = row < n_valid ? d[nt][e] + 1 : 0;
            sc.bins[(q0 + j) * n_stride + row] = static_cast<unsigned short>(bin);
            atomicAdd(h + j * hw + (bin >> 1), 1u << ((bin & 1) * 16));
          }
        }
      }
    }
  }
  __syncthreads();
  const int len = n_chunks + 1;
  for (int i = threadIdx.x; i < nq * bins; i += kThreads) {
    const int j = i / bins;
    const int b = i - j * bins;
    const int count = (h[j * hw + (b >> 1)] >> ((b & 1) * 16)) & 0xffffu;
    if (count) {
      const size_t qb = static_cast<size_t>(q0 + j) * bins + b;
      sc.hist[qb * len + chunk] = count;
      atomicAdd(sc.tot + qb, count);
    }
  }
}

// Pass 2. Grid: n_q blocks of kThresholdThreads. Warp 0 turns the query's
// totals into each bin's first rank (the rows of higher bins: an exclusive
// suffix sum, a segment of bins per lane) and finds T, the bin holding rank
// k - 1, and the highest bin in use. Then a warp per bin in [T, top] turns
// the bin's chunk counts into each chunk's first rank within the bin (an
// exclusive prefix over n_chunks + 1 entries, the last one 0, which becomes
// the total).
__global__ void __launch_bounds__(kThresholdThreads)
    binary_threshold_kernel(Scratch sc, int n_chunks, int bins, int k) {
  __shared__ int shared_t, shared_top;
  const int q = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (warp == 0) {
    int* tot = sc.tot + static_cast<size_t>(q) * bins;
    const int seg = (bins + kWarp - 1) / kWarp;
    const int lo = min(bins, lane * seg);
    const int hi = min(bins, lo + seg);
    int sum = 0;
    int top = -1;
    for (int b = lo; b < hi; ++b) {
      const int count = tot[b];
      sum += count;
      if (count) top = b;
    }
    int above = sum;  // inclusive suffix over lanes >= lane
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_down_sync(0xffffffffu, above, o);
      if (lane + o < kWarp) above += v;
      top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
    }
    above -= sum;
    for (int b = hi - 1; b >= lo; --b) {
      const int count = tot[b];
      tot[b] = above;
      if (above < k && above + count >= k) shared_t = b;  // one bin in all
      above += count;
    }
    if (lane == 0) shared_top = top;
  }
  __syncthreads();
  const int t = shared_t;
  const int top = shared_top;
  const int len = n_chunks + 1;
  const int seg = (len + kWarp - 1) / kWarp;
  const int lo = min(len, lane * seg);
  const int hi = min(len, lo + seg);
  for (int b = t + warp; b <= top; b += kThresholdThreads / kWarp) {
    int* p = sc.hist + (static_cast<size_t>(q) * bins + b) * len;
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += p[i];
    int before = sum;  // inclusive prefix over lanes <= lane
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += v;
    }
    before -= sum;
    for (int i = lo; i < hi; ++i) {
      const int count = p[i];
      p[i] = before;
      before += count;
    }
  }
  if (threadIdx.x == 0) {
    sc.meta[q * 4] = t;
    sc.meta[q * 4 + 1] = top;
  }
}

// Pass 3. Grid: (n_chunks, n_q). out_m (n_q, k) int32 scores (INT32_MIN past
// n_valid), out_r (n_q, k) int64 rows.
__global__ void __launch_bounds__(kThreads)
    binary_collect_kernel(Scratch sc, int* __restrict__ out_m, long long* __restrict__ out_r,
                          int n_rows, int bins, int chunk_rows, int n_chunks, int k) {
  extern __shared__ int smem_collect[];
  __shared__ int warp_counts[kWarps];
  const int chunk = blockIdx.x;
  const int q = blockIdx.y;
  const int t = sc.meta[q * 4];
  const int top = sc.meta[q * 4 + 1];
  int* first = smem_collect;  // first rank of bin t + i in this chunk
  int* next = first + bins;   // next rank of bin t + i in this chunk
  int* list = next + bins;    // a sub-tile's candidates, (bin << 11) | local row
  const int len = n_chunks + 1;
  const int* above = sc.tot + static_cast<size_t>(q) * bins;
  bool any = false;
  for (int b = t + threadIdx.x; b <= top; b += kThreads) {
    const int* p = sc.hist + (static_cast<size_t>(q) * bins + b) * len + chunk;
    const int start = above[b] + p[0];
    first[b - t] = start;
    next[b - t] = start;
    any |= start < k && p[1] > p[0];
  }
  if (!__syncthreads_or(any)) return;  // no row of this chunk reaches rank k

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const unsigned short* src = sc.bins + static_cast<size_t>(q) * bins_stride(n_rows);
  const int row_end = min(n_rows, (chunk + 1) * chunk_rows);
  for (int base = chunk * chunk_rows; base < row_end; base += kCollectRows) {
    // Thread i reads rows base + 8i .. + 8 (16 bytes; base % 8 == 0).
    const int r0 = base + 8 * threadIdx.x;
    unsigned short v[8];
    if (r0 + 8 <= row_end) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + r0);
      const unsigned parts[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = static_cast<unsigned short>(parts[i] & 0xffffu);
        v[2 * i + 1] = static_cast<unsigned short>(parts[i] >> 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = r0 + i < row_end ? src[r0 + i] : 0;
    }
    unsigned mine = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = v[i];
      if (r0 + i < row_end && b >= t && b <= top && first[b - t] < k) mine |= 1u << i;
    }
    // The block's candidates in row order: an exclusive prefix of the counts.
    const int count = __popc(mine);
    int incl = count;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == kWarp - 1) warp_counts[warp] = incl;
    __syncthreads();
    int total = 0;
    int pos = incl - count;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = warp_counts[i];
      if (i < warp) pos += c;
      total += c;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (mine >> i & 1u) list[pos++] = (static_cast<int>(v[i]) << 11) | (8 * threadIdx.x + i);
    }
    __syncthreads();
    if (total == 0) continue;
    if (warp == 0) {
      // 32 candidates at a time, in row order; lanes of one bin rank by lane.
      for (int i0 = 0; i0 < total; i0 += kWarp) {
        const bool has = i0 + lane < total;
        const unsigned mask = __ballot_sync(0xffffffffu, has);
        if (has) {
          const int e = list[i0 + lane];
          const int b = e >> 11;
          const unsigned peers = __match_any_sync(mask, b);
          const int rank = __popc(peers & ((1u << lane) - 1u));
          const int at = next[b - t] + rank;
          __syncwarp(mask);
          if (rank == 0) next[b - t] += __popc(peers);
          if (at < k) {
            const size_t o = static_cast<size_t>(q) * k + at;
            out_m[o] = b > 0 ? b - 1 : INT_MIN;
            out_r[o] = base + (e & (kCollectRows - 1));
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the list is rewritten next sub-tile
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

// Pass 1 for n_q queries in groups of kTiles x 8: one 8-query tile up to 8
// queries (fewer registers, more blocks per SM for the bytes), two above
// (half the reads of the rows).
template <int kTiles>
cudaError_t launch_bins(const unsigned* q, const unsigned* words, const Scratch& sc, int n_q,
                        int n_rows, int w, int n_valid, int chunk_rows, int n_chunks,
                        cudaStream_t s) {
  const size_t smem = bins_smem<kTiles>(w, n_q);
  const cudaError_t err = allow_smem(binary_bins_kernel<kTiles>, smem);
  if (err != cudaSuccess) return err;
  const int group = kTiles * kMmaQueries;
  const int n_groups = (n_q + group - 1) / group;
  binary_bins_kernel<kTiles><<<n_chunks * n_groups, kThreads, smem, s>>>(
      q, words, sc, n_q, n_groups, n_rows, w, n_valid, chunk_rows, n_chunks);
  return cudaGetLastError();
}

int binary_topk(const void* q, const void* words, void* scratch, void* out_m, void* out_r,
                int n_q, int n_rows, int w, int n_valid, int k, int chunk_rows, void* stream) {
  if (n_q < 1 || w < 1 || w > kMaxWords || chunk_rows % kThreads != 0 || chunk_rows < kThreads ||
      chunk_rows > kMaxChunkRows || k < 1 || k > n_rows || n_valid < 0 || n_valid > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bins = score_bins(w);
  const int n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const Scratch sc = scratch_layout(scratch, n_q, n_rows, w, n_chunks);
  const unsigned* qw = static_cast<const unsigned*>(q);
  const unsigned* mw = static_cast<const unsigned*>(words);
  cudaError_t err = cudaMemsetAsync(sc.hist, 0, sc.zero_bytes, s);
  if (err == cudaSuccess) {
    err = n_q > kMmaQueries
              ? launch_bins<2>(qw, mw, sc, n_q, n_rows, w, n_valid, chunk_rows, n_chunks, s)
              : launch_bins<1>(qw, mw, sc, n_q, n_rows, w, n_valid, chunk_rows, n_chunks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  binary_threshold_kernel<<<n_q, kThresholdThreads, 0, s>>>(sc, n_chunks, bins, k);
  const size_t smem = (2 * static_cast<size_t>(bins) + kCollectRows) * 4;
  err = allow_smem(binary_collect_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  binary_collect_kernel<<<dim3(n_chunks, n_q), kThreads, smem, s>>>(
      sc, static_cast<int*>(out_m), static_cast<long long*>(out_r), n_rows, bins, chunk_rows,
      n_chunks, k);
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

// Kernel 6: exact top-k of one query q (w,) over words (n_rows, w), words
// 16-byte aligned. scratch: 16-byte aligned, laid out as the header says
// for n_q = 1 and n_chunks = ceil(n_rows / chunk_rows); out_m (k,) int32,
// out_r (k,) int64.
int tpuclip_binary_topk_q1(const void* q, const void* words, void* scratch, void* out_m,
                           void* out_r, int n_rows, int w, int n_valid, int k, int chunk_rows,
                           void* stream) {
  return binary_topk(q, words, scratch, out_m, out_r, 1, n_rows, w, n_valid, k, chunk_rows,
                     stream);
}

// Kernel 7: the same for n_q queries q (n_q, w); out_m / out_r are (n_q, k).
int tpuclip_binary_topk(const void* q, const void* words, void* scratch, void* out_m, void* out_r,
                        int n_q, int n_rows, int w, int n_valid, int k, int chunk_rows,
                        void* stream) {
  return binary_topk(q, words, scratch, out_m, out_r, n_q, n_rows, w, n_valid, k, chunk_rows,
                     stream);
}

}  // extern "C"
