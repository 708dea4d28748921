// The per-tile threshold selection shared by the port's tile top-k kernels
// (NVIDIA Hopper, sm_90a): kernels 2 and 3 in int8_scan.cu, kernel 4 in
// topk_bf16.cu. Included by each .cu; tpuclip_torch/ops/_build.py hashes
// csrc/*.cuh with the sources, so an edit here rebuilds every library.
//
// A block scans one tile of rows for its qb queries into shared memory
// (one 32-bit key or exact f32 score per (query, row)), then selects each
// query's top k of the tile by a threshold, not by k rounds of max-and-mask:
//   1. radix select, 8 bits a pass from the top, over the keys' 32
//      order-preserving bits: a shared-memory histogram of the digit among
//      the keys that match the digits chosen so far (warp-aggregated
//      atomics), then one warp finds the digit where the count from the top
//      reaches k. It stops as soon as that digit's whole bin is needed,
//      usually after two or three passes;
//   2. one pass collects every key above the threshold, and the keys equal
//      to it in row order (a ballot prefix count), into exactly k slots:
//      equal keys (equal scores) go to the lowest row;
//   3. one warp sorts the <= 128 slots by a bitonic network over shuffles
//      (a rank count above 128) and writes them out.
// The cost is a few passes over the tile's keys, whatever k is. A team
// selects for one query: the whole block (8 warps) while a block has fewer
// than kWarpTeamQueries queries, else one warp per query.
//
// select_launch plans the block: qb queries, as many as fit of 16 (8 above
// 128 slots), in G = ceil(qb / 8) mma groups of 8 queries; 8 warps at G = 1
// and 32 at G = 2, where 16 queries' 128 KB of scores leave room for one
// block per SM; shared memory of qb x tile 4-byte entries, then the larger
// of the qb query rows and the selection's workspace (the query rows are
// dead once the scan is done).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // the warps of a block team, and of a 1-group block
constexpr int kThreads = kWarp * kWarps;
constexpr int kQueriesPerMma = 8;  // mma N
constexpr int kMaxGroups = 2;
__host__ __device__ constexpr int block_warps(int groups) { return groups == 1 ? kWarps : 4 * kWarps; }
constexpr int kWarpTeamQueries = 4;  // from this many queries per block, a warp per query
constexpr int kBins = 256;           // radix digit of 8 bits
constexpr int kSortSlots = 128;      // one warp's bitonic sort: 4 keys per lane
constexpr int kCtlBytes = 64;        // a team's control words, before its histogram / slots
constexpr int kWarpWorkspace = kCtlBytes + kSortSlots * 8;

// The radix key of a tile's entry: 32 bits whose unsigned order is the
// selection's order. Kernel 2: the packed key with its sign bit flipped
// (unique in a tile). Kernels 3 and 4: the score's monotonic bits, -0.0 as
// +0.0 (equal scores give equal keys; the row breaks the tie).
struct PackedKeys {
  const int* keys;
  __device__ __forceinline__ unsigned radix(int i) const {
    return static_cast<unsigned>(keys[i]) ^ 0x80000000u;
  }
};

struct ExactScores {
  const float* scores;
  __device__ __forceinline__ unsigned radix(int i) const {
    unsigned b = __float_as_uint(scores[i]);
    if (b == 0x80000000u) b = 0u;
    return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
  }
};

// A selected entry's sort key: the radix key above the inverted tile-local
// row, unique, larger for a better entry (a lower row among equal keys).
__device__ __forceinline__ unsigned long long sort_key(unsigned radix, int local) {
  return (static_cast<unsigned long long>(radix) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(local));
}

__device__ __forceinline__ int local_of(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

// Writes a query's per-tile output: slot pos of k_pad gets a sort key, or
// the padding. Kernel 2: the packed int32 key, INT32_MIN padding.
struct PackedOut {
  int* out;
  __device__ __forceinline__ void put(int pos, unsigned long long key) const {
    out[pos] = static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
  }
  __device__ __forceinline__ void pad(int pos) const { out[pos] = INT_MIN; }
};

// Kernels 3 and 4: the exact score from shared memory and the global row;
// (-inf, INT32_MAX) padding.
struct ExactOut {
  float* out_s;
  int* out_i;
  const float* scores;
  int base;
  __device__ __forceinline__ void put(int pos, unsigned long long key) const {
    const int local = local_of(key);
    out_s[pos] = scores[local];
    out_i[pos] = base + local;
  }
  __device__ __forceinline__ void pad(int pos) const {
    out_s[pos] = __uint_as_float(0xff800000u);
    out_i[pos] = INT_MAX;
  }
};

// A team selects for one query: the whole block (kTeam = 256) or one warp.
template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if constexpr (kTeam == kThreads) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// One warp: the digit d where the count of keys from the top bin down
// reaches `need`. Lane l holds bins 255 - 8l down to 248 - 8l. ctl[0] gets
// d, ctl[1] the count in bins above d.
__device__ __forceinline__ void find_digit(const unsigned* hist, int need, int lane, int* ctl) {
  const uint4 lo = *reinterpret_cast<const uint4*>(hist + 248 - 8 * lane);
  const uint4 hi = *reinterpret_cast<const uint4*>(hist + 252 - 8 * lane);
  const int c[8] = {static_cast<int>(hi.w), static_cast<int>(hi.z), static_cast<int>(hi.y),
                    static_cast<int>(hi.x), static_cast<int>(lo.w), static_cast<int>(lo.z),
                    static_cast<int>(lo.y), static_cast<int>(lo.x)};
  int sum = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) sum += c[r];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int cum = incl - sum;
  if (cum < need && need <= incl) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (cum + c[r] >= need) {
        ctl[0] = 255 - 8 * lane - r;
        ctl[1] = cum;
        break;
      }
      cum += c[r];
    }
  }
}

// Sorts 128 keys descending across one warp, key e = 32r + lane in x[r]:
// a bitonic network, partners within a lane for distances 32 and 64 and by
// shuffles below.
__device__ __forceinline__ void warp_sort_desc(unsigned long long (&x)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= kSortSlots; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      unsigned long long y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = r * kWarp + lane;
        const unsigned long long other =
            j >= kWarp ? x[r ^ (j / kWarp)] : __shfl_xor_sync(0xffffffffu, x[r], j);
        const bool keep_max = ((e & j) == 0) == ((e & size) == 0);
        y[r] = keep_max ? (x[r] > other ? x[r] : other) : (x[r] < other ? x[r] : other);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = y[r];
    }
  }
}

// The k largest of one query's `tile` radix keys, ordered by sort key
// (descending), written through `out` at [0, k), then padding to k_pad.
// `ws` is the team's workspace: kCtlBytes of control words, then a
// histogram of kBins counts that the collected slots overwrite.
template <int kTeam, class Keys, class Out>
__device__ void select_topk(const Keys& keys, const Out& out, int tile, int k, int k_pad,
                            unsigned char* ws) {
  int* ctl = reinterpret_cast<int*>(ws);  // [0] digit, [1] above it, [2] slots taken, [8, 16) per warp
  unsigned* hist = reinterpret_cast<unsigned*>(ws + kCtlBytes);
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(ws + kCtlBytes);
  const int tt = threadIdx.x % kTeam;
  const int lane = threadIdx.x % kWarp;
  const int team_warp = tt / kWarp;
  const unsigned below = (1u << lane) - 1u;

  // 1. Radix select: prefix holds the digits chosen so far, need the keys
  // still to take from those that match it.
  unsigned prefix = 0u;
  int need = k;
  int shift = 24;
  bool tie = false;
  for (;;) {
    for (int b = tt; b < kBins; b += kTeam) hist[b] = 0u;
    team_sync<kTeam>();
    for (int i0 = 0; i0 < tile; i0 += kTeam) {
      const int i = i0 + tt;
      unsigned digit = kBins;  // outside the prefix, or past the tile: no bin
      if (i < tile) {
        const unsigned v = keys.radix(i);
        if (shift == 24 || ((v ^ prefix) >> (shift + 8)) == 0u) digit = (v >> shift) & (kBins - 1);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kBins && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    team_sync<kTeam>();
    if (tt < kWarp) find_digit(hist, need, lane, ctl);
    team_sync<kTeam>();
    const int digit = ctl[0];
    need -= ctl[1];
    prefix |= static_cast<unsigned>(digit) << shift;
    const int in_bin = static_cast<int>(hist[digit]);
    team_sync<kTeam>();  // every read of ctl and hist is done before either changes
    if (in_bin == need) break;  // the whole bin is taken: no finer digit needed
    if (shift == 0) {           // more keys equal the threshold than are needed
      tie = true;
      break;
    }
    shift -= 8;
  }

  // 2. Collect the k winners into slots: every key whose digits down to
  // `shift` are above the prefix's or equal to them; under a tie, only the
  // first `need` keys equal to the threshold, in row order.
  if (tt == 0) ctl[2] = 0;
  team_sync<kTeam>();
  const unsigned top = prefix >> shift;
  int ties_before = 0;  // keys equal to the threshold in earlier rounds
  for (int i0 = 0; i0 < tile; i0 += kTeam) {
    const int i = i0 + tt;
    const bool ok = i < tile;
    const unsigned v = ok ? keys.radix(i) : 0u;
    bool take = ok && (v >> shift) >= top;
    if (tie) {
      const bool eq = ok && v == prefix;
      const unsigned eq_mask = __ballot_sync(0xffffffffu, eq);
      int rank = ties_before + __popc(eq_mask & below);
      int round = __popc(eq_mask);
      if constexpr (kTeam == kThreads) {
        if (lane == 0) ctl[8 + team_warp] = round;
        __syncthreads();
        round = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int c = ctl[8 + w];
          if (w < team_warp) rank += c;
          round += c;
        }
        __syncthreads();
      }
      take = (ok && v > prefix) || (eq && rank < need);
      ties_before += round;
    }
    const unsigned take_mask = __ballot_sync(0xffffffffu, take);
    if (take_mask) {
      int first = 0;
      if (lane == 0) first = atomicAdd(&ctl[2], __popc(take_mask));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (take) slots[first + __popc(take_mask & below)] = sort_key(v, i);
    }
  }
  team_sync<kTeam>();

  // 3. Order the k slots (unique keys) and write them out.
  if (k <= kSortSlots) {
    if (tt < kWarp) {
      unsigned long long x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = r * kWarp + lane < k ? slots[r * kWarp + lane] : 0ull;
      warp_sort_desc(x, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r * kWarp + lane < k) out.put(r * kWarp + lane, x[r]);
      }
    }
  } else {
    // Above 128 slots (the whole block only): each slot's rank is the count
    // of larger keys.
    for (int s = tt; s < k; s += kTeam) {
      const unsigned long long key = slots[s];
      int rank = 0;
      for (int j = 0; j < k; ++j) rank += slots[j] > key;
      out.put(rank, key);
    }
  }
  for (int pos = k + tt; pos < k_pad; pos += kTeam) out.pad(pos);
  team_sync<kTeam>();  // the workspace is free for the next query
}

// Bytes of one team's workspace: the block's team holds up to max(k_tile,
// 128) slots, a warp's team 128.
int block_workspace(int k_tile) {
  const int slots = (k_tile > kSortSlots ? k_tile : kSortSlots) * 8;
  return kCtlBytes + (slots > kBins * 4 ? slots : kBins * 4);
}

size_t smem_optin() {
  int device = 0;
  int bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<size_t>(bytes);
}

// The launch of a tile top-k kernel: qb queries per block, as many as fit
// of 16 (8 above 128 slots); G = ceil(qb / 8) mma groups; a warp per query
// from kWarpTeamQueries queries at k_tile <= 128 (else the whole block per
// query); and the block's shared memory: qb x tile 4-byte entries, then the
// larger of the qb query rows (query_row_bytes each) and the selection's
// workspace.
struct SelectLaunch {
  int qb = 0;
  int groups = 1;
  bool warp_teams = false;
  size_t smem = 0;
};

SelectLaunch select_launch(int n_q, int tile, int query_row_bytes, int k_tile) {
  const size_t optin = smem_optin();
  const int most = (k_tile <= kSortSlots ? kMaxGroups : 1) * kQueriesPerMma;
  SelectLaunch launch;
  for (int qb = n_q < most ? n_q : most; qb >= 1; --qb) {
    const int groups = (qb + kQueriesPerMma - 1) / kQueriesPerMma;
    const bool warp_teams = qb >= kWarpTeamQueries && k_tile <= kSortSlots;
    const int teams = qb < block_warps(groups) ? qb : block_warps(groups);
    const size_t ws = warp_teams ? static_cast<size_t>(teams) * kWarpWorkspace
                                 : static_cast<size_t>(block_workspace(k_tile));
    const size_t rows = static_cast<size_t>(qb) * query_row_bytes;
    const size_t smem = static_cast<size_t>(qb) * tile * 4 + (rows > ws ? rows : ws);
    if (smem <= optin) {
      launch.qb = qb;
      launch.groups = groups;
      launch.warp_teams = warp_teams;
      launch.smem = smem;
      return launch;
    }
  }
  return launch;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
