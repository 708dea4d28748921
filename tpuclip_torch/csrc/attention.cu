// Fused multi-head attention for the PyTorch port's towers (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces no TPU kernel: tpuclip computes attention as two einsums and
// leaves the fusion to XLA (tpuclip/models/siglip.py, mha). The port has
// no XLA, and its explicit-matmul chain (fp32 upcasts, the logits GEMM in
// fp32 off the tensor cores, scale, mask add, softmax, cast back, weighted
// sum, transposes) made a round trip through device memory at every step:
// at SO400M, 256 tokens and batch 256 it wrote 4.19 MB of fp32 logits an
// image a layer and moved ~29 MB an image a layer in all, 58% of the
// vision tower's time for 3.7% of its FLOPs.
//
// What it computes, for each batch b, head h and query row i:
//   s_j = fp32(q_i . k_j) * scale + bias[b, j]        (fp32, two roundings)
//   out_i = bf16( sum_j bf16(exp(s_j - m)) v_j / sum_j exp(s_j - m) )
// with q, k, v the projections' bf16 (B, S, H * hd) outputs read in place
// (head h is columns h * hd .. (h + 1) * hd of each row), the logits
// accumulated in fp32 on the tensor cores (products of bf16 values are
// exact in fp32, so these are tpuclip's bf16 x bf16 -> f32 logits up to
// summation order), the softmax in fp32 online over key tiles, P rounded
// once to bf16 for the PV product (fp32 accumulation), the row sum's
// division in fp32 and the output rounded once to bf16, written straight
// into the (B, Sq, H * hd) tensor the output projection reads. The plain
// version rounds the normalised weights to bf16; this kernel rounds the
// unnormalised exp(s - m) and divides at the end: both round P once at
// bf16 precision. exp(x) is ex2.approx.ftz(x * log2(e)) with x = s - m
// formed first: 2 ulp plus |x| * 2^-24 relative, a result under 2^-126
// flushed to 0, four orders under P's rounding. A key past Sk is -inf; a
// row whose keys are all masked by a finite bias gets uniform weights, as
// in the plain version.
//
// What bounds it on the H100: at SO400M (Sq = Sk = 256, H = 16, hd = 72)
// and batch 256 a launch reads q, k and v (453 MB) and writes the output
// (151 MB): 604 MB, 0.180 ms at 3.35 TB/s, against 0.078 ms for its
// 77 GFLOP at 989 TFLOP/s. Bytes bound it; what holds it at ~2.6 times
// that is latency: each (b, h) is only 4 key tiles, and a warp's 64 scores
// a row tile take ~10 instructions each (scale, bias, max, exp, sum,
// rescale, cast) between its two products, with 2-3 warps a scheduler to
// hide them (measured with clock64() phases: the two products, the
// softmax and the loads' issue take about a third each).
//
// Design: mma.sync m16n8k16 in the FlashAttention-2 form. A block of 4
// warps owns 128 query rows of one (b, h), 32 a warp (two m16 tiles, so
// each K or V fragment loaded serves two products); the query-tile index
// is the fastest grid dimension, so the blocks of one (b, h) run together
// and share its K and V through L2. The block's Q tile and then 64-key
// tiles of K and V come into shared memory by 16-byte cp.async, two key
// tiles in flight (a tile is computed while the next one lands); rows past
// Sq or Sk are zero-filled, and columns hd .. (hd rounded up to 16, for
// QK^T's k16 steps) are zeros written once. Row strides are that width + 8
// elements, so every ldmatrix is free of bank conflicts. Q fragments come
// from shared memory at each k16 step; S (32 x 64 a warp) and P stay in
// registers: the fp32 accumulators of two adjacent n8 tiles of S are,
// packed to bf16, the A fragment of PV's k16 step, so P never touches
// shared memory. V's B fragments come by ldmatrix.trans from V's (key,
// column) rows; O is 9 n8 tiles at hd 72 (an odd tile by ldmatrix.x2). The
// running max, the rescale of O and the partial row sums stay per thread;
// the 4 lanes of a row meet by shuffles. The output goes through the
// warp's own Q rows in shared memory, so it is written 16 bytes a lane.
// Measured alternatives, all slower at the cells' launch (PERF.md): 16
// rows a warp (64-row blocks), 2 or 8 warps a block, 2 blocks an SM at the
// full register count. wgmma with TMA (FlashAttention-3's form, the
// softmax of one warpgroup overlapping the other's products) is the route
// past this latency: attention_sm90.cu takes it, and this kernel keeps the
// launches where it is the faster one (tpuclip_torch/ops/attention.py,
// takes_sm90: Sq under 128, such as the MAP head's Sq = 1 and the text
// tower's 64, and head widths the other is not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;                 // m16 tiles of query rows a warp
constexpr int kBQ = kWarps * kMT * 16;  // query rows a block
constexpr int kBK = 64;                 // keys a tile
constexpr int kNT = kBK / 8;            // n8 tiles of S a row tile
constexpr float kLog2e = 1.4426950408889634f;

// head_dim padded to a multiple of 16 (QK^T's k16 steps), and the shared
// row stride: 8 more elements, so that 8 rows at one column fall in 8
// different 16-byte bank groups.
__host__ __device__ constexpr int padded(int hd) { return (hd + 15) / 16 * 16; }
__host__ __device__ constexpr int row_stride(int hd) { return padded(hd) + 8; }

// Blocks an SM must hold: 3 up to SigLIP's head width 72 (168 registers
// a thread, a few bytes spilled), where the third block's warps hide more
// latency than the spill costs (0.47 against 0.51-0.52 ms at the cells'
// launch); wider heads take the registers they need.
__host__ __device__ constexpr int min_blocks(int hd) { return hd <= 72 ? 3 : 1; }

// Shared memory of a block: the Q tile, two K and two V tiles (bf16), then
// the key bias of the row's padded keys (f32).
__host__ __device__ constexpr size_t smem_bytes(int hd, int sk) {
  return static_cast<size_t>(kBQ + 4 * kBK) * row_stride(hd) * 2 +
         static_cast<size_t>((sk + kBK - 1) / kBK * kBK) * 4;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a (16x16, rows g / g+8) * b (16x8, column g); bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx.ftz: 2 ulp; a result under 2^-126 is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = s * scale (+ bias of its key), each rounded in fp32, as the plain
// version; kBias false skips the add (no mask).
template <int kMT, int kNT, bool kBias>
__device__ __forceinline__ void scale_logits(float (&s)[kMT][kNT][4], float scale, const float* bias_keys) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    float2 kb = make_float2(0.0f, 0.0f);
    if (kBias) kb = *reinterpret_cast<const float2*>(bias_keys + n * 8);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[mi][n][e], scale);
        if (kBias) x = __fadd_rn(x, (e & 1) ? kb.y : kb.x);
        s[mi][n][e] = x;
      }
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Grid: (query tiles of kBQ rows, heads, batch). Strides in elements; the
// last dimension of q, k, v and bias is contiguous; bias may be null. HD is
// the head width computed (a multiple of 8, at least hd): columns hd .. HD
// are zeros and are not written.
template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks(HD))
    attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int sq, int sk, int heads, int hd, int q_sb,
                     int q_sr, int k_sb, int k_sr, int v_sb, int v_sr, int bias_sb, float scale) {
  constexpr int S = row_stride(HD);
  constexpr int kKS = padded(HD) / 16;  // k16 steps of QK^T
  constexpr int kNO = HD / 8;           // n8 tiles of O
  extern __shared__ uint4 smem_attn[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_attn);
  __nv_bfloat16* ks = qs + kBQ * S;      // [2][kBK][S]
  __nv_bfloat16* vs = ks + 2 * kBK * S;  // [2][kBK][S]
  float* bs = reinterpret_cast<float*>(vs + 2 * kBK * S);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const size_t batch = blockIdx.z;
  const int n_tiles = (sk + kBK - 1) / kBK;
  const __nv_bfloat16* qb = q + batch * q_sb + static_cast<size_t>(head) * hd;
  const __nv_bfloat16* kb = k + batch * k_sb + static_cast<size_t>(head) * hd;
  const __nv_bfloat16* vb = v + batch * v_sb + static_cast<size_t>(head) * hd;

  // Zeros in the padded columns [hd, padded(HD)) of every Q, K and V row:
  // no cp.async ever writes there.
  const int pad_chunks = (padded(HD) - hd) / 8;
  for (int i = tid; i < (kBQ + 4 * kBK) * pad_chunks; i += kThreads) {
    *reinterpret_cast<uint4*>(qs + (i / pad_chunks) * S + hd + 8 * (i % pad_chunks)) = make_uint4(0u, 0u, 0u, 0u);
  }
  const bool has_bias = bias != nullptr;
  if (has_bias) {
    const float* bb = bias + batch * bias_sb;
    for (int i = tid; i < n_tiles * kBK; i += kThreads) bs[i] = i < sk ? bb[i] : 0.0f;
  }

  // Rows r0 .. r0 + 63 of src (rows at or past n_valid zero-filled) into
  // dst: 16-byte chunk c = tid + i * kThreads is row c / kCPR, chunk
  // c % kCPR; chunks past the head's hd / 8 are skipped.
  constexpr int kCPR = HD / 8;
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int stride, int r0, int n_valid) {
#pragma unroll
    for (int c = tid; c < kBK * kCPR; c += kThreads) {
      const int row = c / kCPR;
      const int col = 8 * (c % kCPR);
      if (col < hd) {
        const bool ok = r0 + row < n_valid;
        const __nv_bfloat16* p = ok ? src + static_cast<size_t>(r0 + row) * stride + col : src;
        cp_async16(smem_u32(dst + row * S + col), p, ok ? 16 : 0);
      }
    }
  };
  // Key tile t into buffer t % 2 and a commit; an empty group past the
  // last tile, so that the waits count groups uniformly.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      load_rows(ks + (t & 1) * kBK * S, kb, k_sr, t * kBK, sk);
      load_rows(vs + (t & 1) * kBK * S, vb, v_sr, t * kBK, sk);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r0 = 0; r0 < kBQ; r0 += kBK) load_rows(qs + r0 * S, qb, q_sr, q0 + r0, sq);
  load_tile(0);
  load_tile(1);

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * kMT * 16;    // the warp's first row in the block
  const bool active = q0 + wr < sq;  // a warp whose rows all lie past Sq only loads
  // ldmatrix lane offsets (elements): Q as A, rows lane % 16, column 8 (lane / 16);
  // K as B, keys (lane & 7) + 8 (lane / 16), column 8 ((lane / 8) & 1);
  // V as B by .trans, keys lane % 16, column 8 (lane / 16).
  const unsigned q_lane = smem_u32(qs + (wr + (lane & 15)) * S + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * S + (lane >> 4) * 8;

  // Row r = 2 mi + h of the thread: row g + 8 h of m-tile mi.
  float o[kMT][kNO][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int n = 0; n < kNO; ++n) o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.0f;
  float m[2 * kMT];  // running max
  float l[2 * kMT];  // this lane's part of the row sum
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // tile t (and at t = 0 the Q tile, zeros and bias) landed for all
    if (active) {
      const unsigned kt = smem_u32(ks + (t & 1) * kBK * S + k_off);
      const unsigned vt = smem_u32(vs + (t & 1) * kBK * S + v_off);

      // S = Q K^T, fp32 accumulation; each K fragment serves both m-tiles.
      float s[kMT][kNT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int n = 0; n < kNT; ++n) s[mi][n][0] = s[mi][n][1] = s[mi][n][2] = s[mi][n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        unsigned a[kMT][4];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) ldmatrix_x4(a[mi], q_lane + (mi * 16 * S + kk * 16) * 2);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, kt + (np * 16 * S + kk * 16) * 2);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            mma_bf16(s[mi][2 * np], a[mi], r[0], r[1]);
            mma_bf16(s[mi][2 * np + 1], a[mi], r[2], r[3]);
          }
        }
      }

      // Scale, then bias, in fp32 (two roundings, as the plain version);
      // keys past Sk are -inf.
      const int key0 = t * kBK + 2 * t4;
      if (has_bias) {
        scale_logits<kMT, kNT, true>(s, scale, bs + key0);
      } else {
        scale_logits<kMT, kNT, false>(s, scale, bs);
      }
      if ((t + 1) * kBK > sk) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (key0 + n * 8 + (e & 1) >= sk) s[mi][n][e] = -INFINITY;
            }
      }

      // Online softmax: the new max of each row over its 4 lanes, the
      // rescale of O and the sums, then P = exp(s - m).
      float mx[2 * kMT];
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) mx[r] = -INFINITY;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mx[2 * mi] = fmaxf(mx[2 * mi], fmaxf(s[mi][n][0], s[mi][n][1]));
          mx[2 * mi + 1] = fmaxf(mx[2 * mi + 1], fmaxf(s[mi][n][2], s[mi][n][3]));
        }
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float mu[2 * kMT];  // the max subtracted: 0 while a row has seen only -inf
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        const float corr = m[r] == -INFINITY ? 0.0f : exp2_approx(__fmul_rn(__fsub_rn(m[r], m_new), kLog2e));
        m[r] = m_new;
        mu[r] = m_new == -INFINITY ? 0.0f : m_new;
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < kNO; ++n) {
          o[r >> 1][n][2 * (r & 1)] *= corr;
          o[r >> 1][n][2 * (r & 1) + 1] *= corr;
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * mi + (e >> 1);
            const float p = exp2_approx(__fmul_rn(__fsub_rn(s[mi][n][e], mu[r]), kLog2e));
            s[mi][n][e] = p;
            l[r] += p;
          }

      // O += bf16(P) V: two n8 tiles of S are one k16 A fragment; each V
      // fragment serves both m-tiles.
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        unsigned a[kMT][4];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
          a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
          a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
          a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < kNO / 2; ++dp) {
          unsigned r[4];
          ldmatrix_x4_trans(r, vt + (kk * 16 * S + dp * 16) * 2);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            mma_bf16(o[mi][2 * dp], a[mi], r[0], r[1]);
            mma_bf16(o[mi][2 * dp + 1], a[mi], r[2], r[3]);
          }
        }
        if (kNO % 2) {
          unsigned r[2];
          ldmatrix_x2_trans(r, vt + (kk * 16 * S + (kNO - 1) * 8) * 2);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) mma_bf16(o[mi][kNO - 1], a[mi], r[0], r[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer t % 2
    load_tile(t + 2);
  }
  cp_async_wait<0>();
  if (!active) return;

  // O / l in fp32, rounded once to bf16, through the warp's own Q rows.
  __nv_bfloat16* os = qs + wr * S;
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = (r >> 1) * 16 + g + 8 * (r & 1);
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      *reinterpret_cast<unsigned*>(os + row * S + n * 8 + 2 * t4) =
          pack_bf16(__fdiv_rn(o[r >> 1][n][2 * (r & 1)], sum), __fdiv_rn(o[r >> 1][n][2 * (r & 1) + 1], sum));
    }
  }
  __syncwarp();
  const int width = heads * hd;
  __nv_bfloat16* ob = out + (batch * sq + q0 + wr) * static_cast<size_t>(width) + static_cast<size_t>(head) * hd;
  for (int c = lane; c < kMT * 16 * kCPR; c += 32) {
    const int r = c / kCPR;
    const int ch = c - r * kCPR;
    if (q0 + wr + r < sq && 8 * ch < hd) {
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * width + 8 * ch) =
          *reinterpret_cast<const uint4*>(os + r * S + 8 * ch);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out, int batch,
                   int sq, int sk, int heads, int hd, int q_sb, int q_sr, int k_sb, int k_sr, int v_sb,
                   int v_sr, int bias_sb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, sk);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      sq, sk, heads, hd, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (batch, sq, heads * hd) bf16, contiguous, of q (batch, sq, .) and
// k, v (batch, sk, .) bf16 with head h at columns h * hd of each row;
// strides in elements (q_sb, q_sr: batch and row), the last dimension
// contiguous. bias (batch, sk) f32 with batch stride bias_sb (0 to share
// one row), or null. hd % 8 == 0 and hd <= 128; every pointer and
// row start 16-byte aligned (strides and hd multiples of 8); sk >= 1.
int tpuclip_attention(const void* q, const void* k, const void* v, const void* bias, void* out, int batch,
                      int sq, int sk, int heads, int hd, int q_sb, int q_sr, int k_sb, int k_sr, int v_sb,
                      int v_sr, int bias_sb, float scale, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || hd < 8 || hd % 8 != 0 || hd > 128 || batch > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The instantiated head widths: SigLIP's 72 (SO400M), 64 (B, L) and 96
  // (g); 32 for the tiny presets' 16, 128 for any other.
  const int width = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 72 ? 72 : hd <= 96 ? 96 : 128;
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem_bytes(width, sk) > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUCLIP_ATTENTION_LAUNCH(W)                                                                       \
  static_cast<int>(launch<W>(q, k, v, bias, out, batch, sq, sk, heads, hd, q_sb, q_sr, k_sb, k_sr, v_sb, \
                             v_sr, bias_sb, scale, s))
  switch (width) {
    case 32: return TPUCLIP_ATTENTION_LAUNCH(32);
    case 64: return TPUCLIP_ATTENTION_LAUNCH(64);
    case 72: return TPUCLIP_ATTENTION_LAUNCH(72);
    case 96: return TPUCLIP_ATTENTION_LAUNCH(96);
    default: return TPUCLIP_ATTENTION_LAUNCH(128);
  }
#undef TPUCLIP_ATTENTION_LAUNCH
}

}  // extern "C"
