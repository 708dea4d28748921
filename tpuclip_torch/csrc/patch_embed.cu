// Fused patch embedding for the PyTorch port (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces (TPU Pallas kernel):
//   tpuclip/ops/patch_embed.py:_patch_embed_kernel -> patch_embed_kernel
//
// What it computes: out = bf16(u8 * f32(1/127.5) - 1) @ W + bias for uint8
// patch rows (R, K) and bf16 weights W (K, D) row-major, fp32 accumulation,
// the bias (f32 or bf16) added in fp32, then out cast to bf16 (or kept
// f32). x is formed as a multiply then a subtract, each rounded (no fused
// multiply-add), and rounded to bf16 to nearest-even, as the TPU kernel's
// x.astype(w.dtype): the products of bf16 values are then exact in fp32,
// and the result differs from the plain version only by summation order.
//
// What bounds it on the H100: at SO400M's patch shape (K = 588, D = 1152)
// and batch 64 (R = 16,384) it is 2 * R * K * D = 22.2 GFLOP over ~50 MB
// (uint8 rows, bf16 weights, bf16 out): compute-bound on the bf16 tensor
// cores (0.022 ms at 989 TFLOP/s against 0.015 ms for the bytes).
//
// Design: a block owns 128 patch rows (64 where K is too wide for shared
// memory) and walks every output column, so each pixel byte is read once
// and dequantised once. The block's rows are one contiguous span of R_b x K
// bytes, 16-byte aligned (the wrapper aligns the tensor, 64 K is a multiple
// of 16); it is loaded 16 bytes a lane into registers, dequantised there
// and kept in shared memory as bf16 for the whole block (128 x (K rounded
// up to 64, + 8) x 2 bytes, 166 KB at K = 588), zero past K, so no staging
// buffer is needed. The weights are read as the caller holds them, (K, D)
// row-major: slices of 64 K-rows x 128 columns stream through a ring of 3
// shared-memory stages by 16-byte cp.async (rows past K and columns past D
// zero-filled), so two slices are in flight while the tensor cores work on
// a third; the ring runs on across column tiles, so one tile's epilogue
// overlaps the next tile's loads. 8 warps (2 x 4) each compute a 64 x 32
// sub-tile with mma.sync m16n8k16 (bf16 in, fp32 accumulation), fragments
// by ldmatrix (the weights' by ldmatrix.trans, which turns the K-rows into
// the mma's column-major B); the padded row strides keep every ldmatrix
// free of bank conflicts. The epilogue adds the bias and writes each
// 128 x 128 tile straight from the accumulators. Measured (PERF.md): a
// block barrier per slice costs about as much as a slice's mmas at 32
// K-rows, so slices are 64 deep; 192-column tiles, 4 stages, fragment
// double-buffering and two 64-row blocks per SM were slower. What bounds it
// now is mma.sync's rate with its ldmatrix traffic; later work: wgmma and
// TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpM = 64;                   // rows per warp (4 x m16)
constexpr int kWarpN = 32;                   // columns per warp (4 x n8)
constexpr int kWarpsN = 4;
constexpr int kBlockN = kWarpN * kWarpsN;    // 128 output columns per tile
constexpr int kBK = 64;                      // K rows of W per stage (4 mma K-steps)
constexpr int kStages = 3;
constexpr int kBStride = kBlockN + 8;        // shared row stride of a W slice, elements
constexpr int kFragsN = kWarpN / 8;          // n8 mma tiles per warp
constexpr unsigned kInv127_5 = 0x3c008081u;  // float32(1 / 127.5)

__host__ __device__ constexpr int block_threads(int warps_m) { return warps_m * kWarpsN * 32; }

// Shared row stride of the dequantised rows, in elements: K rounded up to
// the stage depth, plus 8 so that 8 rows at one column fall in 8 different
// 16-byte bank groups.
__host__ __device__ __forceinline__ int a_stride(int k) { return (k + kBK - 1) / kBK * kBK + 8; }

size_t smem_bytes(int warps_m, int k) {
  return static_cast<size_t>(warps_m) * kWarpM * a_stride(k) * 2 +
         static_cast<size_t>(kStages) * kBK * kBStride * 2;
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

// c += a (16x16, rows g / g+8) * b (16x8, column g); bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One pixel byte -> x = u * f32(1/127.5) - 1, two roundings.
__device__ __forceinline__ float dequant(unsigned byte) {
  return __fsub_rn(__fmul_rn(static_cast<float>(byte), __uint_as_float(kInv127_5)), 1.0f);
}

// Four pixel bytes at byte offset o of the block's span -> four bf16 (round
// to nearest even) at their row and column of the shared rows. K % 4 == 0,
// so the four bytes lie in one row and the 8-byte store is aligned.
__device__ __forceinline__ void put_word(__nv_bfloat16* as, int stride, int k, int o, unsigned word) {
  const int r = o / k;
  const int col = o - r * k;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(dequant(word & 0xffu), dequant((word >> 8) & 0xffu));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(dequant((word >> 16) & 0xffu), dequant(word >> 24));
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(as + r * stride + col) = v;
}

// Grid: one block per 64 * kWarpsM patch rows. Shared memory: the block's
// dequantised rows (64 kWarpsM x a_stride(k) bf16), then kStages W slices
// (kBK x kBStride bf16).
template <int kWarpsM>
__global__ void __launch_bounds__(block_threads(kWarpsM), 1)
    patch_embed_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const void* __restrict__ bias, void* __restrict__ out, int rows, int k, int d,
                       int out_f32, int bias_bf16) {
  constexpr int kThreadsB = block_threads(kWarpsM);
  constexpr int kBlockM = kWarpsM * kWarpM;
  constexpr int kChunksPerRow = kBlockN / 8;  // 16-byte chunks of a W slice row
  extern __shared__ uint4 smem_pe[];
  const int stride = a_stride(k);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_pe);
  __nv_bfloat16* bs = as + kBlockM * stride;
  const int m0 = blockIdx.x * kBlockM;
  const int k_slices = (k + kBK - 1) / kBK;
  const int n_tiles = (d + kBlockN - 1) / kBlockN;
  const int total = n_tiles * k_slices;  // (column tile, K slice) steps
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // The ring of W slices, in steps (column tile nt, K slice ks), ks
  // fastest: each load_next() issues the next step into stage step %
  // kStages (rows past K and columns past D zero-filled) and commits a
  // group, empty past the last step, so that the wait below counts groups
  // uniformly.
  int load_step = 0;
  int load_ks = 0;
  int load_nt = 0;
  auto load_next = [&]() {
    if (load_step < total) {
      __nv_bfloat16* dst = bs + (load_step % kStages) * kBK * kBStride;
      const int kr0 = load_ks * kBK;
      for (int c = tid; c < kBK * kChunksPerRow; c += kThreadsB) {
        const int r = c / kChunksPerRow;
        const int col = load_nt * kBlockN + (c % kChunksPerRow) * 8;
        const bool ok = kr0 + r < k && col < d;
        const __nv_bfloat16* src = ok ? w + static_cast<size_t>(kr0 + r) * d + col : w;
        cp_async16(smem_u32(dst + r * kBStride + (c % kChunksPerRow) * 8), src, ok ? 16 : 0);
      }
      if (++load_ks == k_slices) {
        load_ks = 0;
        ++load_nt;
      }
    }
    ++load_step;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  // The block's patch rows, read once while the first W slices load.
  const int rows_here = min(kBlockM, rows - m0);
  const int span = rows_here * k;  // bytes, a multiple of 4
  const uint8_t* xb = x + static_cast<size_t>(m0) * k;
#pragma unroll 4
  for (int c = tid; c < span / 16; c += kThreadsB) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xb) + c);
    put_word(as, stride, k, 16 * c, v.x);
    put_word(as, stride, k, 16 * c + 4, v.y);
    put_word(as, stride, k, 16 * c + 8, v.z);
    put_word(as, stride, k, 16 * c + 12, v.w);
  }
  for (int o = span / 16 * 16 + 4 * tid; o < span; o += 4 * kThreadsB) {
    put_word(as, stride, k, o, __ldg(reinterpret_cast<const unsigned*>(xb + o)));
  }
  // Zeros: columns [k, stride - 8) of every row (the last slice's K tail),
  // and whole rows past the block's last patch row.
  const int k_pad = k_slices * kBK;
  const int tail_words = (k_pad - k) / 4;
  for (int i = tid; i < kBlockM * tail_words; i += kThreadsB) {
    *reinterpret_cast<uint2*>(as + (i / tail_words) * stride + k + 4 * (i % tail_words)) = make_uint2(0u, 0u);
  }
  for (int i = tid; i < (kBlockM - rows_here) * (k / 4); i += kThreadsB) {
    *reinterpret_cast<uint2*>(as + (rows_here + i / (k / 4)) * stride + 4 * (i % (k / 4))) = make_uint2(0u, 0u);
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * kWarpM;
  const int wn = (warp % kWarpsN) * kWarpN;
  // ldmatrix lane addresses: A, rows wm + lane % 16 at column 8 (lane / 16);
  // W, K-row lane % 16 of the step at columns wn + 8 (lane / 16).
  const unsigned a_lane = smem_u32(as + (wm + (lane & 15)) * stride + (lane >> 4) * 8);
  const int b_lane = (lane & 15) * kBStride + wn + (lane >> 4) * 8;
  const int k_steps = (k + 15) / 16;  // mma K-steps with any real K

  float acc[4][kFragsN][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < kFragsN; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;

  int ks = 0;  // the step computed: K slice ks of column tile nt
  int nt = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step it has landed for all; stage (it - 1) % kStages is free
    load_next();
    const unsigned b_stage = smem_u32(bs + (it % kStages) * kBK * kBStride + b_lane);
#pragma unroll
    for (int st = 0; st < kBK / 16; ++st) {
      if (ks * (kBK / 16) + st < k_steps) {
        const int kcol = ks * kBK + st * 16;
        unsigned a[4][4];
        unsigned b[kFragsN][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], a_lane + (mi * 16 * stride + kcol) * 2);
#pragma unroll
        for (int nj = 0; nj < kFragsN / 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4_trans(r, b_stage + (st * 16 * kBStride + nj * 16) * 2);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < kFragsN; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (++ks < k_slices) continue;

    // Epilogue of column tile nt: + bias in fp32, then bf16 (round to
    // nearest even) or f32; the next tile's W slices are already in flight.
#pragma unroll
    for (int ni = 0; ni < kFragsN; ++ni) {
      const int col = nt * kBlockN + wn + ni * 8 + 2 * t;
      float b0 = 0.0f;
      float b1 = 0.0f;
      if (col < d) {
        if (bias_bf16) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(bias) + col);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        } else {
          b0 = static_cast<const float*>(bias)[col];
          b1 = static_cast<const float*>(bias)[col + 1];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mi * 16 + g + 8 * h;
          if (col < d && row < rows) {
            const float v0 = __fadd_rn(acc[mi][ni][2 * h], b0);
            const float v1 = __fadd_rn(acc[mi][ni][2 * h + 1], b1);
            const size_t o = static_cast<size_t>(row) * d + col;
            if (out_f32) {
              *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
        acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
      }
    }
    ks = 0;
    ++nt;
  }
  cp_async_wait<0>();
}

template <int kWarpsM>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int rows, int k,
                   int d, int out_f32, int bias_bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(kWarpsM, k);
  cudaError_t err = cudaFuncSetAttribute(patch_embed_kernel<kWarpsM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int block_m = kWarpsM * kWarpM;
  patch_embed_kernel<kWarpsM><<<(rows + block_m - 1) / block_m, block_threads(kWarpsM), smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(w), bias, out, rows, k, d,
      out_f32, bias_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (rows, d) bf16 (out_f32 = 0) or f32 of uint8 patch rows x (rows, k)
// against the row-major bf16 weights w (k, d), plus the bias (d,), f32 or
// bf16 (bias_bf16 = 1). k % 4 == 0, x 16-byte aligned; d % 8 == 0, w
// 16-byte aligned; k up to 640 with 128-row blocks, 1344 with 64-row blocks
// (the dequantised rows must fit in shared memory).
int tpuclip_patch_embed(const void* x, const void* w, const void* bias, void* out, int rows, int k,
                        int d, int out_f32, int bias_bf16, void* stream) {
  if (k % 4 != 0 || k < 4 || d % 8 != 0 || rows < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(2, k) <= static_cast<size_t>(optin)) {
    return static_cast<int>(launch<2>(x, w, bias, out, rows, k, d, out_f32, bias_bf16, s));
  }
  if (smem_bytes(1, k) <= static_cast<size_t>(optin)) {
    return static_cast<int>(launch<1>(x, w, bias, out, rows, k, d, out_f32, bias_bf16, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
