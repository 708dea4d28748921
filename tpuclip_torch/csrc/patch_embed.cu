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
// patch rows (R, K) and bf16 weights W (K, D), fp32 accumulation, the bias
// added in fp32, then out cast to bf16 (or kept f32). x is formed as a
// multiply then a subtract, each rounded (no fused multiply-add), and
// rounded to bf16 to nearest-even, as the TPU kernel's x.astype(w.dtype):
// the products of bf16 values are then exact in fp32, and the result
// differs from the plain version only by summation order.
//
// What bounds it on the H100: at SO400M's patch shape (K = 588, D = 1152)
// and batch 64 (R = 16,384) it is 2 * R * K * D = 22.2 GFLOP over ~50 MB
// (uint8 rows, bf16 weights, bf16 out): compute-bound on the bf16 tensor
// cores.
//
// Design: the image bytes are read once, 1 byte per pixel, and dequantised
// in registers on the way into shared memory; the (R, K) bf16 activations
// never exist in device memory. A block computes a 128 x 128 tile of the
// output with 8 warps (2 x 4), each a 64 x 32 sub-tile of mma.sync
// m16n8k16 (bf16 in, fp32 accumulation), over K in slices of 64: the
// slice's uint8 rows (4-byte loads: a 588-byte row is only 4-byte aligned)
// and the weight slice (16-byte loads from a K-major (D, K_pad) copy the
// wrapper makes, zero past K) are staged in shared memory, padded rows
// keeping the fragment loads free of bank conflicts. The last slice
// zero-fills K past 588. Later work: cp.async or TMA pipelining and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kKSlice = 64;                 // bf16 elements of K per stage
constexpr int kStride = kKSlice + 8;        // shared row stride, elements
constexpr int kWarpM = 64;                  // rows per warp (4 x m16)
constexpr int kWarpN = 32;                  // columns per warp (4 x n8)
constexpr unsigned kInv127_5 = 0x3c008081u;  // float32(1 / 127.5)

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One pixel byte → x = u * f32(1/127.5) - 1, two roundings, as bf16 bits.
__device__ __forceinline__ unsigned short dequant(unsigned byte) {
  const float x = __fsub_rn(__fmul_rn(static_cast<float>(byte), __uint_as_float(kInv127_5)), 1.0f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Grid: (ceil(D / 128), ceil(R / 128)), column tile fastest, so the blocks
// that share a slab of patch rows run together and find it in L2.
__global__ void __launch_bounds__(kThreads)
    patch_embed_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                       const float* __restrict__ bias, void* __restrict__ out, int rows, int k,
                       int k_pad, int d, int out_f32) {
  __shared__ __align__(16) __nv_bfloat16 as[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 bs[kBlockN * kStride];
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / 4) * kWarpM;
  const int wn = (warp % 4) * kWarpN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int kb = 0; kb < k_pad; kb += kKSlice) {
    // Patch rows: 128 rows x 16 words of 4 bytes, dequantised to bf16.
#pragma unroll
    for (int j = 0; j < kBlockM * (kKSlice / 4) / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / (kKSlice / 4);
      const int w = idx % (kKSlice / 4);
      const int row = m0 + r;
      const int col = kb + 4 * w;
      unsigned word = 0;
      const bool ok = row < rows && col < k;
      if (ok) word = __ldg(reinterpret_cast<const unsigned*>(x + static_cast<size_t>(row) * k + col));
      uint2 packed = make_uint2(0u, 0u);
      if (ok) {
        packed.x = dequant(word & 0xffu) | (static_cast<unsigned>(dequant((word >> 8) & 0xffu)) << 16);
        packed.y = dequant((word >> 16) & 0xffu) | (static_cast<unsigned>(dequant(word >> 24)) << 16);
      }
      *reinterpret_cast<uint2*>(as + r * kStride + 4 * w) = packed;
    }
    // Weights: 128 output columns x 8 chunks of 8 bf16 (16 bytes).
#pragma unroll
    for (int j = 0; j < kBlockN * (kKSlice / 8) / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int n = idx / (kKSlice / 8);
      const int c = idx % (kKSlice / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < d) {
        v = __ldg(reinterpret_cast<const uint4*>(wt + static_cast<size_t>(n0 + n) * k_pad + kb + 8 * c));
      }
      *reinterpret_cast<uint4*>(bs + n * kStride + 8 * c) = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kKSlice; ks += 16) {
      unsigned a[4][4];
      unsigned b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* p = as + (wm + mi * 16 + g) * kStride + ks + 2 * t;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kStride);
        a[mi][2] = lds32(p + 8);
        a[mi][3] = lds32(p + 8 * kStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = bs + (wn + ni * 8 + g) * kStride + ks + 2 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // Epilogue: + bias in fp32, then bf16 (round to nearest even) or f32.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= d) continue;
      const float b0 = bias[col];
      const float b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= rows) continue;
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
  }
}

}  // namespace

extern "C" {

// out (rows, d) bf16 (out_f32 = 0) or f32 of uint8 patch rows x (rows, k)
// against the K-major bf16 weights wt (d, k_pad), zero past k, plus the f32
// bias (d,). k % 4 == 0 and x 4-byte aligned; k_pad % 64 == 0, k <= k_pad,
// wt 16-byte aligned; d % 2 == 0.
int tpuclip_patch_embed(const void* x, const void* wt, const void* bias, void* out, int rows,
                        int k, int k_pad, int d, int out_f32, void* stream) {
  if (k % 4 != 0 || k_pad % kKSlice != 0 || k > k_pad || d % 2 != 0 || rows < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((d + kBlockN - 1) / kBlockN, (rows + kBlockM - 1) / kBlockM);
  patch_embed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), out, rows, k, k_pad, d, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
