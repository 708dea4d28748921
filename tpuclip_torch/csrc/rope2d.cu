// DINOv3's 2-D rotary position on the patch rows of q and k, one pass
// (kernel 12), for the PyTorch port's towers (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces no TPU kernel: tpuclip's towers add a learned position table.
// Added with DINOv3 (ViT-7B/16), whose positions enter only through RoPE on
// each head of q and k, patch rows only. HF's form is a split of the
// prefix rows, rotate_half's slices, a negation and a cat, two products, a
// sum and a cat back: several full passes over two (B, S, 4096) tensors in
// each of 40 layers. This pass reads and writes each rotated row once.
//
// What it computes, for q and k of (B, S, H * hd) bf16, contiguous (the
// projections' output), rows p + prefix of each image (p < P = S - prefix),
// and for each head and each j < hd / 2:
//   lo = x[j], hi = x[j + hd / 2], c = cos[p, j], s = sin[p, j]   (fp32)
//   x[j]          = bf16(lo * c - hi * s)
//   x[j + hd / 2] = bf16(hi * c + lo * s)
// in place; the prefix rows (class and register tokens) are not touched.
// That is HF's x * cos + rotate_half(x) * sin with its tiled (P, hd) table,
// whose two halves are equal: cos and sin are (P, hd / 2) fp32 here. Each
// product and the sum are rounded to fp32 on their own (no contraction into
// an FMA), as PyTorch's separate multiplies and add round them, so the
// result is bit-equal to the plain version rounded once.
//
// What bounds it on the H100: bytes, 2 tensors x 2 (read, write) x D x 2
// bytes a rotated row, about one operation a byte; the table (P x hd x 4
// bytes for cos and sin together, 512 KB at DINOv3-7B's 512 px) is read by
// every head and image and stays in L2. Design, for the bytes: one block a
// rotated row; each thread takes one 16-byte vector of a head's first half
// (8 columns) and the matching vector of its second half, in q and in k:
// four 16-byte loads issued before any arithmetic, the table's 8 cos and 8
// sin values as four 16-byte loads, four 16-byte stores. At hd 128 and D
// 4096 the 256 threads of a block cover the row's 256 vector pairs once;
// neighbouring threads take neighbouring vectors of one half-head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void load8(const float4* p, float (&f)[8]) {
  const float4 a = __ldg(p), b = __ldg(p + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The rotation of one pair of vectors, lo (columns j..j+7 of a head) and hi
// (j + hd/2 ..): rounded products and sum, no FMA.
__device__ __forceinline__ void rotate(uint4& lo_v, uint4& hi_v, const float (&c)[8], const float (&s)[8]) {
  float lo[8], hi[8], out_lo[8], out_hi[8];
  widen(lo_v, lo);
  widen(hi_v, hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out_lo[i] = __fsub_rn(__fmul_rn(lo[i], c[i]), __fmul_rn(hi[i], s[i]));
    out_hi[i] = __fadd_rn(__fmul_rn(hi[i], c[i]), __fmul_rn(lo[i], s[i]));
  }
  lo_v = narrow(out_lo);
  hi_v = narrow(out_hi);
}

// One block a rotated row r = b * patches + p. row_vecs = D / 8, the row's
// 16-byte vectors; half = hd / 16, the vectors of half a head; pairs = D /
// 16, the row's vector pairs. Thread t takes pairs t, t + kThreads, ...
__global__ void __launch_bounds__(kThreads)
rope2d_kernel(uint4* __restrict__ q, uint4* __restrict__ k, const float4* __restrict__ cos_t,
              const float4* __restrict__ sin_t, int seq, int prefix, int patches, int row_vecs, int half,
              int pairs) {
  const int r = blockIdx.x;
  const int b = r / patches;
  const int p = r - b * patches;
  const size_t base = (static_cast<size_t>(b) * seq + prefix + p) * row_vecs;
  const float4* c_row = cos_t + static_cast<size_t>(p) * half * 2;  // hd / 2 floats, 2 float4 a vector
  const float4* s_row = sin_t + static_cast<size_t>(p) * half * 2;
  for (int t = threadIdx.x; t < pairs; t += kThreads) {
    const int head = t / half;
    const int j = t - head * half;
    const size_t lo = base + static_cast<size_t>(head) * 2 * half + j;
    const size_t hi = lo + half;
    uint4 q_lo = q[lo], q_hi = q[hi], k_lo = k[lo], k_hi = k[hi];  // plain loads: the kernel writes them back
    float c[8], s[8];
    load8(c_row + 2 * j, c);
    load8(s_row + 2 * j, s);
    rotate(q_lo, q_hi, c, s);
    rotate(k_lo, k_hi, c, s);
    q[lo] = q_lo;
    q[hi] = q_hi;
    k[lo] = k_lo;
    k[hi] = k_hi;
  }
}

}  // namespace

extern "C" {

// Rotates rows prefix .. seq - 1 of each of the `batch` images of q and k
// (batch, seq, d) in place, heads of width hd (d % hd == 0, hd % 16 == 0),
// by the (seq - prefix, hd / 2) fp32 tables cos and sin; q and k bf16,
// contiguous, 16-byte aligned, the tables 16-byte aligned.
int tpuclip_rope2d(void* q, void* k, const void* cos_t, const void* sin_t, int batch, int seq, int prefix, int d,
                   int hd, void* stream) {
  const int patches = seq - prefix;
  if (batch < 1 || prefix < 0 || patches < 1 || hd < 16 || hd % 16 != 0 || d < hd || d % hd != 0 ||
      static_cast<long long>(batch) * patches >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rope2d_kernel<<<batch * patches, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(q), static_cast<uint4*>(k), static_cast<const float4*>(cos_t),
      static_cast<const float4*>(sin_t), seq, prefix, patches, d / 8, hd / 16, d / 16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
