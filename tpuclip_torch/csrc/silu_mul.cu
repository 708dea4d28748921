// SwiGLU's gate, silu(a) * b over the two halves of a row (kernel 11), for
// the PyTorch port's DINOv2 towers (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces no TPU kernel: tpuclip has no SwiGLU tower. Added with DINOv2
// (ViT-g/14 with registers), whose MLP is weights_out(silu(a) * b) with
// [a | b] = weights_in(x), the first and second H columns of one (M, 2H)
// product. PyTorch computes the gate as silu(a), written out, then the
// product: five element passes a token (read a, write silu(a), read it and
// b, write the product) against the three this kernel makes. At DINOv2-g's
// H = 4096 and 1,374 tokens an image, the gate moves 1.35 GB an image.
//
// What it computes, for rows of (M, 2H) bf16 input, contiguous:
//   out[m, j] = bf16(silu(f32(in[m, j])) * f32(in[m, H + j]))       j < H
// silu(a) = a / (1 + exp(-a)) in fp32, the product in fp32, rounded once.
// The output is a new contiguous (M, H) bf16 tensor.
//
// What bounds it on the H100: bytes, 3 * H * 2 a row (read a and b, write
// the product), a few operations a byte. Design, for the bytes: each thread
// takes kVecs 16-byte vectors of a row's output (8 values each), issues all
// 2 * kVecs loads of a and b before any arithmetic, then writes kVecs
// vectors. Neighbouring threads take neighbouring vectors, so every load
// and store of a warp covers 512 contiguous bytes. One block a row (rows
// are the grid's x, up to 2^31 - 1), so no index is divided; at H 4096 the
// 256 threads of 2 vectors cover the row once, with 64 bytes of loads in
// flight a thread and 8 blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // output vectors a thread: 4 loads of 16 bytes in flight

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

// One block a row; hv = H / 8, the row's output vectors. Thread t takes
// vectors c0 + t + k * kThreads of each chunk of kThreads * kVecs (at H 4096
// one chunk: the whole row).
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int hv) {
  const size_t row = blockIdx.x;
  const uint4* a_row = in + row * 2 * hv;
  const uint4* b_row = a_row + hv;
  uint4* o_row = out + row * hv;
  for (int c0 = 0; c0 < hv; c0 += kThreads * kVecs) {
    uint4 av[kVecs], bv[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int c = c0 + threadIdx.x + k * kThreads;
      if (c < hv) {
        av[k] = __ldg(a_row + c);
        bv[k] = __ldg(b_row + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int c = c0 + threadIdx.x + k * kThreads;
      if (c < hv) {
        float a[8], b[8], o[8];
        widen(av[k], a);
        widen(bv[k], b);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = a[j] / (1.0f + expf(-a[j])) * b[j];
        o_row[c] = narrow(o);
      }
    }
  }
}

}  // namespace

extern "C" {

// out (rows, h) = silu(in[:, :h]) * in[:, h:] for in (rows, 2h); both bf16,
// contiguous and 16-byte aligned; h % 8 == 0.
int tpuclip_silu_mul(const void* in, void* out, int rows, int h, void* stream) {
  if (rows < 1 || h < 8 || h % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  silu_mul_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), h / 8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
