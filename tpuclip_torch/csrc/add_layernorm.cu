// The residual add and the LayerNorm after it, one pass (kernel 10), for
// the PyTorch port's towers (NVIDIA Hopper, sm_90a).
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; every pointer argument
// and the stream are void*, the entry point returns cudaGetLastError().
//
// Replaces no TPU kernel: tpuclip leaves LayerNorm and the residual add to
// XLA's fusion. Added because, once the GEMMs and attention were the port's
// own (kernel 9), the towers' largest removable cost was PyTorch's separate
// passes over the activations: each pre-LN block adds a sublayer's output
// to the residual stream and the next LayerNorm reads that sum straight
// back. At SO400M (D 1152, 27 layers) and 256 tokens an image, PyTorch's
// LayerNorm ran at ~46% of its byte bound (0.0424 ms an image against
// 0.0194) and the adds at ~94% of theirs (0.0304 against 0.0285):
// 0.0728 ms of the ~0.5 ms an image took on the H100 at 700 W.
//
// What it computes, for rows of width D (bf16, contiguous):
//   x_out = bf16(f32(x) + f32(delta))                    (delta null: x_out is x, not written)
//   x_out = bf16(f32(x) + f32(scale) * f32(delta))       (scale not null: LayerScale's pending branch)
//   y     = bf16((x_out - mean) * rsqrt(var + eps) * f32(weight) + f32(bias))
// with the mean and the biased variance taken in fp32 from the rounded
// x_out, so x_out is bit-equal to PyTorch's bf16 add and y differs from
// F.layer_norm only by the order of the row's sums (one bf16 step at most).
// With a scale (DINOv2's LayerScale, a (D,) bf16 vector) the product of two
// bf16 values is exact in fp32, so the sum is rounded once to fp32 and once
// to bf16, as fp32 arithmetic on the upcast operands rounds it. The scale is
// a template flag: a null scale runs the kernel that ran before it existed.
//
// What bounds it on the H100: bytes. A fused row reads x and delta and
// writes x_out and y, 4 * D * 2 bytes; a row without delta reads x and
// writes y, 2 * D * 2 bytes. Weight and bias (2 * D * 2 bytes), and the
// scale, are read once a block. There are ~10 flops a byte, far below the ridge.
//
// Design, for the bytes: one row per warp (2,304 bytes at D 1152), each
// lane holding up to 6 16-byte vectors of it (D up to 6 * 32 * 8 = 1536,
// giant-opt's width; the template takes ceil(D / 256)). All of a row's x and
// delta loads are issued before any arithmetic, so the whole row is in
// flight at once; the sum is rounded to bf16, stored, and kept in
// registers, and the mean and then the variance (two passes over the
// registers, no second read of memory) come from warp shuffles. Weight and
// bias are loaded once per block into shared memory and kept across the
// rows of a grid-stride loop over as many blocks as fit on the card at once
// (held in registers instead, they took the kernel to 189 registers a
// thread at D 1152, one block of 8 warps an SM: the fused pass ran as fast,
// 84% of its bound at 65,536 rows, but the LayerNorm alone at 69% against
// 80% with two blocks an SM at 128 registers; three blocks at 80 registers
// spill and fell to 68% fused). Loads and stores are 16
// bytes a lane, neighbouring lanes on neighbouring addresses. Row counts
// run from 64 (one text query) to 65,536 (a 224 batch of 256); nothing
// else of the shape varies, so one design serves them all.
//
// Wider rows (D 1544 to 4096: DINOv3-7B's 4096) take a second design, a
// row a block of 4 warps: a lane's share of a 4096-wide row in one warp
// would be 16 vectors, 128 values in registers, past the budget above.
// Each of the block's 128 threads holds up to 4 vectors of the row (lane t
// holds vectors t, t + 128, ...), issues their x and delta loads first,
// and takes part in each of the two sums through a warp shuffle and then
// the block's 4 partials in shared memory (two block barriers a row, the
// mean's and the variance's partials in buffers of their own, so a fast
// warp's next row cannot overwrite a slow warp's unread partial). Weight,
// bias and scale stay in shared memory across the grid-stride loop, as in
// the narrow design. The arithmetic is the narrow design's, in another
// order of the row's sums. The narrow kernel is unchanged: D <= 1536 runs
// the instructions it ran before the wide design existed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 8;        // warps a block, one row each at a time
constexpr int kBlocksPerSm = 2;  // the register budget: 128 a thread
constexpr int kMaxVecs = 6;      // 16-byte vectors a lane: D up to 6 * 32 * 8 = 1536
constexpr int kWideThreads = 128;  // the wide design: one row a block of 4 warps
constexpr int kWideMaxVecs = 4;    // 16-byte vectors a thread: D up to 4 * 128 * 8 = 4096

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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// kVecs: 16-byte vectors a lane (ceil(D / 256)); vecs = D / 8, the row's
// vectors, lane l holding vectors l, l + 32, ... below vecs.
// kScale (with kDelta): delta is multiplied by scale, a (D,) vector, before the add.
template <int kVecs, bool kDelta, bool kScale>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
add_layernorm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ delta,
                     const uint4* __restrict__ scale, const uint4* __restrict__ weight,
                     const uint4* __restrict__ bias, uint4* __restrict__ x_out, uint4* __restrict__ y, int rows,
                     int vecs, float eps) {
  static_assert(kDelta || !kScale, "a scale multiplies the pending residual");
  __shared__ uint4 w[kVecs * 32], b[kVecs * 32], g[kScale ? kVecs * 32 : 1];
  for (int c = threadIdx.x; c < vecs; c += kWarps * 32) {
    w[c] = __ldg(weight + c);
    b[c] = __ldg(bias + c);
    if (kScale) g[c] = __ldg(scale + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.0f / static_cast<float>(vecs * 8);
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows; row += stride) {
    const size_t base = static_cast<size_t>(row) * vecs;
    uint4 xv[kVecs], dv[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) {
        xv[i] = __ldg(x + base + c);
        if (kDelta) dv[i] = __ldg(delta + base + c);
      }
    }
    float v[kVecs][8];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) {
        widen(xv[i], v[i]);
        if (kDelta) {
          float d[8];
          widen(dv[i], d);
          if (kScale) {
            float gf[8];
            widen(g[c], gf);
#pragma unroll
            for (int j = 0; j < 8; ++j) d[j] *= gf[j];  // exact: a product of two bf16 values
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i][j] += d[j];
          const uint4 rounded = narrow(v[i]);
          x_out[base + c] = rounded;
          widen(rounded, v[i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += v[i][j];
      }
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < vecs) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = v[i][j] - mean;
          sq += t * t;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) {
        float wf[8], bf[8], out[8];
        widen(w[c], wf);
        widen(b[c], bf);
#pragma unroll
        for (int j = 0; j < 8; ++j) out[j] = wf[j] * (rstd * (v[i][j] - mean)) + bf[j];
        y[base + c] = narrow(out);
      }
    }
  }
}

template <int kVecs, bool kDelta, bool kScale>
cudaError_t launch(const void* x, const void* delta, const void* scale, const void* weight, const void* bias,
                   void* x_out, void* y, int rows, int vecs, float eps, cudaStream_t stream) {
  auto kernel = add_layernorm_kernel<kVecs, kDelta, kScale>;
  static int blocks_per_sm = 0;  // the occupancy calculator's, once per instantiation
  if (blocks_per_sm == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWarps * 32, 0);
    if (err != cudaSuccess) return err;
    blocks_per_sm = std::max(n, 1);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = std::min((rows + kWarps - 1) / kWarps, std::max(sms, 1) * blocks_per_sm);
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(delta), static_cast<const uint4*>(scale),
      static_cast<const uint4*>(weight), static_cast<const uint4*>(bias), static_cast<uint4*>(x_out),
      static_cast<uint4*>(y), rows, vecs, eps);
  return cudaGetLastError();
}

template <int kVecs>
cudaError_t launch_width(const void* x, const void* delta, const void* scale, const void* weight, const void* bias,
                         void* x_out, void* y, int rows, int vecs, float eps, cudaStream_t stream) {
  if (scale != nullptr) {
    return launch<kVecs, true, true>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, stream);
  }
  return delta != nullptr
             ? launch<kVecs, true, false>(x, delta, nullptr, weight, bias, x_out, y, rows, vecs, eps, stream)
             : launch<kVecs, false, false>(x, nullptr, nullptr, weight, bias, x_out, y, rows, vecs, eps, stream);
}

// The wide design: one row a block of kWideThreads, kVecs vectors a thread
// (ceil(vecs / 128)); vecs = D / 8.
template <int kVecs, bool kDelta, bool kScale>
__global__ void __launch_bounds__(kWideThreads)
add_layernorm_wide_kernel(const uint4* __restrict__ x, const uint4* __restrict__ delta,
                          const uint4* __restrict__ scale, const uint4* __restrict__ weight,
                          const uint4* __restrict__ bias, uint4* __restrict__ x_out, uint4* __restrict__ y, int rows,
                          int vecs, float eps) {
  static_assert(kDelta || !kScale, "a scale multiplies the pending residual");
  constexpr int kWarpsWide = kWideThreads / 32;
  __shared__ uint4 w[kVecs * kWideThreads], b[kVecs * kWideThreads], g[kScale ? kVecs * kWideThreads : 1];
  __shared__ float part_mean[kWarpsWide], part_var[kWarpsWide];
  for (int c = threadIdx.x; c < vecs; c += kWideThreads) {
    w[c] = __ldg(weight + c);
    b[c] = __ldg(bias + c);
    if (kScale) g[c] = __ldg(scale + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / static_cast<float>(vecs * 8);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * vecs;
    uint4 xv[kVecs], dv[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = threadIdx.x + kWideThreads * i;
      if (c < vecs) {
        xv[i] = __ldg(x + base + c);
        if (kDelta) dv[i] = __ldg(delta + base + c);
      }
    }
    float v[kVecs][8];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = threadIdx.x + kWideThreads * i;
      if (c < vecs) {
        widen(xv[i], v[i]);
        if (kDelta) {
          float d[8];
          widen(dv[i], d);
          if (kScale) {
            float gf[8];
            widen(g[c], gf);
#pragma unroll
            for (int j = 0; j < 8; ++j) d[j] *= gf[j];  // exact: a product of two bf16 values
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i][j] += d[j];
          const uint4 rounded = narrow(v[i]);
          x_out[base + c] = rounded;
          widen(rounded, v[i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += v[i][j];
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) part_mean[warp] = sum;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarpsWide; ++i) total += part_mean[i];
    const float mean = total * inv_d;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (threadIdx.x + kWideThreads * i < vecs) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = v[i][j] - mean;
          sq += t * t;
        }
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) part_var[warp] = sq;
    __syncthreads();
    float total_sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarpsWide; ++i) total_sq += part_var[i];
    const float rstd = rsqrtf(total_sq * inv_d + eps);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = threadIdx.x + kWideThreads * i;
      if (c < vecs) {
        float wf[8], bf[8], out[8];
        widen(w[c], wf);
        widen(b[c], bf);
#pragma unroll
        for (int j = 0; j < 8; ++j) out[j] = wf[j] * (rstd * (v[i][j] - mean)) + bf[j];
        y[base + c] = narrow(out);
      }
    }
  }
}

template <int kVecs, bool kDelta, bool kScale>
cudaError_t launch_wide(const void* x, const void* delta, const void* scale, const void* weight, const void* bias,
                        void* x_out, void* y, int rows, int vecs, float eps, cudaStream_t stream) {
  auto kernel = add_layernorm_wide_kernel<kVecs, kDelta, kScale>;
  static int blocks_per_sm = 0;  // the occupancy calculator's, once per instantiation
  if (blocks_per_sm == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWideThreads, 0);
    if (err != cudaSuccess) return err;
    blocks_per_sm = std::max(n, 1);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = std::min(rows, std::max(sms, 1) * blocks_per_sm);
  kernel<<<blocks, kWideThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(delta), static_cast<const uint4*>(scale),
      static_cast<const uint4*>(weight), static_cast<const uint4*>(bias), static_cast<uint4*>(x_out),
      static_cast<uint4*>(y), rows, vecs, eps);
  return cudaGetLastError();
}

template <int kVecs>
cudaError_t launch_wide_width(const void* x, const void* delta, const void* scale, const void* weight,
                              const void* bias, void* x_out, void* y, int rows, int vecs, float eps,
                              cudaStream_t stream) {
  if (scale != nullptr) {
    return launch_wide<kVecs, true, true>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, stream);
  }
  return delta != nullptr
             ? launch_wide<kVecs, true, false>(x, delta, nullptr, weight, bias, x_out, y, rows, vecs, eps, stream)
             : launch_wide<kVecs, false, false>(x, nullptr, nullptr, weight, bias, x_out, y, rows, vecs, eps, stream);
}

}  // namespace

extern "C" {

// x_out = x + delta (scale not null: x + scale * delta, scale a (d,)
// vector, LayerScale) and y = LayerNorm(x_out) * weight + bias for rows of
// width d; every tensor bf16, contiguous and 16-byte aligned, weight and
// bias (d,). delta and x_out both null: a plain LayerNorm of x into y (and
// scale null too). d % 8 == 0 and 8 <= d <= 4096: up to 1536 a row a
// warp, wider a row a block.
int tpuclip_add_layernorm(const void* x, const void* delta, const void* scale, const void* weight, const void* bias,
                          void* x_out, void* y, int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0 || d > kWideMaxVecs * kWideThreads * 8 ||
      (delta == nullptr) != (x_out == nullptr) || (scale != nullptr && delta == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = d / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kMaxVecs * 256) {
    switch ((vecs + kWideThreads - 1) / kWideThreads) {
      case 2: return static_cast<int>(launch_wide_width<2>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
      case 3: return static_cast<int>(launch_wide_width<3>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
      default: return static_cast<int>(launch_wide_width<4>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    }
  }
  switch ((vecs + 31) / 32) {
    case 1: return static_cast<int>(launch_width<1>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    case 2: return static_cast<int>(launch_width<2>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    case 3: return static_cast<int>(launch_width<3>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    case 4: return static_cast<int>(launch_width<4>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    case 5: return static_cast<int>(launch_width<5>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
    default: return static_cast<int>(launch_width<6>(x, delta, scale, weight, bias, x_out, y, rows, vecs, eps, s));
  }
}

}  // extern "C"
