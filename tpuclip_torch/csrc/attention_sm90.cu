// Fused multi-head attention for the towers, Hopper design (NVIDIA H100,
// sm_90a): kernel 9's second kernel, beside attention.cu's mma.sync one.
//
// Built by tpuclip_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library bound with ctypes; the entry point returns
// a cudaError_t. It needs no libcuda at link time: cuTensorMapEncodeTiled
// is reached through cudaGetDriverEntryPoint.
//
// Replaces no TPU kernel: tpuclip computes attention as two einsums and
// leaves the fusion to XLA (tpuclip/models/siglip.py, mha). At head widths
// 72, 96 and 128 it computes what attention.cu computes, with the same
// arithmetic (see that file's note): bf16 q, k, v read in place from the
// projections' (B, S, H * hd) outputs; fp32 logits from the tensor cores;
// scale, then the fp32 key bias, each rounded in fp32; an fp32 online
// softmax whose unnormalised exp(s - m) (ex2.approx.ftz of (s - m) *
// log2(e), s - m formed first) is rounded once to bf16 for PV; PV
// accumulated in fp32; the row sum's division in fp32 and the output
// rounded once to bf16, into the (B, Sq, H * hd) tensor the output
// projection reads. At head width 64 the exponent is formed in one FFMA
// instead (see below): rounded once where the others round it three times.
//
// What bounds it on the H100: at the 384-pixel tower's launch (B = 64,
// S = 729, 16 heads of 72) the work is 156.7 GFLOP against 107 MB read and
// 54 MB written: 364 FLOP a byte against the card's ridge of 295, so
// operations bound it, at 0.1585 ms for 989 TFLOP/s. At head width 72 the
// softmax is nearly as long as the products: a query-key pair costs ~304
// tensor-core FLOP (QK^T at hd padded to 80, PV at 72), one ex2 on the
// MUFU (16 a clock an SM) and ~6 more instructions on the FMA pipe. At the
// tensor cores' ~4,096 FLOP a clock an SM that is 13.5 pairs a clock, so
// the exponentials alone need ~84% of the products' time: the two have to
// run at once. attention.cu's mma.sync form runs them one after the other
// in each warp (a third products, a third softmax, a third loads by its
// clock64() phases) and reaches 17% of the bound at this shape.
//
// Design (FlashAttention-3's form, fitted to head width 72). A tile is 128
// query rows of one (b, h); a block is persistent: gridDim.x blocks (one
// an SM) walk the tiles, query tile fastest, so the tiles of one (b, h)
// run at once on neighbouring blocks and share its K and V through L2, and
// a block's next tile loads while this one computes. A block is three
// warpgroups. Warpgroup 0 is the producer: it gives up its registers
// (setmaxnreg), one thread keeps TMA loads in flight (each tile's Q into
// one of two buffers, then 128-key tiles of K and V into a ring of two
// stages each, every buffer and stage with a full and an empty mbarrier)
// and another warp copies each tile's key-bias row into one of two rows.
// Warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T by
// wgmma from shared memory (m64n128k16, fp32 accumulators in registers),
// the softmax in registers, and O += P V by wgmma with P as the A operand
// in registers (the fp32 accumulator of S packed to bf16 is already A's
// fragment layout), V from shared memory. Within a warpgroup, QK^T of key
// tile j is issued together with PV of key tile j - 1, so that the softmax
// of j runs while PV of j - 1 is on the tensor cores; across the two
// warpgroups, two named barriers hand the tensor cores back and forth, so
// that one warpgroup issues its products while the other computes its
// softmax (the ping-pong). The key tiles go in reverse order, so the
// ragged last one comes first and is the only one masked.
//
// hd 72 is 144 bytes a row, past the 128-byte swizzle span, so each Q and
// K row comes as two TMA boxes: columns 0-63 with the 128-byte swizzle and
// columns 64-79 with the 32-byte swizzle, whose columns 72-79 lie past hd
// in the tensor map and arrive as zeros: QK^T's fifth k16 step is exact
// with no zeroing pass. V's columns 0-63 come with the 128-byte swizzle
// and feed an m64n64k16 (V as the transposed, MN-major B operand); its
// columns 64-71 come unswizzled and feed an m64n8k16. Rows past Sq or Sk
// are out of bounds too, zero-filled; keys past Sk are -inf before the
// max. Every tensor map is rank 4, (hd, H, S, B), with the strides of the
// tensors as they are (separate projections, or slices of one fused qkv),
// encoded on the host at each launch and passed as __grid_constant__
// parameters, so a launch can be captured in a CUDA graph. Each consumer
// writes its output tile into shared memory and sends it with one TMA
// store, which clips the rows past Sq. Head widths 96 and 128 take the
// same form (96: columns 64-95 with the 64-byte swizzle for Q, K and V;
// 128: two 128-byte-swizzled chunks, the output tile in the tile's own Q
// buffer for want of room).
//
// Head width 64 (DINOv2-g: 24 heads over 1,374 keys, 40 launches a call).
// A query-key pair costs 256 tensor-core FLOP, 16 pairs a clock an SM, and
// the MUFU does 16 exponentials a clock: the exponentials are as long as
// the products, so the softmax has to hide whole behind the other
// warpgroup's products, and what it puts on the FMA pipe has to shrink.
// The same tiles and ping-pong, with two differences (Layout's kFfmaExp and
// kOneP). (1) The exponent in one FFMA: without a key bias the row max is
// taken on the raw logits (scale > 0) and exp(s scale - m scale) is
// 2^(s k - m k), k = scale log2(e) in fp32, so an element costs FMNMX,
// FFMA, MUFU.EX2, FADD and half an F2FP (3.7 instructions on the FMA pipe
// a key tile's element by the SASS, against 5.7 with the scale, subtract
// and log2(e) product rounded one by one). With a key bias the producer
// stores the bias row times log2(e), t = s k + bias log2(e) is one FFMA and
// 2^(t - m) another. Row sums and O stay fp32 and P is still rounded once
// to bf16 from the fp32 exponential. (2) One P: the form above packs the
// next P into a second set of registers while PV still reads the first,
// then copies it over; at hd 64 ptxas placed those copies inside the next
// products' pipeline stage and serialized every wgmma of the kernel (C7513,
// "non wgmma instructions defining input registers of a wgmma"). Here P is
// packed straight into PV's registers once PV of the key tile before has
// retired: no copy, no serialization.
//
// Which launches take it (tpuclip_torch/ops/attention.py, takes_sm90):
// head widths 64, 72, 96 and 128, Sq of 128 rows or more, Sk up to 4096
// (two key-bias rows in shared memory). Kernel alone, both designs in
// turns in one call (16 heads of 72, p50 ms, this design / mma.sync): the
// 384 tower's layer, B 64 x S 729, 0.483 / 0.859 (32.8% / 18.5% of the
// 0.1585 ms bound by operations); the 224 tower's, B 256 x S 256, 0.322 /
// 0.492, and NaFlex's with its key bias 0.340 / 0.520 (bound 0.1803 ms by
// bytes); B 128 x S 128 0.079 / 0.107; the text tower's B 64 x S 64 0.049 /
// 0.046, where half of each 128-row tile is empty, so mma.sync keeps it.
// The MAP head's Sq = 1 stays on mma.sync too (0.132 there, 0.107 here at
// B 64 over 729 keys: a head launch is ~0.1 ms of a ~105 ms call). Head
// width 64, this form / the former one (serialized), in turns in one call:
// DINOv2's layer, B 32 x S 1,374 x 24 heads, 0.880-0.887 / 1.275-1.287
// (42.7% / 29.4% of the 0.3753 ms bound by operations); the B/16 preset's
// B 256 x S 196 x 12, 0.207-0.221 / 0.239-0.247 (44.4% / 38.6% of 0.0920
// by bytes); B 8 x S 1,374 with a key bias, 0.275-0.278 / 0.341-0.345.
//
// Tried and not kept (B 64, S 729): one 128-row tile a block, not
// persistent: 0.564 ms, half of it a fixed cost a block (1,536 keys took
// 0.949 against 0.575 over 768); the same without the ping-pong, 0.648;
// three K and V stages, 0.570; V in 8-column unswizzled boxes feeding one
// m64n72k16, 0.697; tree-shaped row maxima and sums, P packed after PV's
// wait (no second P in registers), O's rescale moved between the two
// products of a turn: each within 2% of the kept form. With the softmax
// taken out (P the raw logits) the kernel ran slower, 0.610 ms: at the
// card's 700 W limit the clock follows the data the tensor cores move, so
// a knock-out does not time its part. Not tried at hd 72: a polynomial
// exp2 on the FMA pipe for a share of the exponentials (the FMA pipe
// carries ~6 of the softmax's ~7 instructions an element, so moving work
// onto it would not shorten the softmax).
//
// Tried and not kept at hd 64 (DINOv2's launch, p50 ms, in turns): key
// tiles of 176 keys, 8 tiles over 1,374 keys for 11 (the same 1,408
// padded keys; 0.935-0.950 against 0.905-0.929, and 0.247 against 0.208
// at S 196, which it pads to 352 keys) and of 208 (0.922 against 0.896);
// a polynomial exp2 (degree 4, rint by 1.5 2^23, the exponent by an integer
// add) for a quarter or a third of the exponentials (0.934 and 1.008
// against 0.909, at 176 keys: the FMA pipe is no freer than the MUFU); a
// second P in registers with the loop unrolled by two, so that P is packed
// before PV's wait with no copy (0.908-0.926; at 176 keys ptxas serialized
// again, C7512, 1.14-1.17). ptxas puts PV's wait before the exponentials,
// since it packs P as they come out, so a warpgroup's softmax overlaps the
// other warpgroup's products but not its own PV; an empty asm fence on the
// softmax's registers before the wait left the SASS as it was.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kConsumers = 2;                // consumer warpgroups a block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kRowsWG = 64;                  // query rows a consumer warpgroup
constexpr int kBM = kConsumers * kRowsWG;    // query rows a tile
constexpr int kBN = 128;                     // keys a key tile
constexpr int kStages = 2;                   // K and V tiles in flight
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// How a head of width HD lies in shared memory. Q and K rows: kMain chunks
// of 64 columns (128 bytes, 128-byte swizzle), then a tail of kTailQK
// columns (hd's last columns padded to 16 with zeros; 32- or 64-byte
// swizzle). V rows: the same chunks, then a tail of kTail columns (8:
// unswizzled, 32: 64-byte swizzle).
template <int HD>
struct Layout {
  static constexpr int kMain = HD / 64;
  static constexpr int kTail = HD - 64 * kMain;
  static constexpr int kTailQK = (kTail + 15) / 16 * 16;
  static constexpr int kRowQK = 128 * kMain + 2 * kTailQK;  // bytes of a Q or K row
  static constexpr int kRowV = 128 * kMain + 2 * kTail;     // bytes of a V row
  static constexpr int kStepsQK = 4 * kMain + kTailQK / 16;  // k16 steps of QK^T
  static constexpr int kQBytes = kRowsWG * kRowQK;           // a consumer's Q tile
  static constexpr int kKBytes = kBN * kRowQK;               // a K stage
  static constexpr int kVBytes = kBN * kRowV;                // a V stage
  static constexpr int kOBytes = kRowsWG * HD * 2;           // a consumer's output tile
  // At hd 128 the output tile goes through the tile's own Q buffer, for
  // want of room beside it.
  static constexpr bool kOInQ = HD > 96;
  // Offsets in the 1024-aligned base: two Q buffers (tiles alternate), the
  // K and V rings, the output tiles, the barriers, two key-bias rows.
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kConsumers * kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kO = kV + kStages * kVBytes;
  static constexpr int kBar = kO + (kOInQ ? 0 : kConsumers * kOBytes);
  static constexpr int kBias = kBar + 256;
  // Head width 64 has its own softmax and P (see the note): the exponent
  // in one FFMA from the raw logits, and P packed into the registers PV
  // reads once PV of the key tile before has read them (one P, no copy).
  static constexpr bool kFfmaExp = HD == 64;
  static constexpr bool kOneP = HD == 64;
  static_assert(HD == 64 || HD == 72 || HD == 96 || HD == 128, "instantiated head widths");
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "swizzle alignment");
  static_assert(kOBytes % 128 == 0 && kOBytes <= kQBytes, "TMA store alignment; room in a Q buffer");
};

// Shared memory of a block: the tiles, the barriers, two key-bias rows of
// the padded keys (f32), and the slack to align the base to 1024 bytes.
template <int HD>
constexpr size_t smem_bytes(int sk) {
  return 1024 + Layout<HD>::kBias + 2 * static_cast<size_t>((sk + kBN - 1) / kBN * kBN) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// An arrival where pred holds (a predicated instruction, not a branch).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// Named barriers 1 .. 15 over `count` threads (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_if(int id, int count, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "@p bar.arrive %0, %1;\n"
      "}\n" ::"r"(id),
      "r"(count), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// ---------------------------------------------------------------------- TMA

// Box (c0, c1, c2, c3) of the rank-4 map into shared memory at dst, its
// bytes counted on bar; elements out of bounds arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Shared memory at src to box (c0, c1, c2, c3) of the map; elements out of
// bounds are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA, wgmma), and the async proxy's reads ordered before later writes.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -------------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), and the layout (0 none, 1 128-byte
// swizzle, 2 64-byte, 3 32-byte).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A (64 x 16, K-major in shared
// memory) B^T (N x 16, K-major in shared memory).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// d (64 x N, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x N,
// MN-major in shared memory).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor maps of one launch: Q, K and V each as a 64-column main box
// and a tail box (the main box again where hd has no tail), and the output.
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail, out;
};

// Persistent: gridDim.x blocks walk the tiles (query tile, head, batch),
// query tile fastest, block b taking tiles b, b + gridDim.x, ...; kThreads
// threads.
template <int HD, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    attention_sm90_kernel(const __grid_constant__ Maps maps, const float* __restrict__ bias, int bias_sb, int sk,
                          int q_tiles, int heads, int tiles, float scale) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const int n_keys = (sk + kBN - 1) / kBN;  // key tiles a tile
  float* const bias_rows = reinterpret_cast<float*>(sbase + L::kBias);  // [2][n_keys * kBN]
  // Barriers, 8 bytes each: Q full / empty and bias full / empty for the
  // two buffers, then K full / empty and V full / empty for each stage.
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto q_full = [&](int b) { return bar(b); };
  auto q_empty = [&](int b) { return bar(2 + b); };
  auto b_full = [&](int b) { return bar(4 + b); };
  auto b_empty = [&](int b) { return bar(6 + b); };
  auto k_full = [&](int s) { return bar(8 + s); };
  auto k_empty = [&](int s) { return bar(8 + kStages + s); };
  auto v_full = [&](int s) { return bar(8 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar(8 + 3 * kStages + s); };
  // The warpgroup's role, warp-uniform as the compiler sees it (a branch on
  // threadIdx would be divergent, and the products in it serialized).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), kConsumers);
      mbar_init(b_full(b), 32);
      mbar_init(b_empty(b), kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: warp 0's first thread issues every TMA load,
    // warp 1 copies each tile's key-bias row into shared memory.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x / 32;
    if (warp == 0 && threadIdx.x == 0) {
      int kv = 0;  // key tiles loaded so far, over all tiles
      for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
        const int q0 = (tile % q_tiles) * kBM;
        const int head = (tile / q_tiles) % heads;
        const int batch = tile / q_tiles / heads;
        const int qb = n & 1;
        if (n >= 2) mbar_wait(q_empty(qb), ((n >> 1) + 1) & 1);
        mbar_expect_tx(q_full(qb), kConsumers * L::kQBytes);
        for (int c = 0; c < kConsumers; ++c) {
          const uint32_t dst = base + L::kQ + (2 * c + qb) * L::kQBytes;
          const int row = q0 + c * kRowsWG;
#pragma unroll
          for (int m = 0; m < L::kMain; ++m)
            tma_load(dst + m * kRowsWG * 128, &maps.q, q_full(qb), 64 * m, head, row, batch);
          if (L::kTail)
            tma_load(dst + L::kMain * kRowsWG * 128, &maps.q_tail, q_full(qb), 64 * L::kMain, head, row, batch);
        }
        for (int j = 0; j < n_keys; ++j, ++kv) {
          const int s = kv % kStages;
          const uint32_t parity = ((kv / kStages) + 1) & 1;  // the stage's previous use
          const int row = (n_keys - 1 - j) * kBN;            // the key tiles in reverse order
          if (kv >= kStages) mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), L::kKBytes);
          const uint32_t kd = base + L::kK + s * L::kKBytes;
#pragma unroll
          for (int m = 0; m < L::kMain; ++m)
            tma_load(kd + m * kBN * 128, &maps.k, k_full(s), 64 * m, head, row, batch);
          if (L::kTail) tma_load(kd + L::kMain * kBN * 128, &maps.k_tail, k_full(s), 64 * L::kMain, head, row, batch);
          if (kv >= kStages) mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), L::kVBytes);
          const uint32_t vd = base + L::kV + s * L::kVBytes;
#pragma unroll
          for (int m = 0; m < L::kMain; ++m)
            tma_load(vd + m * kBN * 128, &maps.v, v_full(s), 64 * m, head, row, batch);
          if (L::kTail) tma_load(vd + L::kMain * kBN * 128, &maps.v_tail, v_full(s), 64 * L::kMain, head, row, batch);
        }
      }
    } else if (kBias && warp == 1) {
      const int lane = threadIdx.x % 32;
      for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
        const int bb = n & 1;
        if (n >= 2) mbar_wait(b_empty(bb), ((n >> 1) + 1) & 1);
        const float* src = bias + static_cast<size_t>(tile / q_tiles / heads) * bias_sb;
        float* dst = bias_rows + bb * n_keys * kBN;
        for (int i = lane; i < n_keys * kBN; i += 32) {
          const float b = i < sk ? src[i] : 0.0f;
          dst[i] = L::kFfmaExp ? __fmul_rn(b, kLog2e) : b;  // the FFMA softmax takes it in log2 units
        }
        mbar_arrive_if(b_full(bb), true);  // release: the row is visible to the waiting consumers
      }
    }
    return;
  }

  // Consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int g = (t % 32) / 4;  // rows 16 (t / 32) + g and + 8 of the warpgroup's 64
  const int t4 = t % 4;        // columns 8 n + 2 t4 and + 1 of each n8 block
  // The ping-pong: warpgroup c issues its products after barrier 1 + c
  // (its own arrival and the other's), then lets the other go; warpgroup
  // 0 goes first. Every turn but the block's last hands over.
  const int my_turn = 1 + c;
  const int other_turn = 2 - c;
  if (c == 1) bar_arrive(1, kConsumers * 128);

  // QK^T's k16 step kk: A (Q, buffer qb) and B (K, stage s) descriptors.
  auto q_desc = [&](int qb, int kk) {
    const uint32_t qs = base + L::kQ + (2 * c + qb) * L::kQBytes;
    if (kk < 4 * L::kMain) return gmma_desc(qs + (kk / 4) * kRowsWG * 128 + (kk % 4) * 32, 16, 1024, 1);
    return gmma_desc(qs + L::kMain * kRowsWG * 128 + (kk - 4 * L::kMain) * 32, 16, 16 * L::kTailQK,
                     L::kTailQK == 16 ? 3 : 2);
  };
  auto k_desc = [&](int s, int kk) {
    const uint32_t ks = base + L::kK + s * L::kKBytes;
    if (kk < 4 * L::kMain) return gmma_desc(ks + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024, 1);
    return gmma_desc(ks + L::kMain * kBN * 128 + (kk - 4 * L::kMain) * 32, 16, 16 * L::kTailQK,
                     L::kTailQK == 16 ? 3 : 2);
  };
  // PV's k16 step kk (keys 16 kk ..): V's descriptors at stage s, MN-major.
  auto v_desc = [&](int s, int m, int kk) {
    return gmma_desc(base + L::kV + s * L::kVBytes + m * kBN * 128 + kk * 2048, kBN * 128, 1024, 1);
  };
  auto v_tail_desc = [&](int s, int kk) {
    const uint32_t vt = base + L::kV + s * L::kVBytes + L::kMain * kBN * 128;
    if constexpr (L::kTail == 8) return gmma_desc(vt + kk * 256, 128, 256, 0);  // 8 x 8 core matrices
    return gmma_desc(vt + kk * 1024, 256, 512, 2);
  };

  // O: accumulator i holds row g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t4 + (i & 1).
  float o[HD / 2];
  float s_acc[kBN / 2];
  uint32_t p[kBN / 4];  // bf16(exp(s - m)) of the key tile before, as PV's A fragments
  float m_run[2];
  float l_run[2];
  float corr[2];  // the last softmax's correction of the running sums
  const float scale_log2 = __fmul_rn(scale, kLog2e);

  // O += P V of the key tile at stage s.
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t(&a)[4] = *reinterpret_cast<const uint32_t(*)[4]>(p + 4 * kk);
#pragma unroll
      for (int m = 0; m < L::kMain; ++m)
        wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(o + 32 * m), a, v_desc(s, m, kk), 1);
      if constexpr (L::kTail > 0)
        wgmma_rs<L::kTail>(*reinterpret_cast<float(*)[L::kTail / 2]>(o + 32 * L::kMain), a, v_tail_desc(s, kk), 1);
    }
  };
  // QK^T of the key tile at stage s into s_acc.
  auto issue_qk = [&](int qb, int s) {
#pragma unroll
    for (int kk = 0; kk < L::kStepsQK; ++kk) wgmma_ss<kBN>(s_acc, q_desc(qb, kk), k_desc(s, kk), kk > 0);
  };
  // Every register a product reads, settled before wgmma.fence: an
  // instruction that defines one between the fence and the products would
  // make the compiler serialize them.
  auto fence_operands = [&]() {
    fence_regs(s_acc);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
  };
  // Head widths 72, 96, 128 (64 below): scale, then bias, in fp32 (two
  // roundings); with kMasked, keys past Sk are -inf. Then the online
  // softmax: each row's max over its 4 lanes, the correction of the running
  // sums (returned in corr), and exp(s - m) in s_acc.
  auto softmax = [&](auto masked, const float* bias_row, int key_tile, float(&corr)[2]) {
    constexpr bool kMasked = decltype(masked)::value;
    const int key0 = key_tile * kBN + 2 * t4;
    if constexpr (L::kFfmaExp) {
      // Head width 64: t = s (the max of the raw logits, scale > 0) and
      // 2^(t k - m k), k = scale log2(e); with a bias, t = s k + bias
      // log2(e) (the producer scaled the row) and 2^(t - m), k = 1.
      const float k = kBias ? 1.0f : scale_log2;
      if constexpr (kBias || kMasked) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
          float2 kb = make_float2(0.0f, 0.0f);
          if constexpr (kBias) kb = *reinterpret_cast<const float2*>(bias_row + key0 + 8 * n);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s_acc[4 * n + e];
            if constexpr (kBias) x = __fmaf_rn(x, scale_log2, (e & 1) ? kb.y : kb.x);
            if constexpr (kMasked) x = key0 + 8 * n + (e & 1) < sk ? x : -INFINITY;
            s_acc[4 * n + e] = x;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s_acc[4 * n], s_acc[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s_acc[4 * n + 2], s_acc[4 * n + 3]));
      }
      float mk[2];  // m k, subtracted in the FFMA: 0 while a row has seen only -inf
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = m_run[r] == -INFINITY ? 0.0f : exp2_approx(__fmul_rn(__fsub_rn(m_run[r], m_new), k));
        m_run[r] = m_new;
        mk[r] = m_new == -INFINITY ? 0.0f : __fmul_rn(m_new, k);
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int r = (i >> 1) & 1;  // s_acc[i] lies in row g + 8 r
        const float e = exp2_approx(__fmaf_rn(s_acc[i], k, -mk[r]));
        l_run[r] += e;
        s_acc[i] = e;
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      float2 kb = make_float2(0.0f, 0.0f);
      if constexpr (kBias) kb = *reinterpret_cast<const float2*>(bias_row + key0 + 8 * n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s_acc[4 * n + e], scale);
        if constexpr (kBias) x = __fadd_rn(x, (e & 1) ? kb.y : kb.x);
        if constexpr (kMasked) x = key0 + 8 * n + (e & 1) < sk ? x : -INFINITY;
        s_acc[4 * n + e] = x;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s_acc[4 * n], s_acc[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s_acc[4 * n + 2], s_acc[4 * n + 3]));
    }
    float mu[2];  // the max subtracted: 0 while a row has seen only -inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = m_run[r] == -INFINITY ? 0.0f : exp2_approx(__fmul_rn(__fsub_rn(m_run[r], m_new), kLog2e));
      m_run[r] = m_new;
      mu[r] = m_new == -INFINITY ? 0.0f : m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;  // s_acc[i] lies in row g + 8 r
      const float e = exp2_approx(__fmul_rn(__fsub_rn(s_acc[i], mu[r]), kLog2e));
      l_run[r] += e;
      s_acc[i] = e;
    }
  };
  // P = bf16(exp(s - m)) from s_acc, as PV's A fragments.
  auto pack_p = [&](uint32_t(&dst)[kBN / 4]) {
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) dst[i] = pack_bf16(s_acc[2 * i], s_acc[2 * i + 1]);
  };

  int kv = 0;  // key tiles consumed so far, over all tiles; key tile kv sits at stage kv % kStages
  const int last_tile = tiles - 1 - (tiles - 1 - static_cast<int>(blockIdx.x)) % static_cast<int>(gridDim.x);
  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const int q0 = (tile % q_tiles) * kBM;
    const int head = (tile / q_tiles) % heads;
    const int batch = tile / q_tiles / heads;
    const int qb = n & 1;
    const bool last = tile == last_tile;
    const float* bias_row = bias_rows + qb * n_keys * kBN;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;
    mbar_wait(q_full(qb), (n >> 1) & 1);
    if constexpr (kBias) mbar_wait(b_full(qb), (n >> 1) & 1);

    // The key tiles in reverse order, so that the ragged last one comes
    // first and is the only one masked.
    {
      const int s = kv % kStages;
      mbar_wait(k_full(s), (kv / kStages) & 1);
      bar_sync(my_turn, kConsumers * 128);
      fence_operands();
      issue_qk(qb, s);
      wgmma_commit();
      bar_arrive_if(other_turn, kConsumers * 128, c == 0 || !last || n_keys > 1);
      wgmma_wait<0>();
      fence_regs(s_acc);
      mbar_arrive_if(k_empty(s), t == 0);
      softmax(std::true_type{}, bias_row, n_keys - 1, corr);
      pack_p(p);
      ++kv;
    }
    for (int i = 1; i < n_keys; ++i, ++kv) {
      const int s = kv % kStages;
      const int sp = (kv - 1) % kStages;  // the key tile before's stage
      mbar_wait(k_full(s), (kv / kStages) & 1);
      bar_sync(my_turn, kConsumers * 128);
      fence_operands();
      issue_qk(qb, s);
      wgmma_commit();
      mbar_wait(v_full(sp), ((kv - 1) / kStages) & 1);
      issue_pv(sp);
      wgmma_commit();
      bar_arrive_if(other_turn, kConsumers * 128, c == 0 || !last || i + 1 < n_keys);
      wgmma_wait<1>();
      fence_regs(s_acc);
      mbar_arrive_if(k_empty(s), t == 0);
      softmax(std::false_type{}, bias_row, n_keys - 1 - i, corr);
      uint32_t p_new[kBN / 4];
      if constexpr (!L::kOneP) pack_p(p_new);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);  // P of the key tile before stays in its registers until PV has read it
      mbar_arrive_if(v_empty(sp), t == 0);
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      if constexpr (L::kOneP) {
        pack_p(p);
      } else {
#pragma unroll
        for (int e = 0; e < kBN / 4; ++e) p[e] = p_new[e];
      }
    }
    {
      const int s = (kv - 1) % kStages;
      mbar_wait(v_full(s), ((kv - 1) / kStages) & 1);
      fence_operands();
      issue_pv(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive_if(v_empty(s), t == 0);
      mbar_arrive_if(q_empty(qb), !L::kOInQ && t == 0);
      mbar_arrive_if(b_empty(qb), kBias && t == 0);
    }

    // O / l in fp32, rounded once to bf16, into the warpgroup's output
    // tile (dense rows of HD) once the store before has read it, then one
    // TMA store of its 64 rows (rows past Sq are clipped).
    float l_sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l_run[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_sum[r] = sum;
    }
    const int o_off = L::kOInQ ? L::kQ + (2 * c + qb) * L::kQBytes : L::kO + c * L::kOBytes;
    if (!L::kOInQ && t == 0) tma_store_wait();
    fence_proxy_async();
    bar_sync(3 + c, 128);
    uint8_t* const os = sbase + o_off;
    const int row0 = 16 * (t / 32) + g;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * t4;
      *reinterpret_cast<uint32_t*>(os + ((row0 + 8 * r) * HD + col) * 2) =
          pack_bf16(__fdiv_rn(o[i], l_sum[r]), __fdiv_rn(o[i + 1], l_sum[r]));
    }
    fence_proxy_async();
    bar_sync(3 + c, 128);
    if (t == 0) {
      tma_store(&maps.out, base + o_off, 0, head, q0 + c * kRowsWG, batch);
      if constexpr (L::kOInQ) {
        tma_store_wait();
        mbar_arrive_if(q_empty(qb), true);
      }
    }
  }
  if (t == 0) tma_store_wait();
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A rank-4 bf16 map (hd, heads, rows, batch) of the tensor at ptr, strides
// in elements, cut into boxes of (cols, 1, box_rows, 1).
bool encode(CUtensorMap* map, const void* ptr, int hd, int heads, int rows, int batch, long long row_stride,
            long long batch_stride, int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

CUtensorMapSwizzle swizzle_of(int cols) {
  return cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
         : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
         : cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                      : CU_TENSOR_MAP_SWIZZLE_NONE;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out, int batch, int sq,
                   int sk, int heads, int q_sb, int q_sr, int k_sb, int k_sr, int v_sb, int v_sr, int bias_sb,
                   float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  const size_t smem = smem_bytes<HD>(sk);
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (encoder() == nullptr || smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  Maps maps;
  const int tail_qk = L::kTail ? L::kTailQK : 64;  // hd without a tail: the main box stands in
  const int tail_v = L::kTail ? L::kTail : 64;
  const bool ok =
      encode(&maps.q, q, HD, heads, sq, batch, q_sr, q_sb, 64, kRowsWG, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.q_tail, q, HD, heads, sq, batch, q_sr, q_sb, tail_qk, kRowsWG, swizzle_of(tail_qk)) &&
      encode(&maps.k, k, HD, heads, sk, batch, k_sr, k_sb, 64, kBN, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.k_tail, k, HD, heads, sk, batch, k_sr, k_sb, tail_qk, kBN, swizzle_of(tail_qk)) &&
      encode(&maps.v, v, HD, heads, sk, batch, v_sr, v_sb, 64, kBN, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode(&maps.v_tail, v, HD, heads, sk, batch, v_sr, v_sb, tail_v, kBN, swizzle_of(tail_v)) &&
      encode(&maps.out, out, HD, heads, sq, batch, static_cast<long long>(heads) * HD,
             static_cast<long long>(sq) * heads * HD, HD, kRowsWG, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  const auto kernel = bias ? attention_sm90_kernel<HD, true> : attention_sm90_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + kBM - 1) / kBM;
  const long long tiles = static_cast<long long>(q_tiles) * heads * batch;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (tiles >= (1ll << 31) || sms < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, smem, stream>>>(maps, static_cast<const float*>(bias), bias_sb, sk, q_tiles, heads,
                                           static_cast<int>(tiles), scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// attention.cu's tpuclip_attention, by this kernel: the same arguments and
// layouts, for hd 64, 72, 96 or 128 (any other is refused); every pointer
// and stride a multiple of 16 bytes.
int tpuclip_attention_sm90(const void* q, const void* k, const void* v, const void* bias, void* out, int batch,
                           int sq, int sk, int heads, int hd, int q_sb, int q_sr, int k_sb, int k_sr, int v_sb,
                           int v_sr, int bias_sb, float scale, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUCLIP_ATTENTION_SM90_LAUNCH(W)                                                                    \
  static_cast<int>(launch<W>(q, k, v, bias, out, batch, sq, sk, heads, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, \
                             bias_sb, scale, s))
  switch (hd) {
    case 64: return TPUCLIP_ATTENTION_SM90_LAUNCH(64);
    case 72: return TPUCLIP_ATTENTION_SM90_LAUNCH(72);
    case 96: return TPUCLIP_ATTENTION_SM90_LAUNCH(96);
    case 128: return TPUCLIP_ATTENTION_SM90_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUCLIP_ATTENTION_SM90_LAUNCH
}

}  // extern "C"
