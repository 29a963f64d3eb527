// One convolution of a HiFi-GAN MRF resblock, written by hand for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces: expressive_fastspeech2_mandarin_tpu/ops/pallas/mrf_resblock.py,
// resblock_fused (the Pallas TPU kernel that runs a whole resblock on chip).
// A resblock is, for each dilation d in (1, 3, 5):
//     x = cast(f32(conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))) + f32(x))
// with leaky-ReLU slope 0.1, 'same' zero padding for every conv, f32
// accumulation and bias, every conv output stored in the working type, and
// the residual sum taken in f32. The Python wrapper (ops/mrf_resblock.py)
// launches a kernel of this file six times per resblock: once per conv,
// with the input leaky-ReLU, the bias and (for the second conv of a pair)
// the residual add fused in, so no elementwise pass runs on its own.
//
// What bounds it. A conv does 2*K*C^2 flops per output element (C = 32..256,
// K = 3..11) and, launched on its own, moves its input and output through
// device memory (the second conv of a pair also reads the residual). At the
// generator's stages (B = 4 x 1000 mel frames) the flops of a stage take
// 0.27..1.07 ms at the bf16 tensor-core rate and its 15 activation passes per
// resblock 0.22..0.88 ms at 3.35 TB/s: C = 256 and 128 are bound by
// operations, C = 64 and 32 by bytes, and the six-launch design cannot go
// below the bytes (fusing a conv pair, or the whole chain, can; ROADMAP.md).
// In float32 (three TF32 products a product at the 495 TF/s TF32 rate) the
// operations take 14.41 ms for the 12 resblocks at B = 4 x 1000 (one
// product: 4.81 ms); the six launches' float32 activation passes take
// 0.15..0.59 ms a resblock, more than the operations only at C = 64, K = 3
// and C = 32, K <= 7.
//
// bfloat16: tensor cores (mrf_conv_tc_kernel). Each conv is an implicit GEMM
// with M = time rows, N = output channels, K = C_in x taps:
//   * a block owns 128 time rows (two consumer warpgroups of 64 rows) and
//     BN = 128, 64 or 32 output channels (blockIdx.y), and loops over C_in in
//     chunks of KC = 64 (32) channels and, inside a chunk, over the K taps;
//     each (chunk, tap) is KC/16 wgmma.mma_async m64nBNk16 per warpgroup,
//     bf16 in, f32 accumulators in registers (BN/2 per thread);
//   * the input rows [t0 - pad, t0 + 128 + pad) of a chunk (pad =
//     (K-1)/2*d, 25 at K = 11, d = 5) are staged once, leaky-ReLU'd in f32,
//     rounded to bf16, zero outside [0, T), in the unswizzled "core
//     matrix" layout that wgmma reads through a shared-memory descriptor:
//     [channel group of 8][row][8 channels], 16 bytes a row. A core
//     matrix is then any 8 consecutive rows, so tap j reads the same staged
//     tile through a descriptor that starts j*d rows further: no per-tap
//     copy and no register-sourced A,
//     although d = 3 and 5 shift by rows that are not multiples of 8 (a
//     128-byte swizzle would need 8-row-aligned starts). The row count of
//     the buffer is odd, so the 16-byte stores of one row's channel groups
//     hit distinct banks. The next chunk is staged into a second buffer
//     while the tensor cores run the current chunk's first tap;
//   * the weights are packed once per tensor by the wrapper
//     (ops/mrf_resblock.py:pack_mrf_weights) into the exact image the wgmma
//     B descriptor reads, one contiguous slab per (N tile, chunk, tap) in the
//     same core-matrix layout; a producer warp moves each slab with one
//     cp.async.bulk into a 4-stage ring guarded by mbarriers (full: bytes
//     arrived; empty: every consumer warp's wgmmas on it retired), so the next
//     slabs load while the current ones are multiplied;
//   * epilogue: bias added in f32, rounded to bf16, the residual added in
//     f32 and rounded again, rows >= T masked.
//
// float32: tensor cores at float32 accuracy (mrf_conv_f32_tc_kernel). The
// card's float32 run is held within 1e-4 of the CPU and of float64, which
// one TF32 product (10-bit mantissas) would not meet, so every product is
// three TF32 products of split operands (3xTF32, csrc/tf32_wgmma.cuh):
// x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi), and a*b becomes
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, about 2^-21 relative. It is the bf16
// kernel's implicit GEMM moved to TF32:
//   * a block owns 128 time rows (two consumer warpgroups of 64 rows) and
//     BN = 128, 64 or 32 output channels, and loops over C_in in chunks of
//     KC = 32 (or 16, for a wide halo) channels and, inside a chunk, over
//     the K taps; each (chunk, tap) is KC/8 k-steps of three
//     wgmma.mma_async m64nBNk8.f32.tf32.tf32 per warpgroup, both operands
//     K-major (TF32 wgmma takes no other);
//   * the input rows of a chunk are staged once, leaky-ReLU'd in f32, zero
//     outside [0, T), split, the two parts in two buffers of the same
//     unswizzled core-matrix layout [channel group of 4][row][4 float32]
//     (16 bytes a row, an odd row count). A core matrix is 8 rows x 16
//     bytes = 8 rows x 4 channels, so a k8 step spans two core matrices
//     along K: the descriptor's leading byte offset (LBO, the next core
//     matrix along K) is one channel group, a_stride * 16 bytes, its
//     stride byte offset (SBO, the next 8 rows) 128 bytes, and k-step ks
//     starts 2 * ks groups further. Tap j reads the same tile j*d rows
//     further, as the bf16 kernel does. The next chunk is staged into a
//     second pair of buffers while the tensor cores run the current one,
//     a round of two float4 a thread at each tap: the round's loads are
//     issued after one tap's wgmmas and stored after the next tap's, so
//     their latency passes under the tensor cores' work (staging a whole
//     chunk at its first tap, as the bf16 kernel does, left the tensor
//     cores idle for the loads: chip_smoke.py phase 4's 12 resblocks took
//     30.4 ms that way against 25.9 on an H100 at 700 W);
//   * the weights are packed and split once per tensor by the wrapper
//     (ops/mrf_resblock.py:pack_mrf_weights_tf32), per (N tile, tap) a hi
//     and a lo image [channel group of 4][BN][4] (LBO BN * 16 bytes, SBO
//     128), so any chunk's slab is contiguous; the producer warp moves each
//     (hi, lo) slab pair with two cp.async.bulk into a ring of 4 to 2
//     stages (full/empty mbarriers, as the bf16 kernel);
//   * per k-step lo*hi, hi*lo, then hi*hi, the small products first. The
//     tensor cores add into an accumulator rounding toward zero, an error
//     that grows with the chain, so a chain (from acc = 0) holds at most
//     44 k-steps, 132 wgmma: a chunk's taps at K <= 11 and KC = 32 (every
//     conv of the generator), else 11 taps (KC = 32) or 22 (KC = 16) and
//     the rest in further chains. The chains are summed in software into
//     a float32 total: the sum's order is fixed, so a rerun is
//     bit-identical;
//   * epilogue: bias and the residual added in f32, float32 stores, rows
//     >= T masked.
// Registers: a block of 288 threads is given registers as three full
// warpgroups, 168 a thread at most (ptxas's cap; with __maxnreg__(224) the
// launch fails for want of registers). At BN = 128 the two accumulators
// take 128 of them, so a staging round holds two float4, not four (four
// spill).
// Shared memory: the ring, 2 * BN * KC * 4 bytes a stage, and the staged
// input, 2 buffers x 2 parts x KC/4 x a_stride x 16 bytes (a_stride =
// (128 + (K-1)*d) | 1). f32_plan takes KC = 32 with the deepest ring of 4,
// 3 or 2 stages that fits in the 232,448 bytes a block may use, else KC =
// 16 likewise (at K = 11, d = 5, BN = 128: KC 32, 4 stages, 222,848 bytes;
// K = 17: 3 stages; K = 45: KC 16, 4 stages, 155,008 bytes).
//
// Kernel sizes: both kernels are instantiated for K = 3, 7 and 11 with the
// tap count a template constant, and once more with K read at run time
// (template K = 0) for any other odd K (and for every float32 conv at
// KC = 16); the wrapper zero-pads an odd K < 11 to the next templated size.
// The weight ring holds one (chunk, tap) slab a stage whatever K is; the
// staged input tile grows with the halo, (K-1)*d rows, and a launch that
// would pass the shared memory a block may use is refused
// (cudaErrorInvalidValue): the float32 kernel takes (K-1)*d up to 650 at
// BN = 128, 714 at BN = 64 and 746 at BN = 32 (at d = 5, K up to 131, 143
// and 149), the bf16 kernel K up to 105 at d = 5 (BN = 128).
//
// Layouts: activations (B, T, C) contiguous, channels last; weights packed
// by the wrapper (pack_mrf_weights for bfloat16, pack_mrf_weights_tf32 for
// float32); bias (C) in the working type. Offsets into the
// activations are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "sm90.cuh"
#include "tf32_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 128;                    // time rows per block
constexpr int kTcConsumers = 256;               // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;   // and one producer warp
constexpr int kStages = 4;                      // weight-slab ring
constexpr int kBarrierBytes = 128;              // 2 * kStages mbarriers, padded

__device__ __forceinline__ void consumers_sync() {
  named_sync<1, kTcConsumers>();
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes stored as 128 contiguous bytes; lbo = bytes between the two core
// matrices of a 16-deep k step, sbo = bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D(64 x N, f32 registers) += A(64 x 16, descriptor) * B(16 x N, descriptor),
// both K-major, bf16.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[BN / 2], uint64_t a,
                                             uint64_t b) {
  if constexpr (BN == 128) wgmma_m64n128k16(d, a, b);
  else if constexpr (BN == 64) wgmma_m64n64k16(d, a, b);
  else wgmma_m64n32k16(d, a, b);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// leaky-ReLU of two bf16 values, in f32, rounded back to bf16.
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  float2 f = __bfloat1622float2(h);
  f.x = f.x >= 0.f ? f.x : f.x * kSlope;
  f.y = f.y >= 0.f ? f.y : f.y * kSlope;
  h = __floats2bfloat162_rn(f.x, f.y);
  memcpy(&v, &h, 4);
  return v;
}

// Stage input rows [t_first, t_first + rows) x channels [ci0, ci0 + KC) of
// one batch row into dst as [KC/8][a_stride][8] bf16, leaky-ReLU'd, zero
// outside [0, T). Consecutive threads take consecutive 16-byte channel
// groups of a row (coalesced loads); a_stride is odd, so the 8 stores of a
// row fall in distinct banks.
template <int KC>
__device__ __forceinline__ void stage_input(const bf16* __restrict__ x,
                                            uint8_t* dst, int a_stride,
                                            int t_first, int rows, int t_len,
                                            int channels, int ci0) {
  constexpr int kCg = KC / 8;
  for (int v = threadIdx.x; v < rows * kCg; v += kTcConsumers) {
    const int r = v / kCg;
    const int cg = v % kCg;
    const int t = t_first + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len) {
      val = *reinterpret_cast<const uint4*>(x + (int64_t)t * channels + ci0 +
                                            cg * 8);
      val.x = lrelu_bf16x2(val.x);
      val.y = lrelu_bf16x2(val.y);
      val.z = lrelu_bf16x2(val.z);
      val.w = lrelu_bf16x2(val.w);
    }
    *reinterpret_cast<uint4*>(dst + ((size_t)cg * a_stride + r) * 16) = val;
  }
}

// K > 0: the tap count as a template constant; K == 0: the tap count is
// kernel_size, read at run time, for an odd K past the templated sizes.
template <int K, int BN, int KC>
__global__ void __launch_bounds__(kTcThreads)
mrf_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                   const bf16* __restrict__ bias, const bf16* __restrict__ res,
                   bf16* __restrict__ out, int t_len, int channels,
                   int kernel_size, int dilation, int a_stride) {
  const int taps = K > 0 ? K : kernel_size;
  constexpr int kSlabElems = BN * KC;
  constexpr uint32_t kSlabBytes = kSlabElems * 2;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tc_smem);
  uint64_t* empty = full + kStages;
  uint8_t* ring = tc_smem + kBarrierBytes;
  uint8_t* abuf = ring + kStages * kSlabBytes;
  const uint32_t a_bytes = (KC / 8) * a_stride * 16;

  const int pad = (taps - 1) / 2 * dilation;
  const int rows = kTcRows + 2 * pad;
  const int t0 = blockIdx.x * kTcRows;
  const int n_chunks = channels / KC;
  const int n_slabs = n_chunks * taps;
  const int64_t batch_off = (int64_t)blockIdx.z * t_len * channels;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kTcConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // Producer: one thread streams this N tile's slabs, (chunk, tap) in
    // the consumers' order, through the ring.
    if (tid == kTcConsumers) {
      const bf16* src = wp + (int64_t)blockIdx.y * n_slabs * kSlabElems;
      for (int i = 0; i < n_slabs; ++i) {
        const int s = i % kStages;
        mbar_wait(smem_addr(&empty[s]), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(smem_addr(&full[s]), kSlabBytes);
        bulk_copy(smem_addr(ring + s * kSlabBytes),
                  src + (int64_t)i * kSlabElems, kSlabBytes,
                  smem_addr(&full[s]));
      }
    }
    return;
  }

  const int wg = tid / 128;
  const bool leader = tid % 32 == 0;  // each warp frees a slab once its
                                      // own wgmmas on it have retired
  const bf16* xb = x + batch_off;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  stage_input<KC>(xb, abuf, a_stride, t0 - pad, rows, t_len, channels, 0);
  fence_proxy_async();
  consumers_sync();

  int i = 0;  // slab index: chunk * taps + tap
#pragma unroll 1
  for (int kc = 0; kc < n_chunks; ++kc) {
    // This warpgroup's 64 output rows start at staged row wg*64; tap j
    // reads staged rows shifted by j*d.
    const uint32_t a_base =
        smem_addr(abuf + (kc & 1) * a_bytes) + wg * 64 * 16;
#pragma unroll 1
    for (int j = 0; j < taps; ++j, ++i) {
      const int s = i % kStages;
      mbar_wait(smem_addr(&full[s]), (i / kStages) & 1);
      const uint32_t a_tap = a_base + j * dilation * 16;
      const uint32_t b_slab = smem_addr(ring + s * kSlabBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        wgmma_m64k16<BN>(acc, smem_desc(a_tap + 2 * ks * a_stride * 16,
                                        a_stride * 16, 128),
                         smem_desc(b_slab + 2 * ks * BN * 16, BN * 16, 128));
      }
      wgmma_commit();
      if (j > 0) {
        // The previous tap's wgmmas have retired: free its slab.
        wgmma_wait<1>();
        if (leader) mbar_arrive(smem_addr(&empty[(i - 1) % kStages]));
      } else if (kc + 1 < n_chunks) {
        // Stage the next chunk while the tensor cores run this tap. Its
        // buffer was last read by chunk kc-1, retired in both warpgroups
        // before the barrier that closed that chunk.
        stage_input<KC>(xb, abuf + ((kc + 1) & 1) * a_bytes, a_stride,
                        t0 - pad, rows, t_len, channels, (kc + 1) * KC);
      }
    }
    wgmma_wait<0>();
    if (leader) mbar_arrive(smem_addr(&empty[(i - 1) % kStages]));
    fence_proxy_async();
    consumers_sync();
  }

  // Epilogue. Accumulator layout of m64nN: warp w of the warpgroup holds
  // rows 16w + g and 16w + g + 8 (g = lane / 4), columns 8n + 2q, +1
  // (q = lane % 4) in acc[4n], acc[4n+1] and acc[4n+2], acc[4n+3].
  const int lane = tid % 32;
  const int row0 = t0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = blockIdx.y * BN + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = col0 + 8 * n;
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = row0 + 8 * h;
      if (t >= t_len) continue;
      const int64_t off = batch_off + (int64_t)t * channels + col;
      // The conv output is stored in bf16; the residual sum is taken in
      // f32 from that stored value and rounded once more.
      float y0 = round_bf16(acc[4 * n + 2 * h] + b.x);
      float y1 = round_bf16(acc[4 * n + 2 * h + 1] + b.y);
      if (res != nullptr) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + off));
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int K, int BN, int KC>
cudaError_t launch_tc(const bf16* x, const bf16* wp, const bf16* bias,
                      const bf16* res, bf16* out, int batch, int t_len,
                      int channels, int kernel_size, int dilation,
                      cudaStream_t stream) {
  // The weight ring holds one slab a stage whatever K is; the staged input
  // tile grows with the halo, (K - 1) * d rows.
  const int pad = (kernel_size - 1) / 2 * dilation;
  const int a_stride = (kTcRows + 2 * pad) | 1;
  const size_t smem = kBarrierBytes + (size_t)kStages * BN * KC * 2 +
                      2 * (size_t)(KC / 8) * a_stride * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_conv_tc_kernel<K, BN, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kTcRows - 1) / kTcRows, channels / BN, batch);
  mrf_conv_tc_kernel<K, BN, KC><<<grid, kTcThreads, smem, stream>>>(
      x, wp, bias, res, out, t_len, channels, kernel_size, dilation, a_stride);
  return cudaGetLastError();
}

template <int BN, int KC>
cudaError_t dispatch_tc(const bf16* x, const bf16* wp, const bf16* bias,
                        const bf16* res, bf16* out, int batch, int t_len,
                        int channels, int kernel_size, int dilation,
                        cudaStream_t s) {
  switch (kernel_size) {
    case 3: return launch_tc<3, BN, KC>(x, wp, bias, res, out, batch, t_len, channels, 3, dilation, s);
    case 7: return launch_tc<7, BN, KC>(x, wp, bias, res, out, batch, t_len, channels, 7, dilation, s);
    case 11: return launch_tc<11, BN, KC>(x, wp, bias, res, out, batch, t_len, channels, 11, dilation, s);
    default: return launch_tc<0, BN, KC>(x, wp, bias, res, out, batch, t_len, channels, kernel_size, dilation, s);
  }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores at float32 accuracy (3xTF32).

constexpr int kF32WideKC = 32;    // input channels a chunk, if they fit
constexpr int kF32NarrowKC = 16;  // else (a wide halo)
constexpr int kF32MaxStages = 4;  // weight ring: the deepest that fits,
constexpr int kF32MinStages = 2;  // down to this
// k-steps of 8 channels a wgmma chain at most (3 wgmma each): a chunk of
// KC = 32 at K <= 11 is one chain; longer chunks close a chain every
// kF32ChainSteps / (KC / 8) taps, so a chain's error does not grow with K.
constexpr int kF32ChainSteps = 44;

// Shared memory of the float32 kernel for BN output channels, KC input
// channels a chunk, `stages` ring stages and a staged tile of a_stride rows:
// the barriers, the ring of (hi, lo) slab pairs and two buffers of the
// input's two parts.
constexpr size_t f32_smem(int bn, int kc, int stages, int64_t a_stride) {
  return kBarrierBytes + (size_t)stages * 2 * bn * kc * 4 +
         2 * 2 * (size_t)(kc / 4) * a_stride * 16;
}

struct F32Plan {
  int kc, stages, a_stride;
  size_t smem;
};

// KC = 32 with the deepest ring that fits, else KC = 16 likewise; false if
// nothing fits (tests/test_torch_mrf_f32_tc.py models this from the
// constants above).
bool f32_plan(int bn, int kernel_size, int dilation, F32Plan* plan) {
  const int64_t a_stride =
      (kTcRows + 2 * ((int64_t)(kernel_size - 1) / 2 * dilation)) | 1;
  const int chunks[2] = {kF32WideKC, kF32NarrowKC};
  for (int kc : chunks)
    for (int stages = kF32MaxStages; stages >= kF32MinStages; --stages) {
      const size_t smem = f32_smem(bn, kc, stages, a_stride);
      if (smem <= kMaxSmem) {
        *plan = {kc, stages, (int)a_stride, smem};
        return true;
      }
    }
  return false;
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int acc) {
  if constexpr (BN == 128) tf32x3::wgmma_m64n128k8(d, a, b, acc);
  else if constexpr (BN == 64) tf32x3::wgmma_m64n64k8(d, a, b, acc);
  else tf32x3::wgmma_m64n32k8(d, a, b, acc);
}

// The staged input of a chunk, input rows [t_first, t_first + rows) x
// channels [ci0, ci0 + KC) of one batch row, leaky-ReLU'd in f32, zero
// outside [0, T), split into TF32 parts, goes into hi and lo as
// [KC/4][a_stride][4] float32, in rounds: in round n consumer thread i
// takes the 16-byte channel groups v = i + 256 * (kRoundVecs * n + u),
// u < kRoundVecs, of row v / (KC/4). Consecutive threads take consecutive
// groups of a row (coalesced loads); at KC = 32 the 8 stores of a row fall
// in distinct banks (a_stride is odd). A round's loads go into registers
// and its stores follow later, so that the loads' latency passes while
// the tensor cores run a tap.
constexpr int kRoundVecs = 2;

__device__ __forceinline__ int stage_rounds(int rows, int kc) {
  const int per_round = kTcConsumers * kRoundVecs;
  return (rows * (kc / 4) + per_round - 1) / per_round;
}

template <int KC>
__device__ __forceinline__ void stage_load(float4 (&held)[kRoundVecs],
                                           const float* __restrict__ x,
                                           int round, int t_first, int rows,
                                           int t_len, int channels,
                                           int ci0) {
  constexpr int kCg = KC / 4;
#pragma unroll
  for (int u = 0; u < kRoundVecs; ++u) {
    const int v = threadIdx.x + kTcConsumers * (kRoundVecs * round + u);
    const int r = v / kCg;
    const int t = t_first + r;
    held[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && t >= 0 && t < t_len)
      held[u] = *reinterpret_cast<const float4*>(
          x + (int64_t)t * channels + ci0 + v % kCg * 4);
  }
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * kSlope;
}

template <int KC>
__device__ __forceinline__ void stage_store(const float4 (&held)[kRoundVecs],
                                            uint8_t* hi, uint8_t* lo,
                                            int a_stride, int round,
                                            int rows) {
  constexpr int kCg = KC / 4;
#pragma unroll
  for (int u = 0; u < kRoundVecs; ++u) {
    const int v = threadIdx.x + kTcConsumers * (kRoundVecs * round + u);
    const int r = v / kCg;
    if (r >= rows) continue;
    const float4 h = held[u];
    const size_t off = ((size_t)(v % kCg) * a_stride + r) * 16;
    tf32x3::store_split4(hi + off, lo + off,
                         make_float4(lrelu(h.x), lrelu(h.y), lrelu(h.z),
                                     lrelu(h.w)));
  }
}

// K as in mrf_conv_tc_kernel. wp is pack_mrf_weights_tf32's image:
// (C/BN, taps, 2, C/4, BN, 4) float32.
template <int K, int BN, int KC>
__global__ void __launch_bounds__(kTcThreads)
mrf_conv_f32_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ wp,
                       const float* __restrict__ bias,
                       const float* __restrict__ res, float* __restrict__ out,
                       int t_len, int channels, int kernel_size, int dilation,
                       int a_stride, int stages) {
  const int taps = K > 0 ? K : kernel_size;
  constexpr int kChainTaps = kF32ChainSteps / (KC / 8);
  constexpr uint32_t kSlabBytes = BN * KC * 4;  // one part of a slab
  extern __shared__ __align__(128) uint8_t f32_smem_buf[];
  uint64_t* full = reinterpret_cast<uint64_t*>(f32_smem_buf);
  uint64_t* empty = full + kF32MaxStages;
  uint8_t* ring = f32_smem_buf + kBarrierBytes;
  uint8_t* abuf = ring + stages * 2 * kSlabBytes;
  const uint32_t a_part = (KC / 4) * a_stride * 16;  // one part, one buffer

  const int pad = (taps - 1) / 2 * dilation;
  const int rows = kTcRows + 2 * pad;
  const int t0 = blockIdx.x * kTcRows;
  const int n_chunks = channels / KC;
  const int64_t batch_off = (int64_t)blockIdx.z * t_len * channels;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kTcConsumers / 32);  // one per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // Producer: one thread streams this N tile's (hi, lo) slab pairs,
    // (chunk, tap) in the consumers' order, through the ring. Part p of
    // tap j's chunk kc starts at ((nt * taps + j) * 2 + p) * C * BN +
    // kc * KC * BN floats.
    if (tid == kTcConsumers) {
      const float* tile = wp + (int64_t)blockIdx.y * taps * 2 * channels * BN;
      int s = 0;
      uint32_t phase = 0;
      for (int kc = 0; kc < n_chunks; ++kc)
        for (int j = 0; j < taps; ++j) {
          mbar_wait(smem_addr(&empty[s]), phase ^ 1);
          mbar_expect_tx(smem_addr(&full[s]), 2 * kSlabBytes);
          const float* src =
              tile + (int64_t)j * 2 * channels * BN + (int64_t)kc * KC * BN;
          const uint32_t dst = smem_addr(ring + s * 2 * kSlabBytes);
          bulk_copy(dst, src, kSlabBytes, smem_addr(&full[s]));
          bulk_copy(dst + kSlabBytes, src + (int64_t)channels * BN,
                    kSlabBytes, smem_addr(&full[s]));
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  const int wg = tid / 128;
  const bool leader = tid % 32 == 0;  // each warp frees a slab once its
                                      // own wgmmas on it have retired
  const float* xb = x + batch_off;
  // The running total (software sums, round to nearest) and a chunk's wgmma
  // chain. Each chain's first wgmma ignores `part` (acc = 0); both are
  // defined here so that no code reads an indeterminate value.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  const int n_rounds = stage_rounds(rows, KC);
  float4 held[kRoundVecs];  // a staging round between its loads and stores
  for (int n = 0; n < n_rounds; ++n) {
    stage_load<KC>(held, xb, n, t0 - pad, rows, t_len, channels, 0);
    stage_store<KC>(held, abuf, abuf + a_part, a_stride, n, rows);
  }
  fence_proxy_async();
  consumers_sync();

  int s = 0, prev = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int kc = 0; kc < n_chunks; ++kc) {
    // This warpgroup's 64 output rows start at staged row wg*64; tap j
    // reads staged rows shifted by j*d. Buffer b holds its hi part, then
    // its lo part.
    const uint32_t a_hi =
        smem_addr(abuf + (kc & 1) * 2 * a_part) + wg * 64 * 16;
    const uint32_t a_lo = a_hi + a_part;
    // Taps [j0, j1) make one chain.
    for (int j0 = 0; j0 < taps; j0 += kChainTaps) {
      const int j1 = min(j0 + kChainTaps, taps);
      fence_operands(part);
#pragma unroll 1
      for (int j = j0; j < j1; ++j) {
        mbar_wait(smem_addr(&full[s]), phase);
        const uint32_t a_tap = j * dilation * 16;
        const uint32_t b_hi = smem_addr(ring + s * 2 * kSlabBytes);
        const uint32_t b_lo = b_hi + kSlabBytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          // k-step ks: channel groups 2ks and 2ks + 1 (LBO one group apart).
          const uint32_t ka = a_tap + 2 * ks * a_stride * 16;
          const uint32_t kb = 2 * ks * BN * 16;
          const uint64_t ahi = smem_desc(a_hi + ka, a_stride * 16, 128);
          const uint64_t bhi = smem_desc(b_hi + kb, BN * 16, 128);
          wgmma_tf32<BN>(part, smem_desc(a_lo + ka, a_stride * 16, 128), bhi,
                         (j > j0 || ks != 0));
          wgmma_tf32<BN>(part, ahi, smem_desc(b_lo + kb, BN * 16, 128), 1);
          wgmma_tf32<BN>(part, ahi, bhi, 1);
        }
        wgmma_commit();
        if (j > j0) {
          // The previous tap's wgmmas have retired: free its slab pair.
          wgmma_wait<1>();
          if (leader) mbar_arrive(smem_addr(&empty[prev]));
        }
        if (kc + 1 < n_chunks) {
          // Stage the next chunk a round a tap while the tensor cores run
          // this one: the stores of the round loaded at the previous tap,
          // then the loads of round j; at the last tap every round left.
          // Its buffers were last read by chunk kc-1, retired in both
          // warpgroups before the barrier that closed that chunk.
          uint8_t* next = abuf + ((kc + 1) & 1) * 2 * a_part;
          const int ci = (kc + 1) * KC;
          if (j > 0 && j <= n_rounds)
            stage_store<KC>(held, next, next + a_part, a_stride, j - 1, rows);
          const int last = j + 1 < taps ? min(j + 1, n_rounds) : n_rounds;
          for (int n = j; n < last; ++n) {
            stage_load<KC>(held, xb, n, t0 - pad, rows, t_len, channels, ci);
            if (j + 1 == taps)
              stage_store<KC>(held, next, next + a_part, a_stride, n, rows);
          }
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(part);
      if (leader) mbar_arrive(smem_addr(&empty[prev]));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    fence_proxy_async();
    consumers_sync();
  }

  // Epilogue, in the accumulator layout of m64nN (tf32_wgmma.cuh): bias
  // and residual added in f32, float32 stores.
  const int lane = tid % 32;
  const int row0 = t0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = blockIdx.y * BN + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = col0 + 8 * n;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = row0 + 8 * h;
      if (t >= t_len) continue;
      const int64_t off = batch_off + (int64_t)t * channels + col;
      float2 y = make_float2(acc[4 * n + 2 * h] + b.x,
                             acc[4 * n + 2 * h + 1] + b.y);
      if (res != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(res + off);
        y.x += r.x;
        y.y += r.y;
      }
      *reinterpret_cast<float2*>(out + off) = y;
    }
  }
}

template <int K, int BN, int KC>
cudaError_t launch_f32(const float* x, const float* wp, const float* bias,
                       const float* res, float* out, int batch, int t_len,
                       int channels, int kernel_size, int dilation,
                       const F32Plan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mrf_conv_f32_tc_kernel<K, BN, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kTcRows - 1) / kTcRows, channels / BN, batch);
  mrf_conv_f32_tc_kernel<K, BN, KC><<<grid, kTcThreads, plan.smem, stream>>>(
      x, wp, bias, res, out, t_len, channels, kernel_size, dilation,
      plan.a_stride, plan.stages);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch_f32(const float* x, const float* wp, const float* bias,
                         const float* res, float* out, int batch, int t_len,
                         int channels, int kernel_size, int dilation,
                         cudaStream_t s) {
  F32Plan p;
  if (!f32_plan(BN, kernel_size, dilation, &p)) return cudaErrorInvalidValue;
  if (p.kc == kF32NarrowKC)
    return launch_f32<0, BN, kF32NarrowKC>(x, wp, bias, res, out, batch, t_len, channels, kernel_size, dilation, p, s);
  switch (kernel_size) {
    case 3: return launch_f32<3, BN, kF32WideKC>(x, wp, bias, res, out, batch, t_len, channels, 3, dilation, p, s);
    case 7: return launch_f32<7, BN, kF32WideKC>(x, wp, bias, res, out, batch, t_len, channels, 7, dilation, p, s);
    case 11: return launch_f32<11, BN, kF32WideKC>(x, wp, bias, res, out, batch, t_len, channels, 11, dilation, p, s);
    default: return launch_f32<0, BN, kF32WideKC>(x, wp, bias, res, out, batch, t_len, channels, kernel_size, dilation, p, s);
  }
}

bool valid(int batch, int t_len, int channels, int kernel_size,
           int dilation) {
  return batch > 0 && t_len > 0 && channels > 0 && channels % 32 == 0 &&
         kernel_size > 0 && kernel_size % 2 == 1 && dilation > 0;
}

}  // namespace

// out = [res +] conv_{K,dilation}(lrelu(x)) + bias in float32 on the tensor
// cores at float32 accuracy; res may be null; w is pack_mrf_weights_tf32's
// image for BN = 128, 64 or 32 output channels as C allows. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int mrf_conv_f32(const void* x, const void* w, const void* bias,
                            const void* res, void* out, int batch, int t_len,
                            int channels, int kernel_size, int dilation,
                            void* stream) {
  if (!valid(batch, t_len, channels, kernel_size, dilation))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  const float* rp = static_cast<const float*>(res);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 128 == 0)
    return (int)dispatch_f32<128>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
  if (channels % 64 == 0)
    return (int)dispatch_f32<64>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
  return (int)dispatch_f32<32>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
}

// The same in bfloat16 on the tensor cores, each conv output rounded to
// bf16 (and the residual sum once more). w is packed by pack_mrf_weights for
// the tile of C: BN = 128, 64 or 32 output channels as C allows, KC = 64
// input channels per chunk if C % 64 == 0, else 32.
extern "C" int mrf_conv_bf16(const void* x, const void* w, const void* bias,
                             const void* res, void* out, int batch, int t_len,
                             int channels, int kernel_size, int dilation,
                             void* stream) {
  if (!valid(batch, t_len, channels, kernel_size, dilation))
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* bp = static_cast<const bf16*>(bias);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 128 == 0)
    return (int)dispatch_tc<128, 64>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
  if (channels % 64 == 0)
    return (int)dispatch_tc<64, 64>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
  return (int)dispatch_tc<32, 32>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s);
}
