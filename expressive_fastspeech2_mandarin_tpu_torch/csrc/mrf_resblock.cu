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
//   * epilogue as the float32 kernel: bias added in f32, rounded to bf16, the
//     residual added in f32 and rounded again, rows >= T masked.
//
// float32: CUDA cores (mrf_conv_f32_kernel). The exact path: the card's
// float32 run is held within 1e-4 of the CPU and of float64, which TF32
// tensor cores (10-bit mantissa products) would not meet. A block owns a tile
// of kNty*kRows time rows x TCO output channels and each thread an 8 x 8
// register tile; the halo'd input (already leaky-ReLU'd, zero outside
// [0, T)) and the weights are staged through shared memory kCi channels at
// a time.
//
// Kernel sizes: both kernels are instantiated for K = 3, 7 and 11 with the
// tap count a template constant, and once more with K read at run time
// (template K = 0) for any other odd K; the wrapper zero-pads an odd K < 11
// to the next templated size. The weight ring holds one (chunk, tap) slab a
// stage whatever K is; the staged input tile grows with the halo, (K-1)*d
// rows, and a launch whose shared memory would pass the 232,448 bytes a
// block may use is refused (cudaErrorInvalidValue): at d = 5 that is K > 45
// on the CUDA cores (64 output channels a block) and K > 105 on the tensor
// cores (BN = 128).
//
// Layouts: activations (B, T, C) contiguous, channels last; float32 weights
// as torch.nn.Conv1d keeps them, (C_out, C_in, K); bfloat16 weights packed
// (see pack_mrf_weights); bias (C) in the working type. Offsets into the
// activations are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use

// ---------------------------------------------------------------------------
// float32 on the CUDA cores.

constexpr int kThreads = 256;          // threads per block
constexpr int kCi = 16;                // input channels staged per step
constexpr int kRows = 8;               // output rows per thread
constexpr int kCols = 8;               // output channels per thread
constexpr int kXsStride = kCi + 1;     // padded staged-input row (no bank conflicts)

template <int TCO>
struct Tile {
  static constexpr int kNtx = TCO / kCols;             // threads across channels
  static constexpr int kNty = kThreads / kNtx;         // threads across time
  static constexpr int kTimeRows = kNty * kRows;       // output rows per block
  static constexpr int kWsStride = TCO + 4;            // padded staged-weight row
};

// K > 0: the tap count as a template constant (the taps unrolled); K == 0:
// the tap count is kernel_size, read at run time, for an odd K past the
// templated sizes.
template <int K, int TCO>
__global__ void __launch_bounds__(kThreads)
mrf_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ out,
                    int t_len, int channels, int kernel_size, int dilation) {
  using TL = Tile<TCO>;
  const int taps = K > 0 ? K : kernel_size;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                 // [kCi*taps][kWsStride]
  float* xs = smem + kCi * taps * TL::kWsStride;    // [rows][kXsStride]

  const int pad = (taps - 1) / 2 * dilation;
  const int rows = TL::kTimeRows + 2 * pad;
  const int tx = threadIdx.x % TL::kNtx;
  const int ty = threadIdx.x / TL::kNtx;
  const int t0 = blockIdx.x * TL::kTimeRows;
  const int co0 = blockIdx.y * TCO;
  const int64_t batch_off = (int64_t)blockIdx.z * t_len * channels;

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int ci0 = 0; ci0 < channels; ci0 += kCi) {
    // Weights: for each output channel the kCi*K values of this chunk are
    // contiguous in (C_out, C_in, K), so consecutive threads read
    // consecutive addresses.
    for (int i = threadIdx.x; i < TCO * kCi * taps; i += kThreads) {
      const int co = i / (kCi * taps);
      const int q = i - co * (kCi * taps);  // ci * taps + tap
      ws[q * TL::kWsStride + co] =
          w[((int64_t)(co0 + co) * channels + ci0) * taps + q];
    }
    // Input rows [t0 - pad, t0 + kTimeRows + pad), leaky-ReLU'd, zero
    // outside [0, T).
    for (int i = threadIdx.x; i < rows * kCi; i += kThreads) {
      const int r = i / kCi;
      const int ci = i - r * kCi;
      const int t = t0 - pad + r;
      float v = 0.f;
      if (t >= 0 && t < t_len) {
        v = x[batch_off + (int64_t)t * channels + ci0 + ci];
        v = v >= 0.f ? v : v * kSlope;
      }
      xs[r * kXsStride + ci] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
      for (int k = 0; k < taps; ++k) {
        const float* wrow = ws + (ci * taps + k) * TL::kWsStride + tx * kCols;
        const float4 wa = *reinterpret_cast<const float4*>(wrow);
        const float4 wb = *reinterpret_cast<const float4*>(wrow + 4);
        // Output row ty + r*kNty reads input row t - pad + k*d, which is
        // staged row ty + r*kNty + k*d.
        const float* xcol = xs + (ty + k * dilation) * kXsStride + ci;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xcol[r * TL::kNty * kXsStride];
          acc[r][0] = fmaf(xv, wa.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wa.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wa.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wa.w, acc[r][3]);
          acc[r][4] = fmaf(xv, wb.x, acc[r][4]);
          acc[r][5] = fmaf(xv, wb.y, acc[r][5]);
          acc[r][6] = fmaf(xv, wb.z, acc[r][6]);
          acc[r][7] = fmaf(xv, wb.w, acc[r][7]);
        }
      }
    }
    __syncthreads();
  }

  float b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) b[c] = bias[co0 + tx * kCols + c];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + ty + r * TL::kNty;
    if (t >= t_len) break;
    const int64_t off = batch_off + (int64_t)t * channels + co0 + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float y = acc[r][c] + b[c];
      if (res != nullptr) y += res[off + c];
      out[off + c] = y;
    }
  }
}

template <int K, int TCO>
cudaError_t launch_f32(const float* x, const float* w, const float* bias,
                       const float* res, float* out, int batch, int t_len,
                       int channels, int kernel_size, int dilation,
                       cudaStream_t stream) {
  using TL = Tile<TCO>;
  const int pad = (kernel_size - 1) / 2 * dilation;
  const size_t smem =
      sizeof(float) * ((size_t)kCi * kernel_size * TL::kWsStride +
                       (size_t)(TL::kTimeRows + 2 * pad) * kXsStride);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // Above 48 KB a block may use dynamic shared memory only after this call;
  // without it the launch is refused.
  cudaError_t err = cudaFuncSetAttribute(
      mrf_conv_f32_kernel<K, TCO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TL::kTimeRows - 1) / TL::kTimeRows,
                  channels / TCO, batch);
  mrf_conv_f32_kernel<K, TCO><<<grid, kThreads, smem, stream>>>(
      x, w, bias, res, out, t_len, channels, kernel_size, dilation);
  return cudaGetLastError();
}

template <int TCO>
cudaError_t dispatch_f32(const float* x, const float* w, const float* bias,
                         const float* res, float* out, int batch, int t_len,
                         int channels, int kernel_size, int dilation,
                         cudaStream_t s) {
  switch (kernel_size) {
    case 3: return launch_f32<3, TCO>(x, w, bias, res, out, batch, t_len, channels, 3, dilation, s);
    case 7: return launch_f32<7, TCO>(x, w, bias, res, out, batch, t_len, channels, 7, dilation, s);
    case 11: return launch_f32<11, TCO>(x, w, bias, res, out, batch, t_len, channels, 11, dilation, s);
    default: return launch_f32<0, TCO>(x, w, bias, res, out, batch, t_len, channels, kernel_size, dilation, s);
  }
}

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

// K as in mrf_conv_f32_kernel: 0 reads the tap count from kernel_size.
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

bool valid(int batch, int t_len, int channels, int kernel_size,
           int dilation) {
  return batch > 0 && t_len > 0 && channels > 0 && channels % 32 == 0 &&
         kernel_size > 0 && kernel_size % 2 == 1 && dilation > 0;
}

}  // namespace

// out = [res +] conv_{K,dilation}(lrelu(x)) + bias in float32; res may be
// null; w is (C_out, C_in, K). Returns cudaGetLastError() after the launch
// (0 on success).
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
  return (int)(channels % 64 == 0
                   ? dispatch_f32<64>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s)
                   : dispatch_f32<32>(xp, wp, bp, rp, op, batch, t_len, channels, kernel_size, dilation, s));
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
