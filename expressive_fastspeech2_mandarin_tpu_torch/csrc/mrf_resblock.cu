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
// launches this kernel six times per resblock: once per conv, with the
// input leaky-ReLU, the bias and (for the second conv of a pair) the
// residual add fused in, so no elementwise pass runs on its own.
//
// What bounds it: operations. A conv does 2*K*C^2 flops per output element
// (C = 32..256, K = 3..11), 96..2816 FMAs for every element read or written.
// This version runs them as float32 FMAs on the CUDA cores, far below the
// tensor cores' rate; its design keeps the FMA units, not memory, busy:
//   * a block owns a tile of kNty*kRows time rows x TCO output channels and
//     each thread an 8 x 8 register tile, so each shared-memory load feeds
//     8 FMAs;
//   * the input rows of the tile plus the conv's halo ((K-1)/2*d rows each
//     side, up to 25) are staged in shared memory kCi channels at a time,
//     already leaky-ReLU'd, rounded to the working type and zero outside
//     [0, T) (the per-conv padding);
//   * the weights are streamed through shared memory in the same kCi-channel
//     chunks (one conv's weights at C=256, K=11 are 1.4 MB in bf16).
// Whole-chain fusion, wgmma and TMA are later work (ROADMAP.md, queue 2).
//
// Layouts: activations (B, T, C) contiguous, channels last; weights as
// torch.nn.Conv1d keeps them, (C_out, C_in, K); bias (C) in the working
// type. Offsets into the activations are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kCi = 16;                // input channels staged per step
constexpr int kRows = 8;               // output rows per thread
constexpr int kCols = 8;               // output channels per thread
constexpr int kXsStride = kCi + 1;     // padded staged-input row (no bank conflicts)
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> struct Store;
template <> struct Store<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

// The value a store to T keeps (round to nearest even for bf16).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(Store<T>::from(v)); }

template <int TCO>
struct Tile {
  static constexpr int kNtx = TCO / kCols;             // threads across channels
  static constexpr int kNty = kThreads / kNtx;         // threads across time
  static constexpr int kTimeRows = kNty * kRows;       // output rows per block
  static constexpr int kWsStride = TCO + 4;            // padded staged-weight row
};

template <typename T, int K, int TCO>
__global__ void __launch_bounds__(kThreads)
mrf_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ res,
                T* __restrict__ out, int t_len, int channels, int dilation) {
  using TL = Tile<TCO>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                 // [kCi*K][kWsStride]
  float* xs = smem + kCi * K * TL::kWsStride;       // [rows][kXsStride]

  const int pad = (K - 1) / 2 * dilation;
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
    for (int i = threadIdx.x; i < TCO * kCi * K; i += kThreads) {
      const int co = i / (kCi * K);
      const int q = i - co * (kCi * K);  // ci * K + tap
      ws[q * TL::kWsStride + co] =
          to_float(w[((int64_t)(co0 + co) * channels + ci0) * K + q]);
    }
    // Input rows [t0 - pad, t0 + kTimeRows + pad), leaky-ReLU'd in f32 and
    // rounded to the working type, zero outside [0, T).
    for (int i = threadIdx.x; i < rows * kCi; i += kThreads) {
      const int r = i / kCi;
      const int ci = i - r * kCi;
      const int t = t0 - pad + r;
      float v = 0.f;
      if (t >= 0 && t < t_len) {
        v = to_float(x[batch_off + (int64_t)t * channels + ci0 + ci]);
        v = round_to<T>(v >= 0.f ? v : v * kSlope);
      }
      xs[r * kXsStride + ci] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float* wrow = ws + (ci * K + k) * TL::kWsStride + tx * kCols;
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
  for (int c = 0; c < kCols; ++c) b[c] = to_float(bias[co0 + tx * kCols + c]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + ty + r * TL::kNty;
    if (t >= t_len) break;
    const int64_t off = batch_off + (int64_t)t * channels + co0 + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      // The conv output is stored in the working type; the residual sum is
      // taken in f32 from that stored value and cast once more.
      float y = round_to<T>(acc[r][c] + b[c]);
      if (res != nullptr) y += to_float(res[off + c]);
      out[off + c] = Store<T>::from(y);
    }
  }
}

template <typename T, int K, int TCO>
cudaError_t launch(const T* x, const T* w, const T* bias, const T* res, T* out,
                   int batch, int t_len, int channels, int dilation,
                   cudaStream_t stream) {
  using TL = Tile<TCO>;
  const int pad = (K - 1) / 2 * dilation;
  const size_t smem =
      sizeof(float) * ((size_t)kCi * K * TL::kWsStride +
                       (size_t)(TL::kTimeRows + 2 * pad) * kXsStride);
  // Above 48 KB a block may use dynamic shared memory only after this call;
  // without it the launch is refused.
  cudaError_t err = cudaFuncSetAttribute(
      mrf_conv_kernel<T, K, TCO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TL::kTimeRows - 1) / TL::kTimeRows,
                  channels / TCO, batch);
  mrf_conv_kernel<T, K, TCO><<<grid, kThreads, smem, stream>>>(
      x, w, bias, res, out, t_len, channels, dilation);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, const void* res,
             void* out, int batch, int t_len, int channels, int kernel_size,
             int dilation, void* stream) {
  if (batch <= 0 || t_len <= 0 || channels % 32 != 0 || dilation <= 0)
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = channels % 64 == 0;
  cudaError_t err;
  switch (kernel_size) {
    case 3:
      err = wide ? launch<T, 3, 64>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s)
                 : launch<T, 3, 32>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s);
      break;
    case 7:
      err = wide ? launch<T, 7, 64>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s)
                 : launch<T, 7, 32>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s);
      break;
    case 11:
      err = wide ? launch<T, 11, 64>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s)
                 : launch<T, 11, 32>(xp, wp, bp, rp, op, batch, t_len, channels, dilation, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// out = [res +] cast(conv_{K,dilation}(lrelu(x)) + bias); res may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mrf_conv_f32(const void* x, const void* w, const void* bias,
                            const void* res, void* out, int batch, int t_len,
                            int channels, int kernel_size, int dilation,
                            void* stream) {
  return dispatch<float>(x, w, bias, res, out, batch, t_len, channels,
                         kernel_size, dilation, stream);
}

extern "C" int mrf_conv_bf16(const void* x, const void* w, const void* bias,
                             const void* res, void* out, int batch, int t_len,
                             int channels, int kernel_size, int dilation,
                             void* stream) {
  return dispatch<__nv_bfloat16>(x, w, bias, res, out, batch, t_len, channels,
                                 kernel_size, dilation, stream);
}
