// Masked multi-head attention forward (flash attention), written by hand for
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py,
// flash_mha (:53), which wraps JAX's stock TPU Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, forward pallas_call
// at :758). For each (batch b, head h) and query row i:
//     out[i] = sum_j softmax_j(s_ij) v[j],   s_ij = (q_i . k_j) * sm_scale,
// with s_ij = -inf where key j is padded (mask[b][j] != 0), the scores and
// the softmax in float32, and 0 for a row whose keys are all padded. Only
// keys are masked, so every query row, padded rows included, equals the
// plain version (ops/flash_mha.py:flash_mha_plain). The TPU kernel masks
// with segment IDs and lets padded queries attend to padded keys; the FFT
// block zeroes those rows in both packages.
//
// For the backward (csrc/flash_mha_bwd.cu) the kernel also stores, when
// given an lse pointer, each row's log-sum-exp of its scaled scores,
// lse[i] = m_i + log(l_i), in float32. A row with no valid key stores +inf,
// so that every probability the backward recomputes, exp(s - lse), is
// exactly 0 there. Inference passes a null pointer and stores nothing.
//
// What bounds it: operations. Two products of 2*T*T*D flops per (b, h),
// 4*B*H*T^2*D flops in all, against 16*B*H*T*D bytes (q, k, v read once and
// out written once, float32): T/4 flops per byte, 1024 at T = 4096, far
// above the ~148 flops per byte at which the card's TF32 tensor cores (and
// the ~20 at which its float32 CUDA cores) stop waiting on memory. The
// (T, T) scores never reach device memory. This first version runs both
// products as float32 FMAs on the CUDA cores; its design keeps the FMA
// units, not memory, busy:
//   * a block owns 64 query rows of one (b, h) and loops over the keys in
//     tiles of 64, so Q is read from device memory once and K and V once per
//     query tile (T/64 times in all, mostly from L2);
//   * Q, the K tile, the V tile and the tile's probabilities P sit in shared
//     memory (117,760 bytes, padded rows: no bank conflicts on the 16-byte
//     loads); each thread computes a 4 x 4 block of scores, then a 4 x 8
//     block of the output, from 16-byte loads that each feed 4 to 16 FMAs;
//   * the online softmax keeps each row's running max and sum in float32
//     registers, reduced over the 16 threads that share a row with warp
//     shuffles, and rescales the output accumulator in registers;
//   * exp is the accurate expf (no fast math), and the output is divided by
//     the row sum, as the plain version divides the probabilities;
//   * ragged T needs no padding to a tile: loads past T read zero, keys past
//     T are masked, and the epilogue stores only rows below T;
//   * offsets into q, k, v and out are 64-bit.
// Tensor cores (wgmma), TMA loads through an mbarrier ring and a pipelined
// K/V stage are later work (ROADMAP.md, queue 2).
//
// Layouts: q, k, v and out (B, H, T, 128) float32, contiguous, 16-byte
// aligned; mask (B, T) bytes, nonzero at padded keys; lse (B, H, T) float32
// or null.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim
constexpr int kBq = 64;                 // query rows per block
constexpr int kBk = 64;                 // keys per tile
constexpr int kThreads = 256;           // 16 row groups x 16 column groups
constexpr int kQkStride = kD + 4;       // padded Q and K rows
constexpr int kVStride = kD;            // V rows (read along the row)
constexpr int kPStride = kBk + 4;       // padded P rows
constexpr int kVec = kD / 4;            // float4 per row
constexpr size_t kSmemBytes =
    sizeof(float) * (kBq * kQkStride + kBk * kQkStride + kBk * kVStride +
                     kBq * kPStride);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Reduce over the 16 lanes that share a row (lanes differing in bits 0..3).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ lse, int n_head, int t_len,
                     float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBq][kQkStride]
  float* ks = qs + kBq * kQkStride;        // [kBk][kQkStride]
  float* vs = ks + kBk * kQkStride;        // [kBk][kVStride]
  float* ps = vs + kBk * kVStride;         // [kBq][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // scores: keys tx + 16j; output: dims 4tx.., 64+4tx..
  const int ty = tid >> 4;   // query rows 4ty .. 4ty+3 of the tile
  const int q0 = blockIdx.x * kBq;
  const int64_t head = ((int64_t)blockIdx.z * n_head + blockIdx.y) * t_len;
  const float* qh = q + head * kD;
  const float* kh = k + head * kD;
  const float* vh = v + head * kD;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  for (int i = tid; i < kBq * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t_len) val = load4(qh + (int64_t)(q0 + r) * kD + c);
    store4(qs + r * kQkStride + c, val);
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kBk) {
    __syncthreads();  // Q is staged; the last tile's K, V and P are read
    for (int i = tid; i < kBk * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < t_len) {
        kv = load4(kh + (int64_t)(k0 + r) * kD + c);
        vv = load4(vh + (int64_t)(k0 + r) * kD + c);
      }
      store4(ks + r * kQkStride + c, kv);
      store4(vs + r * kVStride + c, vv);
    }
    __syncthreads();

    // Scores of rows 4ty+i against keys k0 + tx + 16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(qs + (4 * ty + i) * kQkStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = load4(ks + (tx + 16 * j) * kQkStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = key < t_len && mrow[key] == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = valid ? s[i][j] * sm_scale : -CUDART_INF_F;
    }

    // Online softmax. A row with no valid key yet keeps max -inf; it is
    // shifted by 0 instead, so its probabilities are exp(-inf) = 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tile_max =
          row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], tile_max);
      const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - shift);
        ps[(4 * ty + i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's keys.
#pragma unroll 2
    for (int c = 0; c < kBk; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(ps + (4 * ty + i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 v0 = load4(vs + (c + cc) * kVStride + 4 * tx);
        const float4 v1 = load4(vs + (c + cc) * kVStride + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pa[i], cc);
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= t_len) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* o = out + (head + r) * kD;
    store4(o + 4 * tx, make_float4(acc[i][0] / denom, acc[i][1] / denom,
                                   acc[i][2] / denom, acc[i][3] / denom));
    store4(o + 64 + 4 * tx, make_float4(acc[i][4] / denom, acc[i][5] / denom,
                                        acc[i][6] / denom, acc[i][7] / denom));
    if (lse != nullptr && tx == 0)
      lse[head + r] = l[i] == 0.f ? CUDART_INF_F : m[i] + logf(l[i]);
  }
}

}  // namespace

// q, k, v, out: (batch, n_head, t_len, 128) float32; mask: (batch, t_len)
// bytes; lse: (batch, n_head, t_len) float32, or null to store none.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_mha_fwd_f32(const float* q, const float* k,
                                 const float* v, const uint8_t* mask,
                                 float* out, float* lse, int batch,
                                 int n_head, int t_len, float sm_scale,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  flash_mha_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q, k, v, mask, out, lse, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}
