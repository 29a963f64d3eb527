// Masked multi-head attention backward (flash attention), written by hand
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two pallas_calls of the custom VJP that the JAX package's
// expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py (flash_mha,
// :53) differentiates through: JAX's stock TPU flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_bwd
// (:254), whose kernels are _flash_attention_bwd_dkv (:941, pallas_call at
// :1121) and _flash_attention_bwd_dq (:1287, pallas_call at :1456). For each
// (batch b, head h), with s_ij = (q_i . k_j) * sm_scale, the forward's row
// log-sum-exp lse_i (csrc/flash_mha.cu) and the output's gradient dO:
//     P_ij  = exp(s_ij - lse_i), 0 where key j is padded (mask[b][j] != 0)
//     Δ_i   = dO_i . out_i
//     dS_ij = P_ij * (dO_i . v_j - Δ_i)
//     dq_i  = sm_scale * sum_j dS_ij k_j
//     dk_j  = sm_scale * sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i
// A row with no valid key has lse = +inf (the forward's sentinel), so its P,
// dS and dq are exactly 0. Only keys are masked, so every query row equals
// the plain version (ops/flash_mha.py:flash_mha_bwd_plain) for any dO; in
// the FFT block dO is 0 at padded rows, and dk, dv then equal the TPU
// kernel's, whose segment IDs pair padded queries with padded keys.
//
// Two kernels, as on the TPU, and no atomics, so the backward is the same
// bit for bit run to run:
//   * the dQ kernel: one block per (b, h, 64 query rows). It first writes
//     Δ for its rows (dO . out, one warp per row), then loops over the keys
//     in tiles of 64, recomputing P and dS from Q, dO, the K and V tiles and
//     lse, and accumulates dq = dS K in registers;
//   * the dK/dV kernel, launched after it on the same stream: one block per
//     (b, h, 64 keys); it loops over the queries in tiles of 64, recomputes
//     P and dS (reading the Δ the dQ kernel wrote) and accumulates dv = Pᵀ dO
//     and dk = dSᵀ Q in registers.
//
// What bounds it: operations. The backward recomputes S and dP and forms
// dq, dk and dv: at least 10*B*H*T^2*D flops (S, dP, dv, dk, dq), against
// about 32*B*H*T*D bytes (q, k, v, out, dO read once, dq, dk, dv written
// once, float32), far above the card's ridge point at T of several hundred.
// The kernels recompute S and dP in both passes (14*B*H*T^2*D flops in all,
// the TPU kernel's split) and keep every (T, T) matrix out of device
// memory. This first version runs the products as float32 FMAs on the CUDA
// cores, with the forward kernel's tiling: Q, K, V and dO tiles of 64 x 128
// in shared memory with rows padded to 132 floats (no bank conflicts on the
// 16-byte loads); each thread computes a 4 x 4 block of S and dP, then a
// 4 x 8 block of the accumulator, from 16-byte loads that each feed 4 to 16
// FMAs. Shared memory is 153,088 bytes (dQ) and 170,496 bytes (dK/dV), so
// cudaFuncSetAttribute before the launch and one block per SM. exp is the
// accurate expf (no fast math); ragged T needs no padding to a tile (loads
// past T read 0, keys past T are masked, query rows past T have lse = +inf
// and so P = 0, stores stop at T); offsets are 64-bit. Tensor cores
// (wgmma in TF32), TMA loads and skipping wholly padded tiles are later work
// (ROADMAP.md, queue 2).
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 128) float32,
// contiguous, 16-byte aligned; mask (B, T) bytes, nonzero at padded keys;
// lse and delta (B, H, T) float32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;            // head dim
constexpr int kTile = 64;          // query rows or keys per tile
constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kStride = kD + 4;    // padded rows of the Q, K, V, dO tiles
constexpr int kPStride = kTile + 4;  // padded rows of the P and dS tiles
constexpr int kVec = kD / 4;       // float4 per row
constexpr int kTileFloats = kTile * kStride;
constexpr int kPFloats = kTile * kPStride;
// dQ: Q, dO, K, V tiles, dS, and the rows' lse and Δ.
constexpr size_t kDqSmemBytes =
    sizeof(float) * (4 * kTileFloats + kPFloats + 2 * kTile);
// dK/dV: K, V, Q, dO tiles, Pᵀ, dSᵀ, and the query tile's lse and Δ.
constexpr size_t kDkvSmemBytes =
    sizeof(float) * (4 * kTileFloats + 2 * kPFloats + 2 * kTile);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows [r0, r0 + 64) of one head's (T, 128) matrix into a padded shared
// tile; rows past T are 0.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int t_len) {
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t_len) val = load4(src + (int64_t)(r0 + r) * kD + c);
    store4(dst + r * kStride + c, val);
  }
}

// acc[i][j] = a[4ty + i] . b[tx + 16j] over the 128 dims of two tiles.
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (4 * ty + i) * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(b + (tx + 16 * j) * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][:] += sum_c p[4ty + i][c] * m[c][dims], over the 64 rows c of m,
// for the thread's dims 4tx .. 4tx+3 and 64+4tx .. 64+4tx+3.
__device__ __forceinline__ void tile_accumulate(const float* p,
                                                const float* m, int ty,
                                                int tx, float acc[4][8]) {
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = load4(p + (4 * ty + i) * kPStride + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 m0 = load4(m + (c + cc) * kStride + 4 * tx);
      const float4 m1 = load4(m + (c + cc) * kStride + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = lane(pa[i], cc);
        acc[i][0] = fmaf(w, m0.x, acc[i][0]);
        acc[i][1] = fmaf(w, m0.y, acc[i][1]);
        acc[i][2] = fmaf(w, m0.z, acc[i][2]);
        acc[i][3] = fmaf(w, m0.w, acc[i][3]);
        acc[i][4] = fmaf(w, m1.x, acc[i][4]);
        acc[i][5] = fmaf(w, m1.y, acc[i][5]);
        acc[i][6] = fmaf(w, m1.z, acc[i][6]);
        acc[i][7] = fmaf(w, m1.w, acc[i][7]);
      }
    }
  }
}

// Rows 4ty + i of a 64-row tile starting at r0, times scale, into one
// head's (T, 128) matrix; rows past T are not stored.
__device__ __forceinline__ void store_rows(float* dst, const float acc[4][8],
                                           int r0, int ty, int tx,
                                           int t_len, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= t_len) continue;
    float* o = dst + (int64_t)r * kD;
    store4(o + 4 * tx, make_float4(acc[i][0] * scale, acc[i][1] * scale,
                                   acc[i][2] * scale, acc[i][3] * scale));
    store4(o + 64 + 4 * tx, make_float4(acc[i][4] * scale, acc[i][5] * scale,
                                        acc[i][6] * scale, acc[i][7] * scale));
  }
}

__global__ void __launch_bounds__(kThreads)
flash_mha_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ out,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int n_head, int t_len, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // the block's query rows
  float* dos = qs + kTileFloats;       // their dO
  float* ks = dos + kTileFloats;       // a key tile
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;       // [query][key] dS of the tile
  float* lse_s = dss + kPFloats;       // [query]
  float* delta_s = lse_s + kTile;      // [query]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // keys tx + 16j; output dims 4tx.., 64+4tx..
  const int ty = tid >> 4;   // query rows 4ty .. 4ty+3 of the tile
  const int q0 = blockIdx.x * kTile;
  const int64_t head = ((int64_t)blockIdx.z * n_head + blockIdx.y) * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  load_tile(qs, q + head * kD, q0, t_len);
  load_tile(dos, dout + head * kD, q0, t_len);
  __syncthreads();

  // Δ of the block's rows, one warp per row: 32 lanes x float4 = 128 dims.
  const int warp = tid >> 5, ln = tid & 31;
  for (int rr = 0; rr < kTile / (kThreads / 32); ++rr) {
    const int r = warp * (kTile / (kThreads / 32)) + rr;
    const bool in = q0 + r < t_len;
    float part = 0.f;
    if (in) {
      const float4 o = load4(out + (head + q0 + r) * kD + 4 * ln);
      const float4 g = load4(dos + r * kStride + 4 * ln);
      part = fmaf(o.x, g.x, fmaf(o.y, g.y, fmaf(o.z, g.z, o.w * g.w)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (ln == 0) {
      delta_s[r] = part;
      lse_s[r] = in ? lse[head + q0 + r] : CUDART_INF_F;
      if (in) delta[head + q0 + r] = part;
    }
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    __syncthreads();  // lse, Δ staged; the last tile's K, V and dS are read
    load_tile(ks, k + head * kD, k0, t_len);
    load_tile(vs, v + head * kD, k0, t_len);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(qs, ks, ty, tx, s);    // S[4ty+i][tx+16j]
    tile_dot(dos, vs, ty, tx, dp);  // dP[4ty+i][tx+16j] = dO . v
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = key < t_len && mrow[key] == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        const float p = valid ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        dss[r * kPStride + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_accumulate(dss, ks, ty, tx, acc);  // dq += dS K
  }
  store_rows(dq + head * kD, acc, q0, ty, tx, t_len, sm_scale);
}

__global__ void __launch_bounds__(kThreads)
flash_mha_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int n_head, int t_len, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // the block's keys
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;        // a query tile
  float* dos = qs + kTileFloats;       // its dO
  float* pts = dos + kTileFloats;      // [key][query] P of the tile
  float* dsts = pts + kPFloats;        // [key][query] dS of the tile
  float* lse_s = dsts + kPFloats;      // [query]
  float* delta_s = lse_s + kTile;      // [query]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // queries tx + 16j; output dims 4tx.., 64+4tx..
  const int ty = tid >> 4;   // keys 4ty .. 4ty+3 of the block
  const int k0 = blockIdx.x * kTile;
  const int64_t head = ((int64_t)blockIdx.z * n_head + blockIdx.y) * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  load_tile(ks, k + head * kD, k0, t_len);
  load_tile(vs, v + head * kD, k0, t_len);
  bool kvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    kvalid[i] = key < t_len && mrow[key] == 0;
  }

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < t_len; q0 += kTile) {
    __syncthreads();  // K, V staged; the last tile's Q, dO, P and dS are read
    load_tile(qs, q + head * kD, q0, t_len);
    load_tile(dos, dout + head * kD, q0, t_len);
    if (tid < kTile) {
      const bool in = q0 + tid < t_len;
      lse_s[tid] = in ? lse[head + q0 + tid] : CUDART_INF_F;
      delta_s[tid] = in ? delta[head + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(ks, qs, ty, tx, s);    // S[tx+16j][4ty+i] = k . q
    tile_dot(vs, dos, ty, tx, dp);  // dP[tx+16j][4ty+i] = dO . v
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = kvalid[i] ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        pts[(4 * ty + i) * kPStride + r] = p;
        dsts[(4 * ty + i) * kPStride + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_accumulate(pts, dos, ty, tx, dv_acc);   // dv += Pᵀ dO
    tile_accumulate(dsts, qs, ty, tx, dk_acc);   // dk += dSᵀ Q
  }
  store_rows(dk + head * kD, dk_acc, k0, ty, tx, t_len, sm_scale);
  store_rows(dv + head * kD, dv_acc, k0, ty, tx, t_len, 1.f);
}

}  // namespace

// The dQ kernel; also writes delta (B, H, T) = rowsum(dout * out) for the
// dK/dV kernel. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_mha_bwd_dq_f32(const float* q, const float* k,
                                    const float* v, const uint8_t* mask,
                                    const float* out, const float* dout,
                                    const float* lse, float* delta,
                                    float* dq, int batch, int n_head,
                                    int t_len, float sm_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kTile - 1) / kTile, n_head, batch);
  flash_mha_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes,
                            (cudaStream_t)stream>>>(
      q, k, v, mask, out, dout, lse, delta, dq, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// The dK/dV kernel; reads the delta the dQ kernel wrote. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_mha_bwd_dkv_f32(const float* q, const float* k,
                                     const float* v, const uint8_t* mask,
                                     const float* dout, const float* lse,
                                     const float* delta, float* dk,
                                     float* dv, int batch, int n_head,
                                     int t_len, float sm_scale,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kTile - 1) / kTile, n_head, batch);
  flash_mha_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes,
                             (cudaStream_t)stream>>>(
      q, k, v, mask, dout, lse, delta, dk, dv, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}
