// Masked multi-head attention at head dim 256 in float32 (flash attention):
// the forward, written by hand for Hopper (sm_90a) on the CUDA cores, with a
// plain C interface for ctypes. The backward at D = 256 is
// csrc/flash_mha_bwd_d256.cu (TF32 tensor cores).
//
// Replaces, at D = 256, what csrc/flash_mha.cu replaces at D = 128: the JAX
// package's expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py
// (flash_mha, :53), which wraps JAX's stock TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward,
// _flash_attention_impl :589, pallas_call at :758). That kernel takes any
// multiple of 128 as the head dim. The function is the D = 128 kernel's,
// whose note gives it in full: for each (batch b, head h), with
// s_ij = (q_i . k_j) * sm_scale and s_ij = -inf where key j is padded,
//     out_i = sum_j softmax_j(s_ij) v_j,   lse_i = log sum_j exp(s_ij)
// in float32, 0 (and lse = +inf) for a row whose keys are all padded. Only
// keys are masked, so every query row equals the plain version
// (ops/flash_mha.py: flash_mha_plain).
//
// Why the CUDA cores. The D = 128 forward keeps float32 accuracy on the TF32
// tensor cores by splitting each operand into two TF32 parts, and the split
// copies fill shared memory at D = 128 already (230 KB of 227 KB a block;
// see its note): at D = 256 each of those parts doubles. This kernel
// multiplies in float32 on the CUDA cores instead: one fused multiply-add a
// term, rounded to nearest, which is what the plain version does with TF32
// off. That is slower (the card's float32 rate is ~1/7 of its TF32 rate)
// and right; a tensor-core layout at D = 256 is later work.
//
// Design (256 threads, one block per SM):
//   * a thread is (row group, lane of 8): ty = tid / 8, tx = tid % 8. The 8
//     threads of a row group are 8 consecutive lanes of one warp; they
//     share their rows and split the columns: column c of a row belongs to
//     tx = (c / 4) % 8, so each thread holds 32 of the 256 (eight float4s,
//     32 floats apart), and a float4 load of 8 lanes reads 128 contiguous
//     bytes;
//   * operands are staged in shared memory by cp.async, 16 bytes a copy,
//     rows past T zero-filled. Rows that feed a dot product over d (Q, K)
//     are 260 floats apart, so that the 8 lanes of a group reading 8 rows
//     at one d hit 32 distinct banks;
//   * a dot product over d runs d = 0, 4, ..., 252 in order, one fused
//     multiply-add a term, in a register of the thread that owns the pair;
//   * P V goes into a fresh accumulator a tile and is added to the rescaled
//     running sum after it, so that the running sums of long rows add tile
//     sums, not single terms. P comes from the lane that computed it by
//     __shfl_sync, no shared memory;
//   * key tiles of 32 (one warp's ballot of the mask): a tile whose 32 keys
//     are all padded is neither loaded nor computed (it would add exp(-inf) =
//     0 and not move the running max, so skipping is exact), and a padded
//     key inside a live tile is skipped in P V (its P is 0);
//   * exp and log are the accurate expf, logf; offsets are 64-bit; ragged T
//     needs no padding.
//
// A block per (b, h, 64 query rows). Q's rows stay in shared memory; the
// live key tiles stream through two buffers (the next tile's copies in
// flight while the current one is computed). A thread holds S for its 2 rows
// and 4 keys (tx + 8j), the online softmax's max and sum of its rows
// (reduced over the 8 lanes), and 2 x 32 output columns.
//   Q 64 x 260 x 4 = 66,560; K 2 x 32 x 260 x 4 = 66,560; V 2 x 32 x 256 x 4
//   = 65,536: 198,656 bytes.
//
// Layouts: q, k, v, out (B, H, T, 256) float32, contiguous, 16-byte aligned;
// mask (B, T) bytes, nonzero at padded keys; lse (B, H, T) float32, or null.

#include <math_constants.h>

#include "sm90.cuh"

namespace {

using sm90::smem_addr;

constexpr int kD = 256;                  // head dim
constexpr int kThreads = 256;
constexpr int kGroup = 8;                // lanes that share a row
constexpr int kCols = kD / kGroup;       // columns a thread holds: 32
constexpr int kRows = 64;                // query rows a block (tile)
constexpr int kKeys = 32;                // keys a tile
constexpr int kStride = kD + 4;          // floats a row of a dot operand
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t kFwdSmemBytes =
    4 * ((size_t)kRows * kStride + 2 * kKeys * kStride + 2 * kKeys * kD);
static_assert(kFwdSmemBytes <= 232448,
              "more shared memory than a block may use");

// 16 bytes from device memory to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Rows [r0, r0 + n) of a head's (T, 256) matrix into shared memory at `dst`,
// `stride` floats a row; rows past T are zero.
template <int n>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* head, int r0,
                                          int t_len) {
  for (int f = threadIdx.x; f < n * kD / 4; f += kThreads) {
    const int r = f / (kD / 4);
    const int c = 4 * (f % (kD / 4));
    const bool in = r0 + r < t_len;
    cp_async16(dst + r * stride + c,
               head + (int64_t)(in ? r0 + r : 0) * kD + c, in ? 16 : 0);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[4i .. 4i + 3] += x * row[32 i .. 32 i + 3] for i = 0..7: a thread's
// 32 columns of one row (row points at the thread's first column).
__device__ __forceinline__ void axpy_row(float (&acc)[kCols], float x,
                                         const float* row) {
#pragma unroll
  for (int i = 0; i < kCols / 4; ++i) {
    const float4 y = ld4(row + 4 * kGroup * i);
    acc[4 * i] = fmaf(x, y.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(x, y.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(x, y.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(x, y.w, acc[4 * i + 3]);
  }
}

// A thread's 32 columns of a row to device memory, each times `scale`.
__device__ __forceinline__ void store_row(float* row, const float (&acc)[kCols],
                                          float scale) {
#pragma unroll
  for (int i = 0; i < kCols / 4; ++i)
    *reinterpret_cast<float4*>(row + 4 * kGroup * i) =
        make_float4(acc[4 * i] * scale, acc[4 * i + 1] * scale,
                    acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
}

// Reductions over the 8 lanes of a row group.
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 4);
}

// Key bits of tile i (bit c: key 32 i + c is below T and not padded). Every
// warp computes it, so it is the same in the whole block.
__device__ __forceinline__ uint32_t tile_bits(const uint8_t* mrow, int i,
                                              int t_len) {
  const int key = i * kKeys + (threadIdx.x & 31);
  return __ballot_sync(kFull, key < t_len && mrow[key] == 0);
}

// The first tile after i with a valid key (n_tiles if none), and its bits.
__device__ __forceinline__ int next_live(const uint8_t* mrow, int i,
                                         int n_tiles, int t_len,
                                         uint32_t& bits) {
  for (++i; i < n_tiles; ++i) {
    bits = tile_bits(mrow, i, t_len);
    if (bits != 0) return i;
  }
  bits = 0;
  return n_tiles;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_fwd_d256_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ lse,
                          int n_head, int t_len, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][kStride]
  float* ks = qs + kRows * kStride;             // [2][32][kStride]
  float* vs = ks + 2 * kKeys * kStride;         // [2][32][kD]
  const int tid = threadIdx.x;
  const int ty = tid / kGroup, tx = tid % kGroup;
  const int lane0 = (tid & 31) & ~(kGroup - 1);  // the group's first lane
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kKeys - 1) / kKeys;

  load_rows<kRows>(qs, kStride, q + head * kD, q0, t_len);
  uint32_t bits;
  int cur = next_live(mrow, -1, n_tiles, t_len, bits);
  if (cur < n_tiles) {
    load_rows<kKeys>(ks, kStride, k + head * kD, cur * kKeys, t_len);
    load_rows<kKeys>(vs, kD, v + head * kD, cur * kKeys, t_len);
  }
  cp_async_commit();

  float o[2][kCols], pv[2][kCols];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[h][c] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  const float* qa = qs + (2 * ty) * kStride;

  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    uint32_t next_bits;
    const int nxt = next_live(mrow, cur, n_tiles, t_len, next_bits);
    if (nxt < n_tiles) {
      load_rows<kKeys>(ks + (buf ^ 1) * kKeys * kStride, kStride,
                       k + head * kD, nxt * kKeys, t_len);
      load_rows<kKeys>(vs + (buf ^ 1) * kKeys * kD, kD, v + head * kD,
                       nxt * kKeys, t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the next tile's copies
    __syncthreads();
    const float* kt = ks + buf * kKeys * kStride;
    const float* vt = vs + buf * kKeys * kD;

    // S for rows 2 ty + h and keys tx + 8 j.
    float s[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[h][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      const float4 a = ld4(qa + d), b = ld4(qa + kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = ld4(kt + (tx + kGroup * j) * kStride + d);
        s[0][j] = dot4(s[0][j], a, x);
        s[1][j] = dot4(s[1][j], b, x);
      }
    }

    // Online softmax over the row group's 32 keys.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[h][j] = (bits >> (tx + kGroup * j)) & 1u ? s[h][j] * sm_scale
                                                    : -CUDART_INF_F;
        mx = fmaxf(mx, s[h][j]);
      }
      const float m_new = fmaxf(m[h], group_max(mx));
      const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[h] = expf(m[h] - shift);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[h][j] = expf(s[h][j] - shift);
        sum += s[h][j];
      }
      l[h] = l[h] * alpha[h] + group_sum(sum);
      m[h] = m_new;
    }

    // This tile's P V in a fresh accumulator, then o = o * alpha + P V.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pv[h][c] = 0.f;
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      const float pa = __shfl_sync(kFull, s[0][key / kGroup],
                                   lane0 + key % kGroup);
      const float pb = __shfl_sync(kFull, s[1][key / kGroup],
                                   lane0 + key % kGroup);
      if (!((bits >> key) & 1u)) continue;  // P = 0: adds nothing
      const float* vrow = vt + key * kD + 4 * tx;
      axpy_row(pv[0], pa, vrow);
      axpy_row(pv[1], pb, vrow);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o[h][c] = fmaf(o[h][c], alpha[h], pv[h][c]);
    __syncthreads();  // the buffer is free for the tile after next
    cur = nxt;
    bits = next_bits;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 2 * ty + h;
    if (r >= t_len) continue;
    store_row(out + (head + r) * kD + 4 * tx, o[h],
              1.f / (l[h] == 0.f ? 1.f : l[h]));
    if (lse != nullptr && tx == 0)
      lse[head + r] = l[h] == 0.f ? CUDART_INF_F : m[h] + logf(l[h]);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The forward. q, k, v, out: (batch, n_head, t_len, 256) float32; mask:
// (batch, t_len) bytes; lse: (batch, n_head, t_len) float32, or null to
// store none. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_mha_fwd_f32_d256(const float* q, const float* k,
                                      const float* v, const uint8_t* mask,
                                      float* out, float* lse, int batch,
                                      int n_head, int t_len, float sm_scale,
                                      void* stream) {
  const int err = set_smem(flash_mha_fwd_d256_kernel, kFwdSmemBytes);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_fwd_d256_kernel<<<grid, kThreads, kFwdSmemBytes,
                              (cudaStream_t)stream>>>(
      q, k, v, mask, out, lse, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the forward's block, in bytes.
extern "C" int flash_mha_d256_smem_bytes() { return (int)kFwdSmemBytes; }

// Keys per tile, the unit in which the forward skips wholly padded keys.
extern "C" int flash_mha_d256_key_tile() { return kKeys; }
