// Masked multi-head attention backward (flash attention) in bf16, written by
// hand for Hopper (sm_90a) on the tensor cores, with a plain C interface for
// ctypes.
//
// Replaces the bf16 instantiation of the two pallas_calls of the custom VJP
// behind expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py
// (flash_mha, :53): JAX 0.9.0's jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_bwd_dkv (:941, pallas_call at :1121)
// and _flash_attention_bwd_dq (:1287, pallas_call at :1456), which the JAX
// package's bf16 mixed-precision train step runs on bf16 q, k, v, out and
// dO. For each (batch b, head h), with s_ij = (q_i . k_j) * sm_scale and the
// forward's float32 row log-sum-exp lse_i (csrc/flash_mha_bf16.cu):
//     P_ij  = exp(s_ij - lse_i), 0 where key j is padded (mask[b][j] != 0)
//     Δ_i   = dO_i . out_i                        (float32, :274)
//     dS_ij = bf16(P_ij * (dO_i . v_j - Δ_i) * sm_scale)   (:912-918)
//     dq_i  = sum_j dS_ij k_j                     (:1240-1261)
//     dk_j  = sum_i dS_ij q_i,   dv_j = sum_i bf16(P_ij) dO_i   (:900)
// with S and dP from the bf16 operands into float32, P and dS in float32
// and rounded to bf16 only as operands of the products, the accumulators
// float32, and dq, dk, dv stored in bf16: the TPU kernel's rounding points.
// A row with no valid key has lse = +inf (the forward's sentinel), so its
// P, dS and dq are exactly 0. Only keys are masked, so every query row
// equals the plain version (ops/flash_mha.py:flash_mha_bwd_plain on bf16
// inputs) for any dO.
//
// Two kernels, as on the TPU, and no atomics, so a rerun is the same bit for
// bit:
//   * the dQ kernel: a block per (b, h, 64 query rows). It writes Δ for its
//     rows, then streams the 64-key tiles with a valid key, recomputing S,
//     dP, P and dS, and accumulates dq;
//   * the dK/dV kernel, launched after it on the same stream: a block per
//     (b, h, 64 keys). A block whose keys are all padded writes zeros and
//     exits; the others stream every 64-query tile (padded queries too: they
//     have dO and count for dk, dv), reading the Δ the dQ kernel wrote, and
//     accumulate dk and dv.
//
// What bounds it: operations. The pair recomputes S and dP in both kernels
// and forms dq, dk and dv: 14*B*H*T^2*D flops over the live tiles against
// ~20*B*H*T*D bytes of bf16 and 8*B*H*T of float32 statistics, T/1.4 flops
// a byte. The card's floor is those flops at the bf16 rate, 989 TF/s.
//
// Design (a block: one warpgroup of 128 threads; ~99 KB of shared memory):
//   * the block's 64 resident rows (Q and dO for dQ; K and V for dK/dV)
//     are the A operand of S and dP (S^T and dP^T in dK/dV) from swizzled
//     shared memory; the streamed tile is their K-major B operand as TMA
//     lands it (bf16_wgmma.cuh);
//   * the third products take the streamed tile as an MN-major B operand
//     (the transpose bit), again as it lies: dq += dS K, dk += dS^T Q and
//     dv += P^T dO, with dS, dS^T and P^T rounded to bf16 from the
//     accumulator registers straight into A fragments (computing S^T = K Q^T
//     and dP^T = V dO^T in dK/dV leaves P^T and dS^T where an A operand
//     wants them). No staging through shared memory, no transposed copy;
//   * dq, dk and dv are wgmma accumulators chained across the tiles (one
//     float32 chain: the tensor cores' truncation adds up to ~1e-5 relative
//     over 8192 keys, far below bf16's 2^-9);
//   * 64-row streamed tiles come by TMA (3-D tensor maps over the
//     (B*H, T, 128) view, rows past T zero) through a two-stage mbarrier
//     ring, one tile ahead: thread 0 issues tile n + 1 once the block is
//     past tile n - 1 (a block barrier). In dQ every warp scans the mask for
//     the next key tile with a valid key (two ballots a tile); wholly padded
//     tiles are skipped (exact: they add exp(-inf) = 0). In dK/dV, lse and
//     Δ of a query tile come by cp.async, 4 bytes a lane (head*T + q0 is
//     not 16-byte aligned for every T), counted on the tile's mbarrier; past
//     T they read as 0, where Q and dO are 0, so those queries add exactly
//     0;
//   * ragged T needs no padding; offsets are 64-bit; exp is the accurate
//     expf.
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 128) bf16, contiguous,
// 16-byte aligned; mask (B, T) bytes, nonzero at padded keys; lse and delta
// (B, H, T) float32.

#include <math_constants.h>

#include "bf16_wgmma.cuh"

namespace {

using namespace sm90;
using namespace bf16mma;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;                        // head dim
constexpr int kRows = kTileRows;               // resident rows per block
constexpr int kThreads = 128;                  // one warpgroup
constexpr uint32_t kOffRes = 0;                // two resident tiles
constexpr uint32_t kOffStage = 2 * kTile;      // [stage][two streamed tiles]
constexpr uint32_t kStage = 2 * kTile;
// dQ: Δ of the block's rows.
constexpr uint32_t kDqOffDelta = kOffStage + 2 * kStage;
constexpr uint32_t kDqOffBar = kDqOffDelta + kRows * 4;
constexpr size_t kDqSmemBytes = kDqOffBar + 2 * 8 + 1024;
// dK/dV: lse and Δ of each stage's queries.
constexpr uint32_t kDkvOffStats = kOffStage + 2 * kStage;
constexpr uint32_t kDkvOffBar = kDkvOffStats + 2 * 2 * kTileRows * 4;
constexpr size_t kDkvSmemBytes = kDkvOffBar + 2 * 8 + 1024;
static_assert(kDqSmemBytes <= 232448 && kDkvSmemBytes <= 232448,
              "more shared memory than a block may use");

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& base) {
  const uint32_t addr = smem_addr(raw);
  base = (addr + 1023u) & ~1023u;
  return raw + (base - addr);
}

// Rows [r0, r0 + 64) of a (T, 128) bf16 output from the accumulator pair
// acc[half] (row 16w + g + 8h, column 64 half + 8j + 2t + e); rows past T
// are not stored.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[2][32],
                                           int r0, int t_len) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= t_len) continue;
    bf16* row = dst + (int64_t)r * kD + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 64 * half + 8 * j) =
            pack_bf16x2(acc[half][4 * j + 2 * h], acc[half][4 * j + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// The dQ kernel.

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const bf16* __restrict__ q,
                             const uint8_t* __restrict__ mask,
                             const bf16* __restrict__ out,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq,
                             int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kDqOffBar;
  float* delta_s = reinterpret_cast<float*>(smem + kDqOffDelta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  uint64_t bits;
  int tile = next_live_tile(mrow, t_len, 0, bits);
  if (tid == 0 && tile < n_tiles)
    load_tile_pair(&tm_k, &tm_v, tile, bh, base + kOffStage, bars);

  load_rows<kThreads>(smem + kOffRes, q + head * kD, q0, t_len);
  load_rows<kThreads>(smem + kOffRes + kTile, dout + head * kD, q0, t_len);
  // Δ of the block's rows in float32 from the bf16 out and dO, 16 a warp
  // (32 lanes x 4 dims); rows past T get 0 (their P is 0).
  for (int i = 0; i < kRows / 4; ++i) {
    const int r = 16 * warp + i;
    float part = 0.f;
    if (q0 + r < t_len) {
      const int64_t off = (head + q0 + r) * kD + 4 * lane;
      const uint2 o = *reinterpret_cast<const uint2*>(out + off);
      const uint2 d = *reinterpret_cast<const uint2*>(dout + off);
      __nv_bfloat162 ob[2], db[2];
      memcpy(ob, &o, 8);
      memcpy(db, &d, 8);
      const float2 o0 = __bfloat1622float2(ob[0]);
      const float2 o1 = __bfloat1622float2(ob[1]);
      const float2 d0 = __bfloat1622float2(db[0]);
      const float2 d1 = __bfloat1622float2(db[1]);
      part = fmaf(o0.x, d0.x, fmaf(o0.y, d0.y, fmaf(o1.x, d1.x, o1.y * d1.y)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      delta_s[r] = part;
      if (q0 + r < t_len) delta[head + q0 + r] = part;
    }
  }
  fence_proxy_async();
  __syncthreads();
  // This thread's rows: 16 warp + g + 8h.
  float lse_r[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    lse_r[h] = q0 + r < t_len ? lse[head + q0 + r] : CUDART_INF_F;
    dlt[h] = delta_s[r];
  }

  float acc_dq[2][32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc_dq[0][i] = acc_dq[1][i] = sc[i] = dp[i] = 0.f;

  for (int n = 0; tile < n_tiles; ++n) {
    const int s = n & 1;
    uint64_t next_bits;
    const int next = next_live_tile(mrow, t_len, tile + 1, next_bits);
    mbar_wait(bars + 8 * s, (n >> 1) & 1);
    __syncthreads();  // the block is past tile n - 1: stage s ^ 1 is free
    if (tid == 0 && next < n_tiles)
      load_tile_pair(&tm_k, &tm_v, next, bh,
                     base + kOffStage + (s ^ 1) * kStage, bars + 8 * (s ^ 1));
    const uint32_t kst = base + kOffStage + s * kStage;

    wgmma_fence();
    rows_product(sc, base + kOffRes, kst);                   // Q K^T
    rows_product(dp, base + kOffRes + kTile, kst + kTile);   // dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // dS at (row 16 warp + g + 8h, key 8j + 2 t4 + e), scaled, in float32.
    float ds[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int h = (c >> 1) & 1;
      const int key = 8 * (c >> 2) + 2 * t4 + (c & 1);
      const float p = (bits >> key) & 1u ? expf(sc[c] * sm_scale - lse_r[h])
                                         : 0.f;
      ds[c] = (dp[c] - dlt[h]) * p * sm_scale;
    }
    uint32_t da[4][4];
    accumulator_to_a(da, ds);
    wgmma_fence();
    cols_product(acc_dq, da, kst, n > 0);                    // dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dq[0]);
    fence_operands(acc_dq[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(da[kk]);
    tile = next;
    bits = next_bits;
  }
  store_rows(dq + head * kD, acc_dq, q0, t_len);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel.

// Thread 0's warp: query tile i into stage s: its lse and Δ by the lanes
// with cp.async (0 past T, where Q and dO read as 0 too, so those queries
// add exactly 0), counted on the stage's mbarrier; Q and dO by TMA (lane 0).
__device__ __forceinline__ void load_query_tile(const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do,
                                                const float* lse,
                                                const float* delta,
                                                int t_len, int bh, int i,
                                                int s, uint32_t base,
                                                uint32_t bars) {
  const int lane = threadIdx.x & 31;
  const uint32_t bar = bars + 8 * s;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i * kTileRows + 32 * half + lane;
    const bool in = row < t_len;
    const int64_t r = (int64_t)bh * t_len + (in ? row : 0);
    const uint32_t dst =
        base + kDkvOffStats + (s * 2 * kTileRows + 32 * half + lane) * 4;
    cp_async4(dst, lse + r, in ? 4 : 0);
    cp_async4(dst + kTileRows * 4, delta + r, in ? 4 : 0);
  }
  cp_async_mbar_arrive(bar);
  __syncwarp();
  if (lane == 0)
    load_tile_pair(tm_q, tm_do, i, bh, base + kOffStage + s * kStage, bar);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kDkvOffBar;
  const float* stats = reinterpret_cast<const float*>(smem + kDkvOffStats);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  // A block whose keys are all padded: dk and dv are 0 there.
  const bool live = tid < kRows && k0 + tid < t_len && mrow[k0 + tid] == 0;
  if (!__syncthreads_or(live)) {
    for (int f = tid; f < kRows * kD / 8; f += kThreads) {
      const int r = k0 + (f >> 4);
      if (r >= t_len) continue;
      const int64_t off = (head + r) * kD + 8 * (f & 15);
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0)
    load_query_tile(&tm_q, &tm_do, lse, delta, t_len, bh, 0, 0, base, bars);

  load_rows<kThreads>(smem + kOffRes, k + head * kD, k0, t_len);
  load_rows<kThreads>(smem + kOffRes + kTile, v + head * kD, k0, t_len);
  // This thread's keys: 16 warp + g + 8h.
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g + 8 * h;
    valid[h] = key < t_len && mrow[key] == 0;
  }
  fence_proxy_async();
  __syncthreads();

  float acc_dk[2][32], acc_dv[2][32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc_dk[0][i] = acc_dk[1][i] = acc_dv[0][i] = acc_dv[1][i] = sc[i] =
        dp[i] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n & 1;
    mbar_wait(bars + 8 * s, (n >> 1) & 1);
    __syncthreads();  // the block is past tile n - 1: stage s ^ 1 is free
    if (warp == 0 && n + 1 < n_tiles)
      load_query_tile(&tm_q, &tm_do, lse, delta, t_len, bh, n + 1, s ^ 1,
                      base, bars);
    const uint32_t qst = base + kOffStage + s * kStage;
    const float* lse_s = stats + s * 2 * kTileRows;
    const float* dlt_s = lse_s + kTileRows;

    wgmma_fence();
    rows_product(sc, base + kOffRes, qst);                   // K Q^T
    rows_product(dp, base + kOffRes + kTile, qst + kTile);   // V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // P^T and dS^T at (key 16 warp + g + 8h, query 8j + 2 t4 + e).
    float pt[32], dsv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int h = (c >> 1) & 1;
      const int qi = 8 * (c >> 2) + 2 * t4 + (c & 1);
      const float p = valid[h] ? expf(sc[c] * sm_scale - lse_s[qi]) : 0.f;
      pt[c] = p;
      dsv[c] = (dp[c] - dlt_s[qi]) * p * sm_scale;
    }
    uint32_t pa[4][4], da[4][4];
    accumulator_to_a(pa, pt);
    accumulator_to_a(da, dsv);
    wgmma_fence();
    cols_product(acc_dv, pa, qst + kTile, n > 0);            // P^T dO
    cols_product(acc_dk, da, qst, n > 0);                    // dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dk[0]);
    fence_operands(acc_dk[1]);
    fence_operands(acc_dv[0]);
    fence_operands(acc_dv[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_operands(pa[kk]);
      fence_operands(da[kk]);
    }
  }
  store_rows(dk + head * kD, acc_dk, k0, t_len);
  store_rows(dv + head * kD, acc_dv, k0, t_len);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The dQ kernel; also writes delta (B, H, T) = rowsum(dout * out) in
// float32 for the dK/dV kernel. Returns cudaGetLastError() after the launch
// (0 on success), or the code of sm90::make_tensor_map_bf16 if a tensor map
// cannot be made.
extern "C" int flash_mha_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const uint8_t* mask,
                                     const void* out, const void* dout,
                                     const float* lse, float* delta,
                                     void* dq, int batch, int n_head,
                                     int t_len, float sm_scale, void* stream) {
  // The runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward in its own), which
  // cuTensorMapEncodeTiled needs.
  int err = set_smem(flash_mha_bwd_dq_bf16_kernel, kDqSmemBytes);
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0)
    err = make_tensor_map_bf16(&tm_k, k, heads, t_len, kD, kTileRows);
  if (err == 0)
    err = make_tensor_map_bf16(&tm_v, v, heads, t_len, kD, kTileRows);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dq_bf16_kernel<<<grid, kThreads, kDqSmemBytes,
                                 (cudaStream_t)stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), mask,
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// The dK/dV kernel; reads the delta the dQ kernel wrote. Returns
// cudaGetLastError() after the launch (0 on success), or the code of
// sm90::make_tensor_map_bf16 if a tensor map cannot be made.
extern "C" int flash_mha_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const uint8_t* mask,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dk, void* dv,
                                      int batch, int n_head, int t_len,
                                      float sm_scale, void* stream) {
  int err = set_smem(flash_mha_bwd_dkv_bf16_kernel, kDkvSmemBytes);  // see dQ
  CUtensorMap tm_q, tm_do;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0)
    err = make_tensor_map_bf16(&tm_q, q, heads, t_len, kD, kTileRows);
  if (err == 0)
    err = make_tensor_map_bf16(&tm_do, dout, heads, t_len, kD, kTileRows);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dkv_bf16_kernel<<<grid, kThreads, kDkvSmemBytes,
                                  (cudaStream_t)stream>>>(
      tm_q, tm_do, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of each kernel takes, in bytes (ptxas
// reports only static shared memory).
extern "C" int flash_mha_bwd_dq_bf16_smem_bytes() { return (int)kDqSmemBytes; }
extern "C" int flash_mha_bwd_dkv_bf16_smem_bytes() {
  return (int)kDkvSmemBytes;
}

// Rows of a streamed tile (the dQ kernel's key tile, the unit in which it
// skips wholly padded keys; the dK/dV kernel's query tile) and resident
// rows of a block (the dK/dV kernel's keys, the unit in which it writes
// zeros for padded keys).
extern "C" int flash_mha_bwd_bf16_stream_tile() { return kTileRows; }
extern "C" int flash_mha_bwd_bf16_block_rows() { return kRows; }
