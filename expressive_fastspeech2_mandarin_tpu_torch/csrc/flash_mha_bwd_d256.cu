// Masked multi-head attention backward at head dim 256 in float32 (flash
// attention): the dQ kernel (with Δ) and the dK/dV kernel, written by hand
// for Hopper (sm_90a) on the TF32 tensor cores at float32 accuracy, with a
// plain C interface for ctypes.
//
// Replaces, at D = 256, the two pallas_calls of the backward that the JAX
// package's expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py
// (flash_mha, :53) differentiates through: JAX's stock TPU flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_bwd_dkv
// (:941, pallas_call at :1121) and _flash_attention_bwd_dq (:1287,
// pallas_call at :1456), which take any multiple of 128 as the head dim. The
// functions are csrc/flash_mha_bwd.cu's, whose note gives them in full: for
// each (batch b, head h), with s_ij = (q_i . k_j) * sm_scale, the forward's
// row log-sum-exp lse_i and the output's gradient dO,
//     P_ij  = exp(s_ij - lse_i), 0 where key j is padded
//     Δ_i   = dO_i . out_i,   dS_ij = P_ij (dO_i . v_j - Δ_i)
//     dq_i  = sm_scale sum_j dS_ij k_j,   dk_j = sm_scale sum_i dS_ij q_i,
//     dv_j  = sum_i P_ij dO_i
// in float32; 0 for a row whose keys are all padded (lse = +inf) and for
// padded keys. Only keys are masked, so every query row equals the plain
// version (ops/flash_mha.py:flash_mha_bwd_plain). No atomics: a rerun is the
// same bit for bit.
//
// The arithmetic is the D = 128 kernels' (csrc/flash_mha_bwd.cu): 3xTF32
// products (lo*hi, hi*lo, hi*hi; S and dP also lo*lo) on K-major operands
// (tf32_wgmma.cuh), the resident rows raw and split into hi and lo in
// registers, the streamed 32-row tiles by TMA through a two-stage ring and
// split in place, two consumer warpgroups (the first S, the second dP),
// short wgmma chains summed in software, the third products taken
// transposed; the block and its helpers are csrc/tf32_flash_bwd.cuh's,
// shared with them. What does not carry over is shared memory: those
// kernels take 230,688 and 230,928 bytes at D = 128, and every operand
// doubles at 256.
//
// Design: a cluster of kHeadChunks = D / 128 blocks for each 64 resident
// rows, one block per 128-column chunk of the head dim. Block r (its rank in
// the cluster) holds columns [128 r, 128 r + 128) of the resident rows and
// streams the same columns of each tile, so every block has the D = 128
// kernels' shared memory plan. It forms a *partial* S and dP over its
// columns (a 64 x 32 tile each), publishes them in its shared memory, and
// after a cluster barrier reads the other blocks' partials through
// distributed shared memory (mapa, ld.shared::cluster). Every block adds the
// partials in rank order, so all of them form the same S and dP, hence the
// same P and dS bits, and each accumulates its own 128 columns of dq (or of
// dk and dv). No S or dP is recomputed: a block does the D = 128 kernel's
// work plus the exchange, two cluster barriers a tile (partials published;
// partials read), each split into its arrival and its wait so that the
// next tile's split and P's staging run while it completes. The exchange
// buffer is the staged dS tile's space, free while the partials are in
// flight.
//
// Δ and the one-valid-key row. Where a query row has one valid key j, out_i
// is v_j exactly and dP_ij - Δ_i is 0 in exact arithmetic; any difference in
// rounding between dP and Δ leaves a dS that dk_j sums over every query.
// So the dQ kernel forms Δ with dP's own arithmetic: the block's out rows go
// through the stream once, as a tile of B operands, Δ_i is the diagonal of
// dO out^T formed exactly as dP (the same chains, products and partials),
// and the dK/dV kernel, which forms dP^T = V dO^T with the operands' roles
// swapped, adds its four products' chains in the order that gives the same
// sum as dQ's (rows_product<true>). With those, dS is exactly 0 there.
//
// Shared memory (bytes; tiles 1024-aligned for the 128-byte swizzle):
//   dQ     Q, dO 2 x 32,768; 2 stages of K, V ([hi; lo], 131,072); dS hi,
//          lo 16,384 (the exchange before it); P 8,192; Δ of the rows; 3
//          mbarriers; key words; the key bits of 2048 tiles 8,192; slack:
//          230,688
//   dK/dV  K, V 2 x 32,768; 2 stages of Q, dO 131,072; P^T hi, lo 16,384;
//          dS^T hi, lo 16,384 (the exchange before it); lse and Δ of each
//          stage's queries 512; 2 mbarriers; slack: 230,928
// 256 threads a block, one block an SM, blocks in clusters of kHeadChunks
// (__cluster_dims__). D = 384 and 512 would be kHeadChunks = 3 and 4 with
// the same block; only D = 256 is built.
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 256) float32,
// contiguous, 16-byte aligned; mask (B, T) bytes, nonzero at padded keys;
// lse and delta (B, H, T) float32.

#include <math_constants.h>

#include "tf32_flash_bwd.cuh"

namespace {

using namespace tf32_bwd;

constexpr int kHeadChunks = 2;               // blocks of a cluster
constexpr int kD = kHeadChunks * kCols;      // head dim
// dQ: dS hi, lo (first the exchange: partial S, partial dP); P raw; Δ of
// the rows; the ring's two mbarriers and the out rows' one; the key words;
// the key bits of the first kMapTiles key tiles.
constexpr uint32_t kDqOffX = kOffAcc;
constexpr uint32_t kDqOffP = kOffAcc + 2 * kAccPart;
constexpr uint32_t kDqOffDelta = kDqOffP + kRows * kTile * 4;
constexpr uint32_t kDqOffBar = kDqOffDelta + kRows * 4;
constexpr uint32_t kDqOffWords = kDqOffBar + 3 * 8;
constexpr uint32_t kDqOffMap = kDqOffWords + 8;
constexpr size_t kDqSmemBytes = kDqOffMap + kMapTiles * 4 + 1024;
// dK/dV: the exchange in the space of dS^T hi, lo.
constexpr uint32_t kDkvOffX = kOffAcc + 2 * kAccPart;
static_assert(kDqSmemBytes <= 232448,
              "more shared memory than a block may use");

// This block's partial x (m64n32 layout) into its exchange buffer `mine`,
// where the cluster's other blocks read it: one float4 a column quarter.
__device__ __forceinline__ void publish(uint8_t* mine, const float (&x)[16],
                                        int wtid) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(mine + (i * kWarpgroup + wtid) * 16) =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// x = the sum of the cluster's partials, rank 0's first: this block's own
// from registers, the others' from their exchange buffers at shared address
// `mine` (the same offset in every block), after a cluster barrier.
__device__ __forceinline__ void gather(float (&x)[16], uint32_t mine,
                                       uint32_t rank, int wtid) {
  float sum[16];
#pragma unroll
  for (int r = 0; r < kHeadChunks; ++r) {
    float p[16];
    if (r == (int)rank) {
#pragma unroll
      for (int c = 0; c < 16; ++c) p[c] = x[c];
    } else {
      const uint32_t peer = peer_addr(mine, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 y = ld_cluster4(peer + (i * kWarpgroup + wtid) * 16);
        p[4 * i] = y.x;
        p[4 * i + 1] = y.y;
        p[4 * i + 2] = y.z;
        p[4 * i + 3] = y.w;
      }
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) sum[c] = r == 0 ? p[c] : sum[c] + p[c];
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) x[c] = sum[c];
}

// ---------------------------------------------------------------------------
// The dQ kernel.

__global__ void __cluster_dims__(kHeadChunks, 1, 1)
    __launch_bounds__(kThreads, 1)
flash_mha_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_out,
                             const float* __restrict__ q,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             float* __restrict__ dq, int n_head, int t_len,
                             float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kDqOffBar;
  volatile uint32_t* words = reinterpret_cast<uint32_t*>(smem + kDqOffWords);
  float* p_raw = reinterpret_cast<float*>(smem + kDqOffP);
  float* delta_s = reinterpret_cast<float*>(smem + kDqOffDelta);

  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;     // 0: S and P; 1: dP and dS
  const int wtid = tid % kWarpgroup;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t rank = cluster_rank();
  const int col0 = kCols * rank;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = (blockIdx.x / kHeadChunks) * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  uint8_t* xs = smem + kDqOffX + wg * kAccPart;  // this warpgroup's partial
  const uint32_t xs_addr = base + kDqOffX + wg * kAccPart;

  uint32_t* map = reinterpret_cast<uint32_t*>(smem + kDqOffMap);
  const int n_map = min((t_len + kTile - 1) / kTile, kMapTiles);
  for (int i = tid; i < n_map; i += kThreads)
    map[i] = tile_bits(mrow, t_len, i);
  if (tid == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(loaded_bar(bars, s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  int tile = -1;
  if (warp == 0) {
    // The block's out rows, as the two tiles of stage 1 (for Δ), then the
    // first key tile into stage 0.
    if (lane == 0)
      load_stage(&tm_out, q0, &tm_out, q0 + kTile, col0, bh,
                 base + kOffStage + kStage, loaded_bar(bars, 2));
    __syncwarp();
    tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, col0, bh, tile, 0, base,
                         bars, words, map);
  }

  uint8_t* qs = smem + kOffRes;
  uint8_t* dos = qs + kResTile;
  load_resident<kD>(qs, q + head * kD, q0, col0, t_len);
  load_resident<kD>(dos, dout + head * kD, q0, col0, t_len);
  __syncthreads();
  mbar_wait(loaded_bar(bars, 2), 0);
  split_stage<kThreads>(smem + kOffStage + kStage, tid);
  __syncthreads();

  // The wgmma accumulators, defined once here (each chain's first wgmma
  // ignores their value), and the running dq^T of this warpgroup's 64
  // columns (rows: columns col0 + 64 wg + m; columns: the block's rows).
  float dqt[32], fresh[32], hi[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqt[i] = fresh[i] = hi[i] = lo[i] = 0.f;
  float x[16];

  // Δ: warpgroup w forms dO out^T against out rows [32 w, 32 w + 32) as dP
  // is formed, and keeps its diagonal (row 32 w + c, column c). Rows past
  // T have dO = 0 and out = 0: Δ = 0.
  rows_product<false>(x, hi, lo, dos,
                      base + kOffStage + kStage + wg * kStTile);
  publish(xs, x, wtid);
  cluster_sync();
  gather(x, xs_addr, rank, wtid);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * (warp & 3) + g + 8 * h;
        if (r != 8 * j + 2 * t4 + e + kTile * wg) continue;
        delta_s[r] = x[4 * j + 2 * h + e];
        if (rank == 0 && q0 + r < t_len)
          delta[head + q0 + r] = x[4 * j + 2 * h + e];
      }
  cluster_sync();  // Δ in delta_s; the other blocks read these partials
  // This thread's rows: 16 (warp % 4) + g + 8h.
  float lse_r[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * (warp & 3) + g + 8 * h;
    lse_r[h] = q0 + r < t_len ? lse[head + q0 + r] : CUDART_INF_F;
    dlt[h] = delta_s[r];
  }
  uint8_t* ds_st = smem + kOffAcc;

  // The first tile is split by all threads; every later one by warpgroup
  // 1 in the tile before it, while warpgroup 0 forms P.
  mbar_wait(loaded_bar(bars, 0), 0);
  if (words[0] != 0) split_stage<kThreads>(smem + kOffStage, tid);

  for (int n = 0;; ++n) {
    const int s = n & 1;
    mbar_wait(loaded_bar(bars, s), (n >> 1) & 1);
    const uint32_t keys = words[s];
    if (keys == 0) break;  // the end (the same tile in every block)
    uint8_t* stage = smem + kOffStage + s * kStage;
    // Every thread is past tile n - 1: stage s ^ 1, the staged dS and P
    // (and so the exchange) are free, and tile n is split.
    __syncthreads();
    if (warp == 0)
      tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, col0, bh, tile, s ^ 1,
                           base, bars, words, map);
    // Partial S = Q K^T (warpgroup 0) or dP = dO V^T (1) over the block's
    // columns, then the cluster's sum.
    rows_product<false>(x, hi, lo, wg == 0 ? qs : dos,
                        base + kOffStage + s * kStage + wg * kStTile);
    publish(xs, x, wtid);
    cluster_arrive();  // this block's partials published
    if (wg == 1) {     // tile n + 1 split while the barrier completes
      mbar_wait(loaded_bar(bars, s ^ 1), ((n + 1) >> 1) & 1);
      if (words[s ^ 1] != 0)
        split_stage<kWarpgroup>(smem + kOffStage + (s ^ 1) * kStage, wtid);
    }
    cluster_wait();    // every block's partials published
    gather(x, xs_addr, rank, wtid);
    cluster_arrive();  // this block done reading the others' partials
    if (wg == 0) {
      // P at (row 16 (warp % 4) + g + 8h, key 8j + 2 t4 + e).
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 4 * j + 2 * h + e;
            p_raw[c * kWarpgroup + wtid] =
                (keys >> (8 * j + 2 * t4 + e)) & 1u
                    ? expf(x[c] * sm_scale - lse_r[h]) : 0.f;
          }
    }
    __syncthreads();  // P written, tile n + 1 split
    cluster_wait();   // every block done reading this block's partials
    if (wg == 1) {
#pragma unroll
      for (int c = 0; c < 16; ++c)
        x[c] = p_raw[c * kWarpgroup + wtid] * (x[c] - dlt[(c >> 1) & 1]);
      stage_parts(ds_st, x);
      fence_proxy_async();
    }
    __syncthreads();  // dS staged
    cols_product(dqt, fresh, stage, wg, base + kOffAcc);  // K^T dS^T
  }
  store_transposed<kD>(dq + head * kD, dqt, wg, col0, q0, t_len, sm_scale);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel.

__global__ void __cluster_dims__(kHeadChunks, 1, 1)
    __launch_bounds__(kThreads, 1)
flash_mha_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kDkvOffBar;
  float* stats = reinterpret_cast<float*>(smem + kDkvOffStats);

  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;     // 0: S^T and P^T; 1: dP^T and dS^T
  const int wtid = tid % kWarpgroup;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t rank = cluster_rank();
  const int col0 = kCols * rank;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int k0 = (blockIdx.x / kHeadChunks) * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  // A block whose keys are all padded (every block of its cluster with it):
  // its columns of dk and dv are 0 there.
  const bool live = tid < kRows && k0 + tid < t_len && mrow[k0 + tid] == 0;
  if (!__syncthreads_or(live)) {
    for (int f = tid; f < kRows * kCols / 4; f += kThreads) {
      const int r = k0 + (f >> 5);
      if (r >= t_len) continue;
      const int64_t off = (head + r) * kD + col0 + 4 * (f & 31);
      *reinterpret_cast<float4*>(dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const int n_tiles = (t_len + kTile - 1) / kTile;
  if (tid == 0) {
    mbar_init(loaded_bar(bars, 0), 1);
    mbar_init(loaded_bar(bars, 1), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0)
    load_query_tile(&tm_q, &tm_do, lse, delta, t_len, col0, bh, 0, 0, base,
                    bars);

  uint8_t* ks = smem + kOffRes;
  uint8_t* vs = ks + kResTile;
  load_resident<kD>(ks, k + head * kD, k0, col0, t_len);
  load_resident<kD>(vs, v + head * kD, k0, col0, t_len);
  // This thread's keys: 16 (warp % 4) + g + 8h.
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * (warp & 3) + g + 8 * h;
    valid[h] = key < t_len && mrow[key] == 0;
  }
  __syncthreads();

  // Running dk^T and dv^T of this warpgroup's 64 columns (rows: columns
  // col0 + 64 wg + m; columns: the block's keys) and the wgmma
  // accumulators, defined once here.
  float dkt[32], dvt[32], fresh[32], hi[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dkt[i] = dvt[i] = fresh[i] = hi[i] = lo[i] = 0.f;
  uint8_t* p_st = smem + kOffAcc;            // P^T hi, lo
  uint8_t* ds_st = p_st + 2 * kAccPart;      // dS^T hi, lo
  uint8_t* xs = smem + kDkvOffX + wg * kAccPart;  // the exchange
  const uint32_t xs_addr = base + kDkvOffX + wg * kAccPart;

  // The first tile is split by all threads; every later one by warpgroup
  // 1 in the tile before it, while warpgroup 0 forms P^T.
  mbar_wait(loaded_bar(bars, 0), 0);
  split_stage<kThreads>(smem + kOffStage, tid);

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n & 1;
    mbar_wait(loaded_bar(bars, s), (n >> 1) & 1);
    uint8_t* stage = smem + kOffStage + s * kStage;
    // Every thread is past tile n - 1: stage s ^ 1, its row stats, the
    // staged P^T and dS^T (and so the exchange) are free, and tile n is
    // split.
    __syncthreads();
    if (warp == 0 && n + 1 < n_tiles)
      load_query_tile(&tm_q, &tm_do, lse, delta, t_len, col0, bh, n + 1,
                      s ^ 1, base, bars);
    const float* lse_s = stats + s * 2 * kTile;
    const float* dlt_s = lse_s + kTile;
    // Partial S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), then the
    // cluster's sum.
    float x[16];
    rows_product<true>(x, hi, lo, wg == 0 ? ks : vs,
                       base + kOffStage + s * kStage + wg * kStTile);
    publish(xs, x, wtid);
    cluster_arrive();  // this block's partials published
    if (wg == 1 && n + 1 < n_tiles) {  // split while the barrier completes
      mbar_wait(loaded_bar(bars, s ^ 1), ((n + 1) >> 1) & 1);
      split_stage<kWarpgroup>(smem + kOffStage + (s ^ 1) * kStage, wtid);
    }
    cluster_wait();    // every block's partials published
    gather(x, xs_addr, rank, wtid);
    cluster_arrive();  // this block done reading the others' partials
    if (wg == 0) {
      // P^T at (key 16 (warp % 4) + g + 8h, query 8j + 2 t4 + e).
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = lse_s[8 * j + 2 * t4 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 4 * j + 2 * h + e;
            x[c] = valid[h] ? expf(x[c] * sm_scale - l) : 0.f;
          }
        }
      stage_parts(p_st, x);
      fence_proxy_async();
    }
    __syncthreads();  // P^T staged, tile n + 1 split
    cluster_wait();   // every block done reading this block's partials
    if (wg == 1) {
      float p[16];
      read_staged(p, p_st);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = dlt_s[8 * j + 2 * t4 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 4 * j + 2 * h + e;
            x[c] = p[c] * (x[c] - d);
          }
        }
      stage_parts(ds_st, x);
      fence_proxy_async();
    }
    cols_product(dvt, fresh, stage + kStTile, wg, base + kOffAcc);  // dO^T P
    __syncthreads();  // dS^T staged
    cols_product(dkt, fresh, stage, wg,
                 base + kOffAcc + 2 * kAccPart);                    // Q^T dS
  }
  store_transposed<kD>(dk + head * kD, dkt, wg, col0, k0, t_len, sm_scale);
  store_transposed<kD>(dv + head * kD, dvt, wg, col0, k0, t_len, 1.f);
}

}  // namespace

// The dQ kernel; also writes delta (B, H, T) = rowsum(dout * out) for the
// dK/dV kernel. Returns cudaGetLastError() after the launch (0 on success;
// a refused cluster launch is its error), or the code of
// sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_bwd_dq_f32_d256(const float* q, const float* k,
                                         const float* v, const uint8_t* mask,
                                         const float* out, const float* dout,
                                         const float* lse, float* delta,
                                         float* dq, int batch, int n_head,
                                         int t_len, float sm_scale,
                                         void* stream) {
  // The runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward in its own), which the driver's
  // tensor-map encoder needs.
  int err = set_smem(flash_mha_bwd_dq_d256_kernel, kDqSmemBytes);
  CUtensorMap tm_k, tm_v, tm_out;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0) err = make_tensor_map_f32(&tm_k, k, heads, t_len, kD, kTile);
  if (err == 0) err = make_tensor_map_f32(&tm_v, v, heads, t_len, kD, kTile);
  if (err == 0)
    err = make_tensor_map_f32(&tm_out, out, heads, t_len, kD, kTile);
  if (err != 0) return err;
  const dim3 grid(kHeadChunks * ((t_len + kRows - 1) / kRows), n_head, batch);
  flash_mha_bwd_dq_d256_kernel<<<grid, kThreads, kDqSmemBytes,
                                 (cudaStream_t)stream>>>(
      tm_k, tm_v, tm_out, q, mask, dout, lse, delta, dq, n_head, t_len,
      sm_scale);
  return (int)cudaGetLastError();
}

// The dK/dV kernel; reads the delta the dQ kernel wrote. Returns
// cudaGetLastError() after the launch (0 on success), or the code of
// sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_bwd_dkv_f32_d256(const float* q, const float* k,
                                          const float* v, const uint8_t* mask,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dk,
                                          float* dv, int batch, int n_head,
                                          int t_len, float sm_scale,
                                          void* stream) {
  int err = set_smem(flash_mha_bwd_dkv_d256_kernel, kDkvSmemBytes);  // see dQ
  CUtensorMap tm_q, tm_do;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0) err = make_tensor_map_f32(&tm_q, q, heads, t_len, kD, kTile);
  if (err == 0)
    err = make_tensor_map_f32(&tm_do, dout, heads, t_len, kD, kTile);
  if (err != 0) return err;
  const dim3 grid(kHeadChunks * ((t_len + kRows - 1) / kRows), n_head, batch);
  flash_mha_bwd_dkv_d256_kernel<<<grid, kThreads, kDkvSmemBytes,
                                  (cudaStream_t)stream>>>(
      tm_q, tm_do, k, v, mask, lse, delta, dk, dv, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block takes, in bytes: 0 the dQ kernel, 1 the
// dK/dV kernel (ptxas reports only static shared memory).
extern "C" int flash_mha_bwd_d256_smem_bytes(int kernel) {
  const size_t bytes[2] = {kDqSmemBytes, kDkvSmemBytes};
  return kernel >= 0 && kernel < 2 ? (int)bytes[kernel] : -1;
}

// Rows of a streamed tile: the dQ kernel's key tile (the unit in which it
// skips wholly padded keys) and the dK/dV kernel's query tile.
extern "C" int flash_mha_bwd_d256_key_tile() { return kTile; }

// Resident rows of a block: the dQ kernel's query rows and the dK/dV
// kernel's keys (the unit in which it writes zeros for padded keys).
extern "C" int flash_mha_bwd_d256_block_rows() { return kRows; }

// Blocks of a cluster: the 128-column chunks of the head dim.
extern "C" int flash_mha_bwd_d256_cluster() { return kHeadChunks; }
