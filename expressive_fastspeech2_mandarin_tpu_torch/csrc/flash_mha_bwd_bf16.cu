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
//   * the dQ kernel: a block per (b, h, query rows). It writes Δ for its
//     rows, then streams the 64-key tiles with a valid key, recomputing S,
//     dP, P and dS, and accumulates dq;
//   * the dK/dV kernel, launched after it on the same stream: a block per
//     (b, h, keys). A block whose keys are all padded writes zeros and
//     exits; the others stream every 64-query tile (padded queries too: they
//     have dO and count for dk, dv), reading the Δ the dQ kernel wrote, and
//     accumulate dk and dv.
//
// What bounds it: operations. The pair recomputes S and dP in both kernels
// and forms dq, dk and dv: 14*B*H*T^2*D flops over the live tiles against
// ~20*B*H*T*D bytes of bf16 and 8*B*H*T of float32 statistics, T/1.4 flops
// a byte. The card's floor is those flops at the bf16 rate, 989 TF/s. On
// the way there stand the chain within a tile (S and dP, then the exps on
// the CUDA cores, then the third products: nothing of one warpgroup
// overlaps), the latency of the streamed tiles, and a grid too small for
// the card at T = 1000, B = 4 (128 dQ blocks, 80 live dK/dV blocks).
//
// Design (a block: three warpgroups, 384 threads; one block an SM):
//   * warp specialisation: warpgroup 0 is the producer. It gives its
//     registers up (setmaxnreg to kProducerRegs), and one warp of it issues
//     the streamed tiles by TMA into a ring of stages (6 in dQ, 4 in dK/dV,
//     as shared memory allows) with a full and an empty mbarrier each.
//     Warpgroups 1 and 2 are consumers (setmaxnreg to kConsumerRegs). They
//     share the block's 64 resident rows and take the streamed tiles in
//     turn: stream slot n (the n-th streamed tile) lies in stage
//     n % stages and belongs to consumer n % 2, so a block's tiles run
//     twice as fast, one consumer's exps overlap the other's wgmma, and
//     the small grids get two warpgroups of work an SM. A consumer frees a
//     stage by one arrival a warp on its empty barrier: no block barrier
//     stands in the loop;
//   * each consumer sums its tiles' products in its own float32
//     accumulators (wgmma chains: the tensor cores' truncation adds up to
//     ~1e-5 relative over 8192 keys, far below bf16's 2^-9); at the end
//     consumer 1 writes its sums to shared memory (its own stages, which
//     nothing loads into any more) and consumer 0 adds them to its own, in
//     that order: even-slot sum + odd-slot sum, rounded to bf16. A fixed
//     order, so a rerun is bit-identical;
//   * the resident rows (Q and dO for dQ; K and V for dK/dV) are the A
//     operand of S and dP (S^T and dP^T in dK/dV) from swizzled shared
//     memory; the streamed tile is their K-major B operand as TMA lands it
//     (bf16_wgmma.cuh). The third products take the streamed tile as an
//     MN-major B operand (the transpose bit): dq += dS K, dk += dS^T Q and
//     dv += P^T dO, with dS, dS^T and P^T rounded to bf16 from the
//     accumulator registers straight into A fragments. No staging through
//     shared memory, no transposed copy;
//   * the tensor-core work of a consumer runs back to back across its
//     tiles: in dQ it issues S and dP of its next slot behind dS K of this
//     one; in dK/dV (dk and dv hold 128 registers a thread) dv += P^T dO
//     goes in before dS^T is formed, dk after it, and S^T of the next slot
//     behind dk. After the last tile the consumer takes an end slot, whose
//     stale stage it reads into products it drops: no wgmma stands under a
//     branch, which would make ptxas serialize them;
//   * P = 2^(s·scale·log2e − lse·log2e) by ex2.approx, the argument one fma
//     (relative error ~2^-22, far below bf16's 2^-9); a padded key adds
//     -inf to the exponent, so no branch writes an accumulator register;
//   * dQ streams only the key tiles with a valid key: the producer scans
//     the mask (two ballots a tile) and writes each slot's tile and key
//     bits beside the stage. Wholly padded tiles are skipped (exact: they
//     add exp(-inf) = 0). In dK/dV the producer's lanes bring each query
//     tile's lse and Δ by cp.async, 4 bytes a lane (head*T + q0 is not
//     16-byte aligned for every T), counted on the stage's full barrier;
//     past T they read as 0, where Q and dO are 0, so those queries add
//     exactly 0;
//   * grid order: blocks go out x fastest (query or key rows), then heads,
//     then batch rows, so the rows come in the mask's order. Every live
//     dK/dV block streams every query tile, so those blocks are equal; a
//     dQ block's length is its row's live key tiles, which only the card
//     knows (reordering by it would need a plan in device memory that the
//     wrapper does not provide);
//   * ragged T needs no padding; offsets are 64-bit.
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
constexpr int kRows = kTileRows;               // resident rows a consumer
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = (1 + kConsumers) * kWarpgroup;
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kProducerRegs = 24;              // setmaxnreg, per thread
constexpr int kConsumerRegs = 240;
static_assert(kWarpgroup * (kProducerRegs + kConsumers * kConsumerRegs) <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "setmaxnreg asks for more registers than the launch holds");
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kStage = 2 * kTile;         // two streamed tiles
static_assert(kRows * kD * 4 <= kStage, "a stage must hold an accumulator");

// dQ: each stage's slot header, the streamed tile and its key bits.
struct alignas(16) SlotHead {
  int tile;
  int pad;
  uint64_t bits;
};

// Where a kernel's parts lie in shared memory: two resident tiles, a ring
// of kStages stages of two streamed tiles, then per stage kRingBytes of
// the kernel's own (dQ: slot headers; dK/dV: lse and Δ of the queries),
// kExtra bytes (dQ: Δ of the block's rows), the full and empty barriers.
template <int kStages_, uint32_t kRingBytes, uint32_t kExtra>
struct Layout {
  static constexpr int kStages = kStages_;
  static_assert(kStages % kConsumers == 0,
                "each stage must belong to one consumer");
  static constexpr uint32_t kOffRes = 0;
  static constexpr uint32_t kOffStage = 2 * kTile;
  static constexpr uint32_t kOffRing = kOffStage + kStages * kStage;
  static constexpr uint32_t kOffExtra = kOffRing + kStages * kRingBytes;
  static constexpr uint32_t kOffBar = kOffExtra + kExtra;
  static constexpr size_t kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

  static __device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
    return bars + 8 * s;
  }
  static __device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
    return bars + 8 * (kStages + s);
  }
  // Thread 0: each stage's full barrier waits for the producer's one
  // arrival (and the bytes it announces), its empty barrier for the four
  // warps of the consumer it belongs to.
  static __device__ __forceinline__ void init(uint32_t bars) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), 4);
    }
    mbar_init_fence();
  }
  // A consumer warp is done with stage s (its wgmma have completed).
  static __device__ __forceinline__ void release(uint32_t bars, int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar(bars, s));
  }
};

// The two kernels' layouts: as many stages as shared memory holds.
using DqL = Layout<6, sizeof(SlotHead), kRows * 4>;
using DkvL = Layout<4, 2 * kTileRows * 4, 0>;

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& base) {
  const uint32_t addr = smem_addr(raw);
  base = (addr + 1023u) & ~1023u;
  return raw + (base - addr);
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

// exp(x) for P as ex2.approx of x log2(e), the argument formed by one fma
// from log2(e)-scaled factors (relative error ~2^-22, far below bf16's
// 2^-9; the layout witness's P = 1/2 still rounds to 1/2 in bf16).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + 64) of one head's (T, 128) matrix, zero past T, into the
// tile at `dst` as TMA lands it, by the consumers (thread `ct` of 256).
__device__ __forceinline__ void load_resident(uint8_t* dst, const bf16* src,
                                              int r0, int t_len, int ct) {
  for (int f = ct; f < kTileRows * 16; f += kConsumerThreads) {
    const int r = f >> 4, c = f & 15;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * kD +
                                          8 * c);
    *reinterpret_cast<uint4*>(dst + tile16_offset(r, c)) = x;
  }
}

// Consumer 1 hands its accumulators acc[2][32] to consumer 0 through the
// float32 buffer `x` (64 x 128, one float a thread and register, in
// register order): put by consumer 1, added by consumer 0 to its own in
// that order (even slots + odd slots). `wt` is the thread in its
// warpgroup.
__device__ __forceinline__ void put_partial(float* x, const float (&acc)[2][32],
                                            int wt) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[(32 * half + i) * kWarpgroup + wt] = acc[half][i];
}

__device__ __forceinline__ void add_partial(float (&acc)[2][32], const float* x,
                                            int wt) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[half][i] += x[(32 * half + i) * kWarpgroup + wt];
}

// Rows [r0, r0 + 64) of a (T, 128) bf16 output from the accumulator pair
// acc[half] (row 16w + g + 8h, column 64 half + 8j + 2t + e, w the warp of
// thread `wt` in its warpgroup); rows past T are not stored.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[2][32],
                                           int r0, int t_len, int wt) {
  const int warp = wt >> 5, lane = wt & 31;
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

// The producer's warp: every key tile with a valid key, by TMA (K and V)
// into the slots in turn, each slot's tile and key bits in its header; then
// an end slot (tile = n_tiles, no copy) for each consumer.
__device__ __forceinline__ void dq_producer(const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v,
                                            const uint8_t* mrow, int t_len,
                                            int bh, uint32_t base,
                                            SlotHead* heads) {
  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;
  const uint32_t bars = base + DqL::kOffBar;
  uint64_t bits;
  int tile = next_live_tile(mrow, t_len, 0, bits);
  int n = 0;
  for (; tile < n_tiles; ++n) {
    const int s = n % DqL::kStages;
    mbar_wait(DqL::empty_bar(bars, s), ((n / DqL::kStages) & 1) ^ 1);
    if ((threadIdx.x & 31) == 0) {
      heads[s].tile = tile;
      heads[s].bits = bits;
      load_tile_pair(tm_k, tm_v, tile, bh, base + DqL::kOffStage + s * kStage,
                     DqL::full_bar(bars, s));
    }
    __syncwarp();
    tile = next_live_tile(mrow, t_len, tile + 1, bits);
  }
  for (const int end = n + kConsumers; n < end; ++n) {
    const int s = n % DqL::kStages;
    mbar_wait(DqL::empty_bar(bars, s), ((n / DqL::kStages) & 1) ^ 1);
    if ((threadIdx.x & 31) == 0) {
      heads[s].tile = n_tiles;
      mbar_arrive(DqL::full_bar(bars, s));
    }
    __syncwarp();
  }
}

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
  const uint32_t bars = base + DqL::kOffBar;
  SlotHead* heads = reinterpret_cast<SlotHead*>(smem + DqL::kOffRing);
  float* delta_s = reinterpret_cast<float*>(smem + DqL::kOffExtra);

  const int tid = threadIdx.x;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;

  if (tid == 0) DqL::init(bars);
  __syncthreads();
  if (tid < kWarpgroup) {
    producer_regs();
    if (tid < 32) dq_producer(&tm_k, &tm_v, mrow, t_len, bh, base, heads);
    return;
  }
  consumer_regs();
  const int ct = tid - kWarpgroup;             // thread among the consumers
  const int c = ct / kWarpgroup;               // consumer 0 or 1
  const int wt = ct % kWarpgroup;              // thread in its warpgroup
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  load_resident(smem + DqL::kOffRes, q + head * kD, q0, t_len, ct);
  load_resident(smem + DqL::kOffRes + kTile, dout + head * kD, q0, t_len, ct);
  // Δ of the block's rows in float32 from the bf16 out and dO, 8 rows a
  // warp (32 lanes x 4 dims); rows past T get 0 (their P is 0).
  for (int i = 0; i < kRows / 8; ++i) {
    const int r = 8 * (ct >> 5) + i;
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
  named_sync<1, kConsumerThreads>();
  // This thread's rows: 16 warp + g + 8h; their lse in log2 units.
  const float scale2 = sm_scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    lse2[h] = (q0 + r < t_len ? lse[head + q0 + r] : CUDART_INF_F) * kLog2e;
    dlt[h] = delta_s[r];
  }

  float acc_dq[2][32], sc[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc_dq[0][i] = acc_dq[1][i] = sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    da[kk][0] = da[kk][1] = da[kk][2] = da[kk][3] = 0u;

  // This consumer's slots: n = c, c + 2, ... S and dP of a slot go in as
  // soon as it has landed; for an end slot they read its stage's stale
  // rows and are dropped.
  int n = c, s = n % DqL::kStages;
  mbar_wait(DqL::full_bar(bars, s), (n / DqL::kStages) & 1);
  int tile = heads[s].tile;
  uint64_t bits = heads[s].bits;
  uint32_t kst = base + DqL::kOffStage + s * kStage;
  wgmma_fence();
  rows_product(sc, base + DqL::kOffRes, kst);                // Q K^T
  rows_product(dp, base + DqL::kOffRes + kTile, kst + kTile);  // dO V^T
  wgmma_commit();
  for (int i = 0; tile < n_tiles; ++i) {
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    // dS at (row 16 warp + g + 8h, key 8j + 2 t4 + e), scaled, in float32.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      const int key = 8 * (e >> 2) + 2 * t4 + (e & 1);
      const float p = (bits >> key) & 1u
                          ? exp2_approx(fmaf(sc[e], scale2, -lse2[h]))
                          : 0.f;
      dp[e] = (dp[e] - dlt[h]) * p * sm_scale;
    }
    accumulator_to_a(da, dp);
    wgmma_fence();
    cols_product(acc_dq, da, kst, i > 0);                    // dS K
    wgmma_commit();
    // S and dP of this consumer's next slot go in behind dS K.
    const int n_next = n + kConsumers, s_next = n_next % DqL::kStages;
    mbar_wait(DqL::full_bar(bars, s_next), (n_next / DqL::kStages) & 1);
    const int next = heads[s_next].tile;
    const uint64_t next_bits = heads[s_next].bits;
    const uint32_t kst_next = base + DqL::kOffStage + s_next * kStage;
    wgmma_fence();
    rows_product(sc, base + DqL::kOffRes, kst_next);
    rows_product(dp, base + DqL::kOffRes + kTile, kst_next + kTile);
    wgmma_commit();
    wgmma_wait<1>();  // dS K done: stage s is free
    fence_operands(acc_dq[0]);
    fence_operands(acc_dq[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(da[kk]);
    DqL::release(bars, s);
    n = n_next;
    s = s_next;
    tile = next;
    bits = next_bits;
    kst = kst_next;
  }
  wgmma_wait<0>();  // the end slot's dropped S and dP
  fence_operands(sc);
  fence_operands(dp);
  // Consumer 1's stage 1 is its own and no longer loaded into.
  float* partial = reinterpret_cast<float*>(smem + DqL::kOffStage + kStage);
  if (c == 1) {
    put_partial(partial, acc_dq, wt);
    named_sync<2, kConsumerThreads>();
  } else {
    named_sync<2, kConsumerThreads>();
    add_partial(acc_dq, partial, wt);
    store_rows(dq + head * kD, acc_dq, q0, t_len, wt);
  }
}

// ---------------------------------------------------------------------------
// The dK/dV kernel.

// The producer's warp: query tile n into its stage: its lse and Δ by the
// lanes with cp.async (0 past T, where Q and dO read as 0 too, so those
// queries add exactly 0) beside the stage, counted on the stage's full
// barrier; Q and dO by TMA (lane 0). Then an end slot for each consumer.
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_do,
                                             const float* lse,
                                             const float* delta, int t_len,
                                             int bh, uint32_t base) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;
  const uint32_t bars = base + DkvL::kOffBar;
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % DkvL::kStages;
    const uint32_t bar = DkvL::full_bar(bars, s);
    mbar_wait(DkvL::empty_bar(bars, s), ((n / DkvL::kStages) & 1) ^ 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n * kTileRows + 32 * half + lane;
      const bool in = row < t_len;
      const int64_t r = (int64_t)bh * t_len + (in ? row : 0);
      const uint32_t dst = base + DkvL::kOffRing +
                           (s * 2 * kTileRows + 32 * half + lane) * 4;
      cp_async4(dst, lse + r, in ? 4 : 0);
      cp_async4(dst + kTileRows * 4, delta + r, in ? 4 : 0);
    }
    cp_async_mbar_arrive(bar);
    __syncwarp();
    if (lane == 0)
      load_tile_pair(tm_q, tm_do, n, bh, base + DkvL::kOffStage + s * kStage,
                     bar);
    __syncwarp();
  }
  for (int n = n_tiles; n < n_tiles + kConsumers; ++n) {
    const int s = n % DkvL::kStages;
    mbar_wait(DkvL::empty_bar(bars, s), ((n / DkvL::kStages) & 1) ^ 1);
    if (lane == 0) mbar_arrive(DkvL::full_bar(bars, s));
    __syncwarp();
  }
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
  const uint32_t bars = base + DkvL::kOffBar;
  const float* stats = reinterpret_cast<const float*>(smem + DkvL::kOffRing);

  const int tid = threadIdx.x;
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
  if (tid == 0) DkvL::init(bars);
  __syncthreads();
  if (tid < kWarpgroup) {
    producer_regs();
    if (tid < 32) dkv_producer(&tm_q, &tm_do, lse, delta, t_len, bh, base);
    return;
  }
  consumer_regs();
  const int ct = tid - kWarpgroup;
  const int c = ct / kWarpgroup;
  const int wt = ct % kWarpgroup;
  const int warp = wt >> 5, lane = tid & 31;
  const int t4 = lane & 3;

  load_resident(smem + DkvL::kOffRes, k + head * kD, k0, t_len, ct);
  load_resident(smem + DkvL::kOffRes + kTile, v + head * kD, k0, t_len, ct);
  // This thread's keys: 16 warp + g + 8h; -inf added to the exponent of a
  // padded key's P makes it 0 (no branch: a wgmma accumulator written
  // under one makes ptxas serialize the wgmma).
  float kill[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + (lane >> 2) + 8 * h;
    kill[h] = key < t_len && mrow[key] == 0 ? 0.f : -CUDART_INF_F;
  }
  fence_proxy_async();
  named_sync<1, kConsumerThreads>();
  const float scale2 = sm_scale * kLog2e;

  float acc_dk[2][32], acc_dv[2][32], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc_dk[0][i] = acc_dk[1][i] = acc_dv[0][i] = acc_dv[1][i] = sc[i] =
        dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = da[kk][r] = 0u;

  // This consumer's query tiles: n = c, c + 2, ...; S^T and dP^T of the
  // next go in behind dk and dv of this one (for an end slot they read its
  // stage's stale rows and are dropped).
  int n = c, s = n % DkvL::kStages;
  mbar_wait(DkvL::full_bar(bars, s), (n / DkvL::kStages) & 1);
  uint32_t qst = base + DkvL::kOffStage + s * kStage;
  wgmma_fence();
  rows_product(sc, base + DkvL::kOffRes, qst);                 // K Q^T
  rows_product(dp, base + DkvL::kOffRes + kTile, qst + kTile);  // V dO^T
  wgmma_commit();
  for (int i = 0; n < n_tiles; ++i) {
    const float* lse_s = stats + s * 2 * kTileRows;
    const float* dlt_s = lse_s + kTileRows;
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    // P^T at (key 16 warp + g + 8h, query 8j + 2 t4 + e), in place of S^T;
    // dv += P^T dO goes in while dS^T is formed.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      const int qi = 8 * (e >> 2) + 2 * t4 + (e & 1);
      sc[e] = exp2_approx(
          fmaf(sc[e], scale2, kill[h] - lse_s[qi] * kLog2e));
    }
    accumulator_to_a(pa, sc);
    wgmma_fence();
    cols_product(acc_dv, pa, qst + kTile, i > 0);            // P^T dO
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = 8 * (e >> 2) + 2 * t4 + (e & 1);
      dp[e] = (dp[e] - dlt_s[qi]) * sc[e] * sm_scale;
    }
    accumulator_to_a(da, dp);
    wgmma_fence();
    cols_product(acc_dk, da, qst, i > 0);                    // dS^T Q
    wgmma_commit();
    wgmma_wait<1>();  // dv done: P^T's registers are free
    fence_operands(acc_dv[0]);
    fence_operands(acc_dv[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
    // S^T of the next tile goes in behind dk (dP^T too would take more
    // registers than a consumer has, and ptxas would serialize the wgmma).
    const int n_next = n + kConsumers, s_next = n_next % DkvL::kStages;
    mbar_wait(DkvL::full_bar(bars, s_next), (n_next / DkvL::kStages) & 1);
    const uint32_t qst_next = base + DkvL::kOffStage + s_next * kStage;
    wgmma_fence();
    rows_product(sc, base + DkvL::kOffRes, qst_next);
    wgmma_commit();
    wgmma_wait<1>();  // dk done: stage s is free
    fence_operands(acc_dk[0]);
    fence_operands(acc_dk[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(da[kk]);
    DkvL::release(bars, s);
    wgmma_fence();
    rows_product(dp, base + DkvL::kOffRes + kTile, qst_next + kTile);
    wgmma_commit();
    n = n_next;
    s = s_next;
    qst = qst_next;
  }
  wgmma_wait<0>();  // the end slot's dropped S^T and dP^T
  fence_operands(sc);
  fence_operands(dp);
  // Consumer 1's stages 1 and 3 are its own and no longer loaded into.
  float* partial_dk = reinterpret_cast<float*>(smem + DkvL::kOffStage + kStage);
  float* partial_dv =
      reinterpret_cast<float*>(smem + DkvL::kOffStage + 3 * kStage);
  if (c == 1) {
    put_partial(partial_dk, acc_dk, wt);
    put_partial(partial_dv, acc_dv, wt);
    named_sync<2, kConsumerThreads>();
  } else {
    named_sync<2, kConsumerThreads>();
    add_partial(acc_dk, partial_dk, wt);
    add_partial(acc_dv, partial_dv, wt);
    store_rows(dk + head * kD, acc_dk, k0, t_len, wt);
    store_rows(dv + head * kD, acc_dv, k0, t_len, wt);
  }
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
  int err = set_smem(flash_mha_bwd_dq_bf16_kernel, DqL::kSmemBytes);
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0)
    err = make_tensor_map_bf16(&tm_k, k, heads, t_len, kD, kTileRows);
  if (err == 0)
    err = make_tensor_map_bf16(&tm_v, v, heads, t_len, kD, kTileRows);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dq_bf16_kernel<<<grid, kThreads, DqL::kSmemBytes,
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
  int err = set_smem(flash_mha_bwd_dkv_bf16_kernel, DkvL::kSmemBytes);  // see dQ
  CUtensorMap tm_q, tm_do;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0)
    err = make_tensor_map_bf16(&tm_q, q, heads, t_len, kD, kTileRows);
  if (err == 0)
    err = make_tensor_map_bf16(&tm_do, dout, heads, t_len, kD, kTileRows);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dkv_bf16_kernel<<<grid, kThreads, DkvL::kSmemBytes,
                                  (cudaStream_t)stream>>>(
      tm_q, tm_do, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of each kernel takes, in bytes (ptxas
// reports only static shared memory).
extern "C" int flash_mha_bwd_dq_bf16_smem_bytes() {
  return (int)DqL::kSmemBytes;
}
extern "C" int flash_mha_bwd_dkv_bf16_smem_bytes() {
  return (int)DkvL::kSmemBytes;
}

// Rows of a streamed tile (the dQ kernel's key tile, the unit in which it
// skips wholly padded keys; the dK/dV kernel's query tile) and resident
// rows of a block (the dK/dV kernel's keys, the unit in which it writes
// zeros for padded keys).
extern "C" int flash_mha_bwd_bf16_stream_tile() { return kTileRows; }
extern "C" int flash_mha_bwd_bf16_block_rows() { return kRows; }

// The blocks' shape: threads a block, consumer warpgroups (which take the
// streamed tiles in turn), the ring stages of each kernel, and the
// registers a thread that setmaxnreg gives the producer and the consumer
// warpgroups.
extern "C" int flash_mha_bwd_bf16_threads() { return kThreads; }
extern "C" int flash_mha_bwd_bf16_consumers() { return kConsumers; }
extern "C" int flash_mha_bwd_dq_bf16_stages() { return DqL::kStages; }
extern "C" int flash_mha_bwd_dkv_bf16_stages() { return DkvL::kStages; }
extern "C" int flash_mha_bwd_bf16_producer_regs() { return kProducerRegs; }
extern "C" int flash_mha_bwd_bf16_consumer_regs() { return kConsumerRegs; }
