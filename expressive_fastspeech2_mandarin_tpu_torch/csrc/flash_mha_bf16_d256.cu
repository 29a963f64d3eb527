// Masked multi-head attention at head dim 256 in bf16 (flash attention): the
// forward, the dQ kernel (with Δ) and the dK/dV kernel, written by hand for
// Hopper (sm_90a) on the bf16 tensor cores, with a plain C interface for
// ctypes.
//
// Replaces the bf16 instantiation at D = 256 of the TPU kernels behind
// expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py (flash_mha,
// :53): JAX 0.9.0's jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl (:589, pallas_call at :758), _flash_attention_bwd_dq
// (:1287, pallas_call at :1456) and _flash_attention_bwd_dkv (:941,
// pallas_call at :1121), which the JAX package's bf16 mixed-precision train
// step feeds bf16 q, k, v at one head of 256. They compute what the D = 128
// bf16 kernels compute (csrc/flash_mha_bf16.cu, csrc/flash_mha_bwd_bf16.cu,
// whose notes give the functions in full), at the same rounding points: S
// and dP from the bf16 operands into float32; the online softmax in float32
// on 64-key tiles; the unnormalised P rounded to bf16 before P V; P^T and
// dS·sm_scale rounded to bf16 before their products; float32 accumulators;
// out, dq, dk, dv stored in bf16, the log-sum-exp and Δ in float32. A row
// with no valid key gives 0 and lse +inf; wholly padded key tiles are
// skipped (exact: they add exp(-inf) = 0); no atomics, so a rerun is the
// same bit for bit. Only keys are masked, so every query row equals the
// plain versions (ops/flash_mha.py: flash_mha_blocked_plain on 64-key tiles,
// flash_mha_bwd_plain on bf16 inputs).
//
// What bounds them: operations, as at D = 128 (T/2 flops a byte in the
// forward, T/1.4 in the backward pair). The card's floor is the function's
// flops over the key tiles with a valid key at the bf16 rate, 989 TF/s: 4,
// 6 and 8·D per query and live key for the forward, dQ and dK/dV.
//
// Why the D = 128 design does not carry over: its consumers hold O and a
// fresh P V accumulator (64 + 64 registers a thread) or dk and dv (128), and
// these double at D = 256, past the 240 a consumer warpgroup gets; a 64-row
// tile at D = 256 is 32 KB, so its rings do not fit in 227 KB either.
//
// Design: the outputs' head dim is split in two halves of 128 columns; each
// half is formed by a consumer warpgroup that computes S (and dP) over the
// full 256 columns itself, so every consumer keeps the D = 128 kernels'
// registers. The two halves compute the same S with the same instructions on
// the same tiles, so their P and dS are the same bits, and LSE and Δ come
// from whole rows. The recomputation costs ~1.5x the forward's flops and
// ~1.6x the backward's.
//   * the forward splits the halves over the grid (blockIdx.x = 2 x row
//     block + half): a block is csrc/flash_mha_bf16.cu's (128 query rows,
//     a producer warpgroup and two consumer warpgroups of 64 rows that take
//     turns at the tensor cores), streaming each live key tile's K at full D
//     and V's half of the block. Only the blocks of half 0 store the LSE;
//   * the backward splits the halves inside the block: the block's 64
//     resident rows (Q and dO for dQ, K and V for dK/dV) at full D, and both
//     consumer warpgroups take every streamed tile (K and V, or Q and dO, at
//     full D), consumer c forming columns [128c, 128c + 128) of dq, or of dk
//     and dv. A stage is free once the eight consumer warps have arrived on
//     its empty barrier, so the two stages double-buffer: each consumer
//     issues S and dP of its next tile behind the third product of this one
//     (dQ), or S^T of the next behind dk (dK/dV), as the D = 128 kernels do;
//     no partial sums are handed between consumers;
//   * the streamed tiles arrive by TMA (64-column boxes, 128-byte swizzle)
//     as four chunks of 64 columns; S = Q K^T and dP are 16 k-steps of
//     m64n64k16 over the four chunks; the third products read the half's two
//     chunks as an MN-major B operand (bf16_wgmma.cuh: cols_product), and
//     their A fragments come from the S or dP accumulator's registers;
//   * after the last live tile each consumer takes an end slot whose stale
//     stage its products read and drop: no wgmma stands under a branch,
//     which would make ptxas serialize them. P = 2^(s·scale·log2e − m) by
//     ex2.approx, the argument one fma (relative error ~2^-22, far below
//     bf16's 2^-9); a padded key's P is 0 by a select (forward, dQ) or by
//     -inf in its exponent (dK/dV), so no branch writes an accumulator;
//   * ragged T needs no padding: TMA reads rows past T as zero, the
//     epilogues store rows below T only; offsets are 64-bit.
//
// Shared memory (bytes; every tile 1024-aligned for the 128-byte swizzle):
//   forward  Q 2 x 32,768; 3 stages of K (32,768) and V's half (16,384);
//            slot headers, 7 mbarriers, alignment slack: 214,120
//   dQ       Q, dO 2 x 32,768; 2 stages of K, V (65,536); slot headers, Δ
//            of the rows, 4 mbarriers, slack: 197,952
//   dK/dV    K, V 2 x 32,768; 2 stages of Q, dO (65,536); lse and Δ of each
//            stage's queries, 4 mbarriers, slack: 198,688
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 256) bf16, contiguous,
// 16-byte aligned; mask (B, T) bytes, nonzero at padded keys; lse and delta
// (B, H, T) float32 (lse may be null in the forward: then none is stored).

#include <math_constants.h>

#include "bf16_wgmma.cuh"

namespace {

using namespace sm90;
using namespace bf16mma;
using bf16 = __nv_bfloat16;

constexpr int kD = 256;                        // head dim
constexpr int kHalf = 128;                     // output columns a consumer
constexpr uint32_t kTileD = 2 * kTile;         // 64 rows x 256: four chunks
constexpr int kRows = kTileRows;               // rows of a tile
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
constexpr float kLn2 = 0.6931471805599453f;

// Each stage's slot header (forward, dQ): the streamed key tile (n_tiles
// for the end slot) and its key bits (bit c: key 64 tile + c valid).
struct alignas(16) SlotHead {
  int tile;
  int pad;
  uint64_t bits;
};

// A ring of kStages stages: a full barrier (the producer's one arrival and
// the bytes it announces) and an empty barrier (one arrival from each of
// the eight consumer warps, which all read every stage) each, at `bars`.
template <int kStages>
struct Ring {
  static __device__ __forceinline__ uint32_t full(uint32_t bars, int s) {
    return bars + 8 * s;
  }
  static __device__ __forceinline__ uint32_t empty(uint32_t bars, int s) {
    return bars + 8 * (kStages + s);
  }
  static __device__ __forceinline__ void init(uint32_t bars) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(bars, s), 1);
      mbar_init(empty(bars, s), kConsumerThreads / 32);
    }
  }
  // The producer waits until slot n's stage is free (the slot n - kStages
  // that it held has been released by every consumer warp).
  static __device__ __forceinline__ void wait_free(uint32_t bars, int n) {
    mbar_wait(empty(bars, n % kStages), ((n / kStages) & 1) ^ 1);
  }
  static __device__ __forceinline__ void wait_full(uint32_t bars, int n) {
    mbar_wait(full(bars, n % kStages), (n / kStages) & 1);
  }
  // A consumer warp is done with stage s (its wgmma have completed).
  static __device__ __forceinline__ void release(uint32_t bars, int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(bars, s));
  }
};

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

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float row_reduce_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_reduce_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// `n` boxes of 64 columns, columns [64 c0, 64 (c0 + n)), of rows
// [r0, r0 + 64) of head `bh`, by TMA into consecutive chunks at `dst`,
// counted on the mbarrier `bar` (rows past T land as zero). The caller
// announces the bytes.
__device__ __forceinline__ void tma_boxes(const CUtensorMap* tm, int c0, int n,
                                          int r0, int bh, uint32_t dst,
                                          uint32_t bar) {
  for (int c = 0; c < n; ++c)
    tma_load_3d(dst + c * kChunk, tm, 64 * (c0 + c), r0, bh, bar);
}

// `x` as a value the compiler cannot see through: a shared address passed
// through it before each product is not hoisted out of the loop with its 16
// descriptors (32 registers a resident tile, which the dK/dV consumers,
// holding dk and dv, do not have).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d = A B over D = 256 (16 k-steps): A the K-major tile at shared address
// `a`, B the K-major tile at `b` (B(k, n) = tile(n, k)), each four chunks of
// 64 columns. S = Q K^T and dP = dO V^T (S^T and dP^T in dK/dV) take this
// form; the first k-step starts the sum afresh.
__device__ __forceinline__ void rows_product_d256(float (&d)[32], uint32_t a,
                                                  uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_m64n64k16_ss<0>(
        d, desc_sw128(a + (kk >> 2) * kChunk + (kk & 3) * 32),
        desc_sw128(b + (kk >> 2) * kChunk + (kk & 3) * 32), kk);
}

// Rows [r0, r0 + 64) of one head's (T, 256) matrix, zero past T, into the
// tile at `dst` as TMA lands it, by the consumers (thread `ct` of 256).
__device__ __forceinline__ void load_resident(uint8_t* dst, const bf16* src,
                                              int r0, int t_len, int ct) {
  for (int f = ct; f < kRows * (kD / 8); f += kConsumerThreads) {
    const int r = f >> 5, c = f & 31;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * kD +
                                          8 * c);
    *reinterpret_cast<uint4*>(dst + tile16_offset(r, c)) = x;
  }
}

// Rows [r0, r0 + 64), columns [128 half, 128 half + 128) of a (T, 256) bf16
// output from the accumulator pair acc (row 16w + g + 8h, column
// 128 half + 64 i + 8j + 2t + e in acc[i]), each value times `scale[h]`;
// rows past T are not stored. `wt` is the thread in its warpgroup.
__device__ __forceinline__ void store_half(bf16* dst, const float (&acc)[2][32],
                                          const float (&scale)[2], int r0,
                                          int half, int t_len, int wt) {
  const int warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= t_len) continue;
    bf16* row = dst + (int64_t)r * kD + kHalf * half + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 64 * i + 8 * j) =
            pack_bf16x2(acc[i][4 * j + 2 * h] * scale[h],
                        acc[i][4 * j + 2 * h + 1] * scale[h]);
  }
}

// The mask of a window of 256 keys [256 w, 256 w + 256) in the producer's
// warp: lane's byte, bit j for key 256 w + 8 lane + j valid (0 past T).
__device__ __forceinline__ uint32_t mask_window(const uint8_t* mrow,
                                                int t_len, int w) {
  const int k0 = 256 * w + 8 * (threadIdx.x & 31);
  uint32_t byte = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    byte |= (uint32_t)(k0 + j < t_len && mrow[k0 + j] == 0) << j;
  return byte;
}

// Key bits of tile t (0..3) of a window, from the bytes of lanes 8t .. 8t + 7
// (every lane returns them).
__device__ __forceinline__ uint64_t window_tile_bits(uint32_t byte, int t) {
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bits |= (uint64_t)__shfl_sync(0xffffffffu, byte, 8 * t + i) << (8 * i);
  return bits;
}

// The producer's warp of the forward and the dQ kernel: every key tile with
// a valid key into the slots in turn, each slot's tile and key bits in its
// header, by TMA: K at full D and V's columns [64 v0, 64 (v0 + v_boxes));
// then one end slot (tile = n_tiles, no copy), which both consumers read.
// The mask is read once, a window of 256 keys ahead of its use.
template <int kStages>
__device__ __forceinline__ void key_producer(const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             int v0, int v_boxes,
                                             const uint8_t* mrow, int t_len,
                                             int bh, uint32_t stages,
                                             uint32_t stage_bytes,
                                             uint32_t bars, SlotHead* heads) {
  using R = Ring<kStages>;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kRows - 1) / kRows;
  uint32_t window = mask_window(mrow, t_len, 0);
  uint32_t ahead = mask_window(mrow, t_len, 1);
  int n = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile > 0 && (tile & 3) == 0) {
      window = ahead;
      ahead = mask_window(mrow, t_len, (tile >> 2) + 1);
    }
    const uint64_t bits = window_tile_bits(window, tile & 3);
    if (bits == 0) continue;  // no valid key: neither loaded nor computed
    const int s = n % kStages;
    R::wait_free(bars, n);
    if (lane == 0) {
      heads[s].tile = tile;
      heads[s].bits = bits;
      const uint32_t dst = stages + s * stage_bytes;
      const uint32_t bar = R::full(bars, s);
      mbar_expect_tx(bar, kTileD + v_boxes * kChunk);
      tma_boxes(tm_k, 0, 4, tile * kRows, bh, dst, bar);
      tma_boxes(tm_v, v0, v_boxes, tile * kRows, bh, dst + kTileD, bar);
    }
    __syncwarp();
    ++n;
  }
  const int s = n % kStages;
  R::wait_free(bars, n);
  if (lane == 0) {
    heads[s].tile = n_tiles;
    heads[s].bits = 0;
    mbar_arrive(R::full(bars, s));
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The forward.

namespace fwd_layout {
constexpr int kBq = kConsumers * kRows;        // query rows a block
constexpr int kStages = 3;
constexpr uint32_t kStage = kTileD + kTile;    // K at full D, V's half
constexpr uint32_t kOffQ = 0;                  // [consumer] 64-row Q tiles
constexpr uint32_t kOffStage = kOffQ + kConsumers * kTileD;
constexpr uint32_t kOffHead = kOffStage + kStages * kStage;
constexpr uint32_t kOffBar = kOffHead + kStages * sizeof(SlotHead);
constexpr int kBars = 2 * kStages + 1;         // full, empty, Q
constexpr size_t kSmemBytes = kOffBar + kBars * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");
using R = Ring<kStages>;
__device__ __forceinline__ uint32_t q_bar(uint32_t bars) {
  return bars + 8 * (2 * kStages);
}
}  // namespace fwd_layout

// This thread's 16 key bits of a tile, bit 2j + e for key 8j + 2 t4 + e
// (accumulator columns of d[4j + 2h + e]).
__device__ __forceinline__ uint32_t thread_bits(uint64_t bits, int t4) {
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mine |= (uint32_t)((bits >> (8 * j + 2 * t4)) & 3u) << (2 * j);
  return mine;
}

// One key tile of the online softmax, in place on the S accumulator `sc`
// (rows h = 0: 16 warp + g, h = 1: + 8): P = 2^(s·scale2 − m) at the valid
// keys and 0 at the padded ones, the running max m (log2 units) and sum l
// updated, and alpha = 2^(m_old − m_new), the factor for O
// (csrc/flash_mha_bf16.cu's, unchanged).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint32_t mine,
                                             float scale2, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mx = fmaxf(mx, (mine >> (2 * j + e)) & 1u ? sc[4 * j + 2 * h + e]
                                                  : -CUDART_INF_F);
    const float m_new = fmaxf(m[h], row_reduce_max(mx) * scale2);
    const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[h] = m_new == m[h] ? 1.f : exp2_approx(m[h] - shift);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 4 * j + 2 * h + e;
        sc[c] = (mine >> (2 * j + e)) & 1u
                    ? exp2_approx(fmaf(sc[c], scale2, -shift))
                    : 0.f;
        sum += sc[c];
      }
    l[h] = fmaf(l[h], alpha[h], row_reduce_sum(sum));
    m[h] = m_new;
  }
}

// The consumers' turns (csrc/flash_mha_bf16.cu's): named barrier 1 + c is
// consumer c's; constant barrier ids.
__device__ __forceinline__ void turn_sync(int c) {
  if (c == 0)
    named_sync<1, kConsumerThreads>();
  else
    named_sync<2, kConsumerThreads>();
}
__device__ __forceinline__ void turn_arrive(int c) {
  if (c == 0)
    asm volatile("bar.arrive 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
  else
    asm volatile("bar.arrive 2, %0;\n" :: "n"(kConsumerThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_fwd_bf16_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const uint8_t* __restrict__ mask,
                               bf16* __restrict__ out, float* __restrict__ lse,
                               int n_head, int t_len, float sm_scale) {
  using namespace fwd_layout;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  SlotHead* heads = reinterpret_cast<SlotHead*>(smem + kOffHead);
  const uint32_t bars = base + kOffBar;

  const int tid = threadIdx.x;
  const int half = blockIdx.x & 1;             // the block's output columns
  const int q0 = (blockIdx.x >> 1) * kBq;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kRows - 1) / kRows;

  if (tid == 0) {
    R::init(bars);
    mbar_init(q_bar(bars), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kWarpgroup) {
    producer_regs();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(q_bar(bars), kConsumers * kTileD);
        for (int c = 0; c < kConsumers; ++c)
          tma_boxes(&tm_q, 0, 4, q0 + c * kRows, bh,
                    base + kOffQ + c * kTileD, q_bar(bars));
      }
      key_producer<kStages>(&tm_k, &tm_v, 2 * half, 2, mrow, t_len, bh,
                            base + kOffStage, kStage, bars, heads);
    }
    return;
  }
  consumer_regs();
  const int ct = tid - kWarpgroup;             // thread among the consumers
  const int c = ct / kWarpgroup;               // consumer 0 or 1
  const int wt = ct % kWarpgroup;              // thread in its warpgroup
  const int t4 = tid & 3;
  const uint32_t qt = base + kOffQ + c * kTileD;  // this consumer's Q rows
  const float scale2 = sm_scale * kLog2e;

  float o[2][32], pv[2][32], sc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    o[0][i] = o[1][i] = pv[0][i] = pv[1][i] = sc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] =
      pa[kk][3] = 0u;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float alpha[2], alpha_pv[2];

  // Slot 0: S, and its P as the A fragments of P V.
  mbar_wait(q_bar(bars), 0);
  R::wait_full(bars, 0);
  int tile = heads[0].tile;
  uint32_t kst = base + kOffStage;
  fence_operands(sc);
  wgmma_fence();
  rows_product_d256(sc, qt, kst);              // S = Q K^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  softmax_tile(sc, thread_bits(heads[0].bits, t4), scale2, m, l, alpha);
  accumulator_to_a(pa, sc);
  // Consumer 0 issues first; consumer 1's last arrival is taken after the
  // loop (csrc/flash_mha_bf16.cu).
  const bool live = tile < n_tiles;
  if (c == 1 && live) turn_arrive(0);

  for (int n = 0; tile < n_tiles; ++n) {
    const int s = n % kStages;
    const int n1 = n + 1, s1 = n1 % kStages;
    R::wait_full(bars, n1);
    const int next = heads[s1].tile;
    const uint32_t next_bits = thread_bits(heads[s1].bits, t4);
    const uint32_t kst1 = base + kOffStage + s1 * kStage;
    turn_sync(c);
    fence_operands(sc);
    fence_operands(pv[0]);
    fence_operands(pv[1]);
    wgmma_fence();
    rows_product_d256(sc, qt, kst1);           // S of slot n + 1
    wgmma_commit();
    cols_product(pv, pa, kst + kTileD, 0);     // P V of slot n, V's half
    wgmma_commit();
    turn_arrive(1 - c);
    wgmma_wait<1>();                           // S of slot n + 1 done
    fence_operands(sc);
    alpha_pv[0] = alpha[0];
    alpha_pv[1] = alpha[1];
    softmax_tile(sc, next_bits, scale2, m, l, alpha);
    wgmma_wait<0>();                           // P V done: stage s is free
    fence_operands(pv[0]);
    fence_operands(pv[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
    R::release(bars, s);
    // O = O·alpha + P V of slot n, in float32.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        o[i][e] = fmaf(o[i][e], alpha_pv[(e >> 1) & 1], pv[i][e]);
    accumulator_to_a(pa, sc);
    tile = next;
    kst = kst1;
  }
  if (c == 0 && live) turn_sync(0);

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
  const int r0 = q0 + c * kRows;
  store_half(out + head * kD, o, inv, r0, half, t_len, wt);
  if (lse != nullptr && half == 0 && t4 == 0) {
    const int g = (wt & 31) >> 2, warp = wt >> 5;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * warp + g + 8 * h;
      if (r < t_len)
        lse[head + r] =
            l[h] == 0.f ? CUDART_INF_F : fmaf(m[h], kLn2, logf(l[h]));
    }
  }
}

// ---------------------------------------------------------------------------
// The dQ kernel: a block per (b, h, 64 query rows).

namespace dq_layout {
constexpr int kStages = 2;
constexpr uint32_t kStage = 2 * kTileD;        // K and V of a key tile
constexpr uint32_t kOffRes = 0;                // Q, then dO
constexpr uint32_t kOffStage = 2 * kTileD;
constexpr uint32_t kOffHead = kOffStage + kStages * kStage;
constexpr uint32_t kOffDelta = kOffHead + kStages * sizeof(SlotHead);
constexpr uint32_t kOffBar = kOffDelta + kRows * 4;
constexpr size_t kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");
using R = Ring<kStages>;
}  // namespace dq_layout

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dq_bf16_d256_kernel(const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const bf16* __restrict__ q,
                                  const uint8_t* __restrict__ mask,
                                  const bf16* __restrict__ out,
                                  const bf16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  bf16* __restrict__ dq_out, int n_head,
                                  int t_len, float sm_scale) {
  using namespace dq_layout;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kOffBar;
  SlotHead* heads = reinterpret_cast<SlotHead*>(smem + kOffHead);
  float* delta_s = reinterpret_cast<float*>(smem + kOffDelta);

  const int tid = threadIdx.x;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kRows - 1) / kRows;

  if (tid == 0) {
    R::init(bars);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kWarpgroup) {
    producer_regs();
    if (tid < 32)
      key_producer<kStages>(&tm_k, &tm_v, 0, 4, mrow, t_len, bh,
                            base + kOffStage, kStage, bars, heads);
    return;
  }
  consumer_regs();
  const int ct = tid - kWarpgroup;             // thread among the consumers
  const int c = ct / kWarpgroup;               // consumer 0 or 1: dq's half
  const int wt = ct % kWarpgroup;              // thread in its warpgroup
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  load_resident(smem + kOffRes, q + head * kD, q0, t_len, ct);
  load_resident(smem + kOffRes + kTileD, dout + head * kD, q0, t_len, ct);
  // Δ of the block's rows in float32 from the bf16 out and dO over all 256
  // columns, 8 rows a warp (32 lanes x 8 columns); rows past T get 0 (their
  // P is 0).
  for (int i = 0; i < kRows / 8; ++i) {
    const int r = 8 * (ct >> 5) + i;
    float part = 0.f;
    if (q0 + r < t_len) {
      const int64_t off = (head + q0 + r) * kD + 8 * lane;
      const uint4 o = *reinterpret_cast<const uint4*>(out + off);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + off);
      __nv_bfloat162 ob[4], db[4];
      memcpy(ob, &o, 16);
      memcpy(db, &d, 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(ob[j]);
        const float2 df = __bfloat1622float2(db[j]);
        part = fmaf(of.x, df.x, fmaf(of.y, df.y, part));
      }
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

  // Every slot, n = 0, 1, ...: S and dP of a slot go in as soon as it has
  // landed; for the end slot they read its stage's stale rows and are
  // dropped.
  const uint32_t q_res = base + kOffRes, do_res = q_res + kTileD;
  int n = 0, s = 0;
  R::wait_full(bars, 0);
  int tile = heads[0].tile;
  uint64_t bits = heads[0].bits;
  uint32_t kst = base + kOffStage;
  wgmma_fence();
  rows_product_d256(sc, q_res, kst);                   // Q K^T
  rows_product_d256(dp, do_res, kst + kTileD);         // dO V^T
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
    cols_product(acc_dq, da, kst + c * kTile, i > 0);  // dS K, K's half c
    wgmma_commit();
    // S and dP of the next slot go in behind dS K.
    const int n_next = n + 1, s_next = n_next % kStages;
    R::wait_full(bars, n_next);
    const int next = heads[s_next].tile;
    const uint64_t next_bits = heads[s_next].bits;
    const uint32_t kst_next = base + kOffStage + s_next * kStage;
    wgmma_fence();
    rows_product_d256(sc, q_res, kst_next);
    rows_product_d256(dp, do_res, kst_next + kTileD);
    wgmma_commit();
    wgmma_wait<1>();  // dS K done: stage s is free
    fence_operands(acc_dq[0]);
    fence_operands(acc_dq[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(da[kk]);
    R::release(bars, s);
    n = n_next;
    s = s_next;
    tile = next;
    bits = next_bits;
    kst = kst_next;
  }
  wgmma_wait<0>();  // the end slot's dropped S and dP
  fence_operands(sc);
  fence_operands(dp);
  const float one[2] = {1.f, 1.f};
  store_half(dq_out + head * kD, acc_dq, one, q0, c, t_len, wt);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel: a block per (b, h, 64 keys).

namespace dkv_layout {
constexpr int kStages = 2;
constexpr uint32_t kStage = 2 * kTileD;        // Q and dO of a query tile
constexpr uint32_t kStats = 2 * kRows * 4;     // lse and Δ of its queries
constexpr uint32_t kOffRes = 0;                // K, then V
constexpr uint32_t kOffStage = 2 * kTileD;
constexpr uint32_t kOffStats = kOffStage + kStages * kStage;
constexpr uint32_t kOffBar = kOffStats + kStages * kStats;
constexpr size_t kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");
using R = Ring<kStages>;
}  // namespace dkv_layout

// The producer's warp: query tile n into its stage: its lse and Δ by the
// lanes with cp.async (0 past T, where Q and dO read as 0 too, so those
// queries add exactly 0), counted on the stage's full barrier; Q and dO at
// full D by TMA (lane 0). Then one end slot, which both consumers read.
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_do,
                                             const float* lse,
                                             const float* delta, int t_len,
                                             int bh, uint32_t base) {
  using namespace dkv_layout;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kRows - 1) / kRows;
  const uint32_t bars = base + kOffBar;
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    const uint32_t bar = R::full(bars, s);
    R::wait_free(bars, n);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int row = n * kRows + 32 * part + lane;
      const bool in = row < t_len;
      const int64_t r = (int64_t)bh * t_len + (in ? row : 0);
      const uint32_t dst = base + kOffStats + s * kStats +
                           (32 * part + lane) * 4;
      cp_async4(dst, lse + r, in ? 4 : 0);
      cp_async4(dst + kRows * 4, delta + r, in ? 4 : 0);
    }
    cp_async_mbar_arrive(bar);
    __syncwarp();
    if (lane == 0) {
      const uint32_t dst = base + kOffStage + s * kStage;
      mbar_expect_tx(bar, kStage);
      tma_boxes(tm_q, 0, 4, n * kRows, bh, dst, bar);
      tma_boxes(tm_do, 0, 4, n * kRows, bh, dst + kTileD, bar);
    }
    __syncwarp();
  }
  R::wait_free(bars, n_tiles);
  if (lane == 0) mbar_arrive(R::full(bars, n_tiles % kStages));
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dkv_bf16_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int n_head,
                                   int t_len, float sm_scale) {
  using namespace dkv_layout;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, base);
  const uint32_t bars = base + kOffBar;
  const float* stats = reinterpret_cast<const float*>(smem + kOffStats);

  const int tid = threadIdx.x;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  // A block whose keys are all padded: dk and dv are 0 there.
  const bool live = tid < kRows && k0 + tid < t_len && mrow[k0 + tid] == 0;
  if (!__syncthreads_or(live)) {
    for (int f = tid; f < kRows * kD / 8; f += kThreads) {
      const int r = k0 + (f >> 5);
      if (r >= t_len) continue;
      const int64_t off = (head + r) * kD + 8 * (f & 31);
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int n_tiles = (t_len + kRows - 1) / kRows;
  if (tid == 0) {
    R::init(bars);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kWarpgroup) {
    producer_regs();
    if (tid < 32) dkv_producer(&tm_q, &tm_do, lse, delta, t_len, bh, base);
    return;
  }
  consumer_regs();
  const int ct = tid - kWarpgroup;
  const int c = ct / kWarpgroup;               // consumer 0 or 1: dk, dv's half
  const int wt = ct % kWarpgroup;
  const int warp = wt >> 5, lane = tid & 31;
  const int t4 = lane & 3;

  load_resident(smem + kOffRes, k + head * kD, k0, t_len, ct);
  load_resident(smem + kOffRes + kTileD, v + head * kD, k0, t_len, ct);
  // This thread's keys: 16 warp + g + 8h; -inf added to the exponent of a
  // padded key's P makes it 0 (no branch).
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

  // Every query tile n = 0, 1, ...; S^T and dP^T of the next go in behind
  // dk and dv of this one (for the end slot they read its stage's stale
  // rows and are dropped).
  const uint32_t k_res = base + kOffRes, v_res = k_res + kTileD;
  int n = 0, s = 0;
  R::wait_full(bars, 0);
  uint32_t qst = base + kOffStage;
  wgmma_fence();
  rows_product_d256(sc, k_res, qst);                   // K Q^T
  rows_product_d256(dp, v_res, qst + kTileD);          // V dO^T
  wgmma_commit();
  for (int i = 0; n < n_tiles; ++i) {
    const float* lse_s = stats + s * (kStats / 4);
    const float* dlt_s = lse_s + kRows;
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
    cols_product(acc_dv, pa, qst + kTileD + c * kTile, i > 0);  // P^T dO
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = 8 * (e >> 2) + 2 * t4 + (e & 1);
      dp[e] = (dp[e] - dlt_s[qi]) * sc[e] * sm_scale;
    }
    accumulator_to_a(da, dp);
    wgmma_fence();
    cols_product(acc_dk, da, qst + c * kTile, i > 0);           // dS^T Q
    wgmma_commit();
    wgmma_wait<1>();  // dv done: P^T's registers are free
    fence_operands(acc_dv[0]);
    fence_operands(acc_dv[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
    // S^T of the next tile goes in behind dk (dP^T too would take more
    // registers than a consumer has).
    const int n_next = n + 1, s_next = n_next % kStages;
    R::wait_full(bars, n_next);
    const uint32_t qst_next = base + kOffStage + s_next * kStage;
    wgmma_fence();
    rows_product_d256(sc, opaque(k_res), qst_next);
    wgmma_commit();
    wgmma_wait<1>();  // dk done: stage s is free
    fence_operands(acc_dk[0]);
    fence_operands(acc_dk[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(da[kk]);
    R::release(bars, s);
    wgmma_fence();
    rows_product_d256(dp, opaque(v_res), qst_next + kTileD);
    wgmma_commit();
    n = n_next;
    s = s_next;
    qst = qst_next;
  }
  wgmma_wait<0>();  // the end slot's dropped S^T and dP^T
  fence_operands(sc);
  fence_operands(dp);
  const float one[2] = {1.f, 1.f};
  store_half(dk + head * kD, acc_dk, one, k0, c, t_len, wt);
  store_half(dv + head * kD, acc_dv, one, k0, c, t_len, wt);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Tensor maps over (batch * n_head, t_len, 256) bf16 views, boxes of 64 rows
// by 64 columns.
int tensor_maps(CUtensorMap* maps, const void* const* ptrs, int n,
                int batch, int n_head, int t_len) {
  const uint64_t heads = (uint64_t)batch * n_head;
  for (int i = 0; i < n; ++i) {
    const int err = make_tensor_map_bf16(&maps[i], ptrs[i], heads, t_len, kD,
                                         kRows);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), or the
// code of sm90::make_tensor_map_bf16 if a tensor map cannot be made. The
// runtime call comes first: it makes the device's context current in this
// thread (autograd runs the backward in its own), which
// cuTensorMapEncodeTiled needs.

// q, k, v, out: (batch, n_head, t_len, 256) bf16; mask: (batch, t_len)
// bytes; lse: (batch, n_head, t_len) float32, or null to store none.
extern "C" int flash_mha_fwd_bf16_d256(const void* q, const void* k,
                                       const void* v, const uint8_t* mask,
                                       void* out, float* lse, int batch,
                                       int n_head, int t_len, float sm_scale,
                                       void* stream) {
  namespace L = fwd_layout;
  int err = set_smem(flash_mha_fwd_bf16_d256_kernel, L::kSmemBytes);
  CUtensorMap tm[3];
  const void* ptrs[3] = {q, k, v};
  if (err == 0) err = tensor_maps(tm, ptrs, 3, batch, n_head, t_len);
  if (err != 0) return err;
  const dim3 grid(2 * ((t_len + L::kBq - 1) / L::kBq), n_head, batch);
  flash_mha_fwd_bf16_d256_kernel<<<grid, kThreads, L::kSmemBytes,
                                   (cudaStream_t)stream>>>(
      tm[0], tm[1], tm[2], mask, static_cast<bf16*>(out), lse, n_head, t_len,
      sm_scale);
  return (int)cudaGetLastError();
}

// The dQ kernel; also writes delta (B, H, T) = rowsum(dout * out) in
// float32 for the dK/dV kernel.
extern "C" int flash_mha_bwd_dq_bf16_d256(const void* q, const void* k,
                                          const void* v, const uint8_t* mask,
                                          const void* out, const void* dout,
                                          const float* lse, float* delta,
                                          void* dq, int batch, int n_head,
                                          int t_len, float sm_scale,
                                          void* stream) {
  namespace L = dq_layout;
  int err = set_smem(flash_mha_bwd_dq_bf16_d256_kernel, L::kSmemBytes);
  CUtensorMap tm[2];
  const void* ptrs[2] = {k, v};
  if (err == 0) err = tensor_maps(tm, ptrs, 2, batch, n_head, t_len);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dq_bf16_d256_kernel<<<grid, kThreads, L::kSmemBytes,
                                      (cudaStream_t)stream>>>(
      tm[0], tm[1], static_cast<const bf16*>(q), mask,
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// The dK/dV kernel; reads the delta the dQ kernel wrote.
extern "C" int flash_mha_bwd_dkv_bf16_d256(const void* q, const void* k,
                                           const void* v, const uint8_t* mask,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dk,
                                           void* dv, int batch, int n_head,
                                           int t_len, float sm_scale,
                                           void* stream) {
  namespace L = dkv_layout;
  int err = set_smem(flash_mha_bwd_dkv_bf16_d256_kernel, L::kSmemBytes);
  CUtensorMap tm[2];
  const void* ptrs[2] = {q, dout};
  if (err == 0) err = tensor_maps(tm, ptrs, 2, batch, n_head, t_len);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dkv_bf16_d256_kernel<<<grid, kThreads, L::kSmemBytes,
                                       (cudaStream_t)stream>>>(
      tm[0], tm[1], static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the forward (0), the dQ (1) and the dK/dV
// kernel (2) takes, in bytes (ptxas reports only static shared memory), and
// their ring stages.
extern "C" int flash_mha_bf16_d256_smem_bytes(int kernel) {
  return (int)(kernel == 0   ? fwd_layout::kSmemBytes
               : kernel == 1 ? dq_layout::kSmemBytes
                             : dkv_layout::kSmemBytes);
}
extern "C" int flash_mha_bf16_d256_stages(int kernel) {
  return kernel == 0   ? fwd_layout::kStages
         : kernel == 1 ? dq_layout::kStages
                       : dkv_layout::kStages;
}

// Keys per tile, the unit in which the forward and dQ skip wholly padded
// keys (also the dK/dV kernel's keys a block and its query tile); query
// rows a forward block (each block forms half of the output's columns).
extern "C" int flash_mha_bf16_d256_key_tile() { return kRows; }
extern "C" int flash_mha_bf16_d256_block_rows() { return fwd_layout::kBq; }

// The blocks' shape, common to the three kernels: threads a block, consumer
// warpgroups, and the registers a thread that setmaxnreg gives the producer
// and the consumer warpgroups.
extern "C" int flash_mha_bf16_d256_threads() { return kThreads; }
extern "C" int flash_mha_bf16_d256_consumers() { return kConsumers; }
extern "C" int flash_mha_bf16_d256_producer_regs() { return kProducerRegs; }
extern "C" int flash_mha_bf16_d256_consumer_regs() { return kConsumerRegs; }
