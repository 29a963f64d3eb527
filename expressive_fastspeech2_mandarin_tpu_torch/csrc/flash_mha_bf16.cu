// Masked multi-head attention forward (flash attention) in bf16, written by
// hand for Hopper (sm_90a) on the tensor cores, with a plain C interface for
// ctypes.
//
// Replaces the bf16 instantiation of the TPU kernel that
// expressive_fastspeech2_mandarin_tpu/ops/pallas/flash_mha.py (flash_mha,
// :53) wraps: JAX 0.9.0's jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_impl (:589, pallas_call at :758),
// which the JAX package's bf16 mixed-precision train step feeds bf16 q, k,
// v. For each (batch b, head h) and query row i:
//     out[i] = sum_j softmax_j(s_ij) v[j],   s_ij = (q_i . k_j) * sm_scale,
// with s_ij = -inf where key j is padded (mask[b][j] != 0), and 0 for a row
// whose keys are all padded. The arithmetic follows the TPU kernel's bf16
// path: S from the bf16 operands into float32 (:396), the online softmax in
// float32, P = exp(s - m) rounded to bf16 before P V (:471), the row sum of
// the unrounded P, O accumulated in float32 and stored in bf16 (:477). The
// contract is csrc/flash_mha.cu's (the float32 kernel): only keys are
// masked, so every query row, padded rows included, equals the plain version
// (ops/flash_mha.py:flash_mha_blocked_plain on the kernel's key tiles); a
// row with no valid key is exactly 0 and its log-sum-exp +inf; given an lse
// pointer, the kernel stores each row's float32 natural log-sum-exp for the
// backward (csrc/flash_mha_bwd_bf16.cu).
//
// What bounds it: operations. Two products of 2*T*T*D flops per (b, h)
// against 8*B*H*T*D bytes of bf16 (q, k, v read, out written): T/2 flops a
// byte, far above the ~295 at which the bf16 tensor cores stop waiting on
// memory for the sequences that take this kernel. The card's floor is those
// flops over the key tiles with a valid key at 989 TF/s. On the way there
// stands the chain of each consumer's tile: the softmax between the two
// products of a tile, then the update of O. Taking a product or the exps
// away, or every load of K and V, moves the time far less than that
// work's share of the card's peak (PERF.md §6).
//
// Design (a block: 128 query rows of one (b, h), three warpgroups of 128
// threads; one block an SM):
//   * warp specialisation, as in the backward (csrc/flash_mha_bwd_bf16.cu):
//     warpgroup 0 is the producer. It gives its registers up (setmaxnreg
//     to kProducerRegs), and one warp of it brings the block's Q by TMA,
//     reads the mask once (a window of 256 keys ahead of its use, so the
//     loads' latency hides) and issues the K and V tiles with a valid key by
//     TMA into a ring of kStages stages with a full and an empty mbarrier
//     each, writing each slot's tile and key bits beside the stage, then
//     an end slot (no copy, no key bits). Warpgroups 1 and 2 are consumers
//     (setmaxnreg to kConsumerRegs). Each owns 64 of the block's 128 query
//     rows and both read every streamed tile, so each row's online softmax
//     sees the same 64-key tiles in the same order as the plain version on
//     64-key tiles (the rounding points do not move), and K and V are read
//     once for 128 rows. A stage is free once the eight consumer warps
//     have arrived on its empty barrier: no block barrier in the loop;
//   * the tensor cores run back to back inside a consumer: it issues S of
//     its next slot, then P V of this one, and forms the next tile's P on
//     the CUDA cores while P V runs (no code touches an accumulator between
//     the two issues: ptxas would serialize the wgmma). The two consumers
//     take turns at issuing (two named barriers), so one's exps run under
//     the other's products. After the last live tile the end slot's S reads
//     its stage's stale rows into a product whose key bits are all 0: no
//     wgmma stands under a branch, which would make ptxas serialize them;
//   * bf16 wgmma reads either major order from shared memory, so the tiles
//     feed the tensor cores as TMA lands them (bf16_wgmma.cuh): S = Q K^T
//     with K K-major, P V with V MN-major (the transpose bit). S is 8
//     k-steps of m64n64k16; P goes from the S accumulator's registers,
//     rounded to bf16, straight into the A fragments of P V (4 k-steps of
//     two m64n64k16, the two 64-dim halves of V) into a fresh accumulator
//     that the consumer adds to the rescaled O in float32 (a chain of every
//     tile's P V in the tensor cores would carry their truncation over the
//     whole row: more bf16 roundings of out flip);
//   * online softmax in float32 registers, in log2 units: each row's max
//     and sum reduce over the 4 threads that share it; P = 2^(s·scale·log2e
//     − m) by ex2.approx, the argument one fma (relative error ~2^-22, far
//     below bf16's 2^-9); a padded key's P is a select of 0, so no branch
//     writes an accumulator and a stale stage's values never reach one. A
//     row with no valid key keeps max -inf and sum 0, and stores 0 and lse
//     +inf; the natural lse is m·ln2 + log(l);
//   * ragged T needs no padding: TMA reads rows past T as zero, the
//     epilogue stores rows below T only; offsets into out are 64-bit.
//
// Shared memory (bytes; every tile 1024-aligned for the 128-byte swizzle):
//   Q                      128 rows x 256             =  32,768
//   K, V, kStages = 6      6 x 2 x 64 x 256           = 196,608
//   slot headers 6 x 16, 13 mbarriers, alignment slack 1,024: 230,600.
//
// Layouts: q, k, v and out (B, H, T, 128) bf16, contiguous, 16-byte
// aligned; mask (B, T) bytes, nonzero at padded keys; lse (B, H, T) float32
// or null.

#include <math_constants.h>

#include "bf16_wgmma.cuh"

namespace {

using namespace sm90;
using namespace bf16mma;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;                        // head dim
constexpr int kBk = kTileRows;                 // keys per tile
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBq = kConsumers * kTileRows;    // query rows per block
constexpr int kThreads = (1 + kConsumers) * kWarpgroup;
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kProducerRegs = 24;              // setmaxnreg, per thread
constexpr int kConsumerRegs = 240;
static_assert(kWarpgroup * (kProducerRegs + kConsumers * kConsumerRegs) <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "setmaxnreg asks for more registers than the launch holds");
constexpr int kStages = 6;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kStage = 2 * kTile;         // K and V of one key tile

// Each stage's slot header: the streamed key tile (n_tiles for the end
// slot) and its key bits (bit c: key 64 tile + c valid).
struct alignas(16) SlotHead {
  int tile;
  int pad;
  uint64_t bits;
};

constexpr uint32_t kOffQ = 0;                  // [consumer] 64-row Q tiles
constexpr uint32_t kOffStage = kOffQ + kConsumers * kTile;
constexpr uint32_t kOffHead = kOffStage + kStages * kStage;
constexpr uint32_t kOffBar = kOffHead + kStages * sizeof(SlotHead);
constexpr int kBars = 2 * kStages + 1;         // full, empty, Q
constexpr size_t kSmemBytes = kOffBar + kBars * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (kStages + s);
}
__device__ __forceinline__ uint32_t q_bar(uint32_t bars) {
  return bars + 8 * (2 * kStages);
}

__device__ __forceinline__ float row_reduce_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_reduce_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The consumers' turns: named barrier 1 + c (over the 256 consumer threads)
// is consumer c's. Consumer c waits there for the other's arrival before it
// issues its products (turn_sync(c)) and arrives at the other's after
// (turn_arrive(1 - c)). Constant barrier ids: with an id in a register
// ptxas reserves all 16 barriers, and the kernel runs slower.
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

// The mask of a window of 256 keys [256 w, 256 w + 256) in the producer's
// warp: lane's byte, bit j for key 256 w + 8 lane + j valid (0 past T).
// The loads are issued a window ahead of their use, so their latency hides
// behind the streaming of four tiles.
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

// The producer's warp: the block's two Q tiles, then every key tile with a
// valid key, by TMA (K and V) into the slots in turn, each slot's tile and
// key bits in its header; then one end slot, which both consumers read.
__device__ __forceinline__ void producer(const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v,
                                         const uint8_t* mrow, int t_len,
                                         int bh, int q0, uint32_t base,
                                         SlotHead* heads) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kBk - 1) / kBk;
  const uint32_t bars = base + kOffBar;
  if (lane == 0) {
    mbar_expect_tx(q_bar(bars), kConsumers * kTile);
    for (int c = 0; c < kConsumers; ++c)
      for (int chunk = 0; chunk < 2; ++chunk)
        tma_load_3d(base + kOffQ + c * kTile + chunk * kChunk, tm_q,
                    64 * chunk, q0 + c * kTileRows, bh, q_bar(bars));
  }
  // The mask, read once: the window of the tile at hand and the next one.
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
    mbar_wait(empty_bar(bars, s), ((n / kStages) & 1) ^ 1);
    if (lane == 0) {
      heads[s].tile = tile;
      heads[s].bits = bits;
      load_tile_pair(tm_k, tm_v, tile, bh, base + kOffStage + s * kStage,
                     full_bar(bars, s));
    }
    __syncwarp();
    ++n;
  }
  const int s = n % kStages;
  mbar_wait(empty_bar(bars, s), ((n / kStages) & 1) ^ 1);
  if (lane == 0) {
    heads[s].tile = n_tiles;
    heads[s].bits = 0;
    mbar_arrive(full_bar(bars, s));
  }
  __syncwarp();
}

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
// updated, and alpha = 2^(m_old − m_new), the factor for O.
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

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const uint8_t* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  SlotHead* heads =
      reinterpret_cast<SlotHead*>(smem_raw + (base - raw) + kOffHead);
  const uint32_t bars = base + kOffBar;

  const int tid = threadIdx.x;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kBk - 1) / kBk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kConsumerThreads / 32);
    }
    mbar_init(q_bar(bars), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kWarpgroup) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid < 32)
      producer(&tm_q, &tm_k, &tm_v, mrow, t_len, bh, q0, base, heads);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int ct = tid - kWarpgroup;             // thread among the consumers
  const int c = ct / kWarpgroup;               // consumer 0 or 1
  const int wt = ct % kWarpgroup;              // thread in its warpgroup
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t qt = base + kOffQ + c * kTile;  // this consumer's Q rows
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
  mbar_wait(full_bar(bars, 0), 0);
  int tile = heads[0].tile;
  uint32_t kst = base + kOffStage;
  fence_operands(sc);
  wgmma_fence();
  rows_product(sc, qt, kst);                   // S = Q K^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  softmax_tile(sc, thread_bits(heads[0].bits, t4), scale2, m, l, alpha);
  accumulator_to_a(pa, sc);
  // Consumer 0 issues first. Both consumers take a turn a live slot (they
  // read the same slots), and consumer 1's last arrival is taken after the
  // loop: no branch stands between a wgmma and its wait.
  const bool live = tile < n_tiles;
  if (c == 1 && live) turn_arrive(0);

  for (int n = 0; tile < n_tiles; ++n) {
    const int s = n % kStages;
    const int n1 = n + 1, s1 = n1 % kStages;
    mbar_wait(full_bar(bars, s1), (n1 / kStages) & 1);
    const int next = heads[s1].tile;
    const uint32_t next_bits = thread_bits(heads[s1].bits, t4);
    const uint32_t kst1 = base + kOffStage + s1 * kStage;
    turn_sync(c);
    fence_operands(sc);
    fence_operands(pv[0]);
    fence_operands(pv[1]);
    wgmma_fence();
    rows_product(sc, qt, kst1);                // S of slot n + 1
    wgmma_commit();
    cols_product(pv, pa, kst + kTile, 0);      // P V of slot n
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
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(bars, s));
    // O = O·alpha + P V of slot n, in float32 (the product's own sum is a
    // fresh one, as the TPU kernel's).
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[half][i] = fmaf(o[half][i], alpha_pv[(i >> 1) & 1], pv[half][i]);
    accumulator_to_a(pa, sc);
    tile = next;
    kst = kst1;
  }
  if (c == 0 && live) turn_sync(0);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + c * kTileRows + 16 * warp + g + 8 * h;
    if (r >= t_len) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    bf16* orow = out + (head + r) * kD + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 * half + 8 * j) =
            pack_bf16x2(o[half][4 * j + 2 * h] * inv,
                        o[half][4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[head + r] =
          l[h] == 0.f ? CUDART_INF_F : fmaf(m[h], kLn2, logf(l[h]));
  }
}

}  // namespace

// q, k, v, out: (batch, n_head, t_len, 128) bf16; mask: (batch, t_len)
// bytes; lse: (batch, n_head, t_len) float32, or null to store none.
// Returns cudaGetLastError() after the launch (0 on success), or the code of
// sm90::make_tensor_map_bf16 if a tensor map cannot be made.
extern "C" int flash_mha_fwd_bf16(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, float* lse,
                                  int batch, int n_head, int t_len,
                                  float sm_scale, void* stream) {
  // The runtime call first: it makes the device's context current in this
  // thread, which cuTensorMapEncodeTiled needs.
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_mha_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  int err = make_tensor_map_bf16(&tm_q, q, heads, t_len, kD, kTileRows);
  if (err == 0) err = make_tensor_map_bf16(&tm_k, k, heads, t_len, kD, kBk);
  if (err == 0) err = make_tensor_map_bf16(&tm_v, v, heads, t_len, kD, kBk);
  if (err != 0) return err;
  const dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  flash_mha_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, mask, static_cast<bf16*>(out), lse, n_head, t_len,
      sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the kernel takes, in bytes (ptxas reports
// only static shared memory).
extern "C" int flash_mha_fwd_bf16_smem_bytes() { return (int)kSmemBytes; }

// Keys per tile, the unit in which the kernel skips wholly padded keys.
extern "C" int flash_mha_fwd_bf16_key_tile() { return kBk; }

// The blocks' shape: query rows a block, threads a block, consumer
// warpgroups (each owns 64 of the rows and reads every streamed tile), ring
// stages, and the registers a thread that setmaxnreg gives the producer and
// the consumer warpgroups.
extern "C" int flash_mha_fwd_bf16_block_rows() { return kBq; }
extern "C" int flash_mha_fwd_bf16_threads() { return kThreads; }
extern "C" int flash_mha_fwd_bf16_consumers() { return kConsumers; }
extern "C" int flash_mha_fwd_bf16_stages() { return kStages; }
extern "C" int flash_mha_fwd_bf16_producer_regs() { return kProducerRegs; }
extern "C" int flash_mha_fwd_bf16_consumer_regs() { return kConsumerRegs; }
