// Masked multi-head attention forward (flash attention), written by hand for
// Hopper (sm_90a) on the tensor cores, with a plain C interface for ctypes.
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
// What bounds it: operations. Two products of 2*T*T*D flops per (b, h)
// against 16*B*H*T*D bytes: T/4 flops per byte, far above the ~148 at which
// the TF32 tensor cores stop waiting on memory. The card's floor is those
// flops over the key tiles with a valid key at the 495 TF/s TF32 rate, the
// fastest at which it multiplies float32 inputs. Float32 accuracy costs
// this kernel more products than that (3xTF32, see tf32_wgmma.cuh): four
// TF32 products for S and three for P V. On the card the 128 bytes a clock
// of shared memory bind first: a tile of 32 keys moves ~304 KB through it
// (S's operands 128 KB, P V's 48 KB, TMA 32 KB, the split 96 KB).
//
// Design (a block: 64 query rows of one (b, h), 256 threads):
//   * warpgroup 0 consumes: S = Q K^T per tile of 32 keys as 16 k-steps of
//     two wgmma m64n64k8 (Q hi and Q lo, each times [K hi; K lo]: all four
//     products), both operands from 128-byte swizzled shared memory; the
//     online softmax; O += P V as wgmma m64n128k8 with P from registers
//     (lo*hi, hi*lo, hi*hi). Q is split into its TF32 parts once;
//   * warp 4 produces: it alone reads the mask. Each tile whose 32 keys are
//     not all padded ("live") goes by TMA into stage n % 2 of a two-stage
//     mbarrier ring (a 3-D tensor map over the (B*H, T, 128) view: rows past
//     T read as zero, no head reads its neighbour's rows), K into the
//     stage's K rows and V into its raw V buffer, with the tile's key bits
//     beside them; a word of 0 ends the stream. Wholly padded tiles are
//     neither loaded nor computed: they would add exp(-inf) = 0 and not move
//     the running max, so skipping is exact;
//   * warps 5..7 convert: K split in place into hi and lo rows; V transposed
//     to [dim][key] (TF32 wgmma reads only K-major operands) and split into
//     the stage's V^T, once the P V of two tiles back is done with it;
//   * P feeds the P V product from the S accumulator's registers: they hold
//     columns 2t, 2t+1 of each 8 where the A fragment wants t, t+4, so V^T
//     stores the keys of each 8 permuted (key 2c in column c, key 2c+1 in
//     column c+4);
//   * the tensor cores add into an accumulator rounding toward zero, so each
//     tile's P V goes into a fresh accumulator, small products first, and is
//     added to the rescaled O in software (one chain over 8192 keys drifts by
//     1e-4 of the output); S sums two fresh chains of 8 k-steps in software.
//     That brings S within float32 round-off of the plain version's, which
//     training needs: a ReLU input within ~1e-6 of 0 downstream takes the
//     side the plain version gives it (chip_smoke.py phase 5);
//   * online softmax in float32 registers: each row's max and sum reduce over
//     the 4 threads that share it; exp is the accurate expf, the output is
//     divided by the row sum, as the plain version divides the probabilities.
//     A row with no valid key keeps max -inf, is shifted by 0 (so its
//     probabilities are 0), ends with sum 0 and stores 0 and lse +inf;
//   * ragged T needs no padding: keys past T are masked, the epilogue stores
//     rows below T only; offsets into q and out are 64-bit.
//
// Shared memory (bytes; every part 1024-aligned for the 128-byte swizzle):
//   Q hi, lo               2 x 64 rows x 512    =  65,536
//   K hi, lo, 2 stages     2 x 2 x 32 x 512     =  65,536
//   raw V, 2 stages        2 x 32 x 512         =  32,768
//   V^T hi, lo, 2 stages   2 x 2 x 128 x 128    =  65,536
//   12 mbarriers, 2 key words 104, alignment slack 1,024: 230,504 of the
//   232,448 a block may use, so one block per SM. Three copies of the
//   operands (raw, hi, lo) leave no room for a third stage, a second
//   consumer warpgroup with its own Q rows, or 64-key tiles.
//
// Layouts: q, k, v and out (B, H, T, 128) float32, contiguous, 16-byte
// aligned; mask (B, T) bytes, nonzero at padded keys; lse (B, H, T) float32
// or null.

#include <math_constants.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace sm90;
using namespace tf32x3;

constexpr int kD = 128;                        // head dim
constexpr int kBq = 64;                        // query rows per block
constexpr int kBk = 32;                        // keys per tile (one warp's ballot)
constexpr int kWarpgroup = 128;                // warpgroup 0: the consumers
constexpr int kThreads = 2 * kWarpgroup;       // 1: producer, converters
constexpr int kConverters = kWarpgroup - 32;   // warps 5..7
constexpr uint32_t kQPart = kBq * kD * 4;      // one part of Q
constexpr uint32_t kTilePart = kBk * kD * 4;   // one part of a K or V tile
constexpr uint32_t kQChunk = kBq * 128;        // 32 columns of Q
constexpr uint32_t kKChunk = kBk * 128;        // 32 columns of a K or V tile
// A K stage keeps both parts of a 32-column chunk together, hi rows then lo
// rows, so that one m64n64 B operand reads [K hi; K lo]. TMA lands the raw
// tile in the hi rows; the converters split it in place.
constexpr uint32_t kKPartsChunk = 2 * kKChunk;
constexpr uint32_t kOffQhi = 0;
constexpr uint32_t kOffQlo = kOffQhi + kQPart;
constexpr uint32_t kOffK = kOffQlo + kQPart;               // [stage][hi, lo]
constexpr uint32_t kOffVraw = kOffK + 2 * 2 * kTilePart;   // [stage]
constexpr uint32_t kOffVt = kOffVraw + 2 * kTilePart;      // [stage][hi, lo]
constexpr uint32_t kOffBar = kOffVt + 2 * 2 * kTilePart;   // 6 per stage
constexpr uint32_t kOffKeys = kOffBar + 2 * 6 * 8;         // [stage]
constexpr size_t kSmemBytes = kOffKeys + 2 * 4 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

// The mbarriers of stage s (the live tiles n with n % 2 == s).
struct Stage {
  uint32_t loaded;    // K and raw V landed (the producer's expect_tx)
  uint32_t k_ready;   // K split (converter warps)
  uint32_t k_free;    // S done with K (consumer warps)
  uint32_t v_free;    // raw V read (converter warps)
  uint32_t vt_ready;  // V^T written (converter warps)
  uint32_t vt_free;   // P V done with V^T (consumer warps)
  __device__ Stage(uint32_t bars, int s)
      : loaded(bars + 8 * s), k_ready(bars + 16 + 8 * s),
        k_free(bars + 32 + 8 * s), v_free(bars + 48 + 8 * s),
        vt_ready(bars + 64 + 8 * s), vt_free(bars + 80 + 8 * s) {}
};

// Column of V^T that holds key `key` (0..31) of a tile: within each group of
// 8, key 2c goes to column c and key 2c + 1 to column c + 4, where P's A
// fragment reads the accumulator columns 2t and 2t + 1.
__device__ __forceinline__ uint32_t vt_column(uint32_t key) {
  return (key & ~7u) | ((key & 1u) << 2) | ((key & 7u) >> 1);
}

__device__ __forceinline__ float row_reduce_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_reduce_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Each warp arrives once, after all its lanes are done.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Producer warp: the only reader of the mask. For each live tile (one whose
// 32 keys are not all padded), in order, the n-th into stage n % 2: its key
// bits (bit c: key k0 + c valid) into the stage's word, K into the K
// stage's hi rows, V into the raw V buffer. After the last, a word of 0 and
// a bare arrival end the stream.
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const uint8_t* mrow, int t_len,
                                        int bh, uint32_t base, uint32_t bars,
                                        volatile uint32_t* keys) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kBk - 1) / kBk;
  int n = 0;
  for (int i = 0; i <= n_tiles; ++i) {
    const int key = i * kBk + lane;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, key < t_len && mrow[key] == 0);
    if (bits == 0 && i < n_tiles) continue;
    const int s = n & 1;
    const Stage st(bars, s);
    if (lane == 0) {
      const uint32_t free_parity = ((n >> 1) & 1) ^ 1;
      mbar_wait(st.k_free, free_parity);
      mbar_wait(st.v_free, free_parity);
      keys[s] = bits;
      if (bits == 0) {
        mbar_arrive(st.loaded);  // the end: no tile follows
      } else {
        mbar_expect_tx(st.loaded, 2 * kTilePart);
        const uint32_t kdst = base + kOffK + s * 2 * kTilePart;
        const uint32_t vdst = base + kOffVraw + s * kTilePart;
        for (int c = 0; c < kD / 32; ++c) {
          tma_load_3d(kdst + c * kKPartsChunk, tm_k, 32 * c, i * kBk, bh,
                      st.loaded);
          tma_load_3d(vdst + c * kKChunk, tm_v, 32 * c, i * kBk, bh,
                      st.loaded);
        }
      }
    }
    __syncwarp();
    ++n;
  }
}

// Converter warps: each landed tile into its TF32 parts. K in place (the hi
// rows rewritten, the lo rows 32 rows further, same swizzle); V transposed
// to [dim][key], the keys of each 8 permuted (vt_column), into the stage's
// V^T once the P V of two tiles back is done with it. For V, lane = key and
// warp w takes the float4 columns w, w + 3, ...: each store writes one dim
// row, 32 keys, 32 banks.
__device__ __forceinline__ void convert(uint8_t* smem, uint32_t bars,
                                        const volatile uint32_t* keys) {
  const int tid = threadIdx.x - (kWarpgroup + 32);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t col = vt_column(lane);
  for (int n = 0;; ++n) {
    const int s = n & 1;
    const Stage st(bars, s);
    const uint32_t parity = (n >> 1) & 1;
    mbar_wait(st.loaded, parity);
    if (keys[s] == 0) {  // the end: pass it on to the consumers
      warp_arrive(st.k_ready);
      return;
    }
    uint8_t* kparts = smem + kOffK + s * 2 * kTilePart;
    const uint8_t* vraw = smem + kOffVraw + s * kTilePart;
    uint8_t* vt = smem + kOffVt + s * 2 * kTilePart;
#pragma unroll 4
    for (int f = tid; f < (int)kTilePart / 16; f += kConverters) {
      uint8_t* hi = kparts + (f / (kKChunk / 16)) * kKPartsChunk +
                    16 * (f % (kKChunk / 16));
      store_split4(hi, hi + kKChunk, *reinterpret_cast<const float4*>(hi));
    }
    fence_proxy_async();
    warp_arrive(st.k_ready);
    mbar_wait(st.vt_free, parity ^ 1);
#pragma unroll 4
    for (int c4 = warp; c4 < kD / 4; c4 += kConverters / 32) {
      const float4 x = *reinterpret_cast<const float4*>(
          vraw + (c4 >> 3) * kKChunk + sw128(lane, c4 & 7));
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = sw128(4 * c4 + e, col >> 2) + 4 * (col & 3);
        float hi, lo;
        split(xs[e], hi, lo);
        *reinterpret_cast<float*>(vt + off) = hi;
        *reinterpret_cast<float*>(vt + kTilePart + off) = lo;
      }
    }
    fence_proxy_async();
    warp_arrive(st.vt_ready);
    warp_arrive(st.v_free);
  }
}

// S = Q K^T for one K stage over D = 128 at float32 accuracy: four TF32
// products per product (Q hi and Q lo each times [K hi; K lo], one m64n64
// per k-step and part of Q). The tensor cores add into an accumulator
// rounding toward zero, so each half of D (8 k-steps) starts a fresh chain;
// the halves, and in each the small parts before hi*hi, are summed in
// software. A half's registers 0..15 hold columns 0..31 (times K hi) and
// 16..31 columns 32..63 (times K lo), the m64n32 layout each.
__device__ __forceinline__ void scores(float (&sc)[16], float (&shi)[32],
                                       float (&slo)[32], uint32_t base,
                                       uint32_t k_parts) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wgmma_fence();
#pragma unroll
    for (int kk = 8 * half; kk < 8 * half + 8; ++kk) {
      const uint32_t qoff = (kk >> 2) * kQChunk + (kk & 3) * 32;
      const uint64_t kd =
          desc_sw128(k_parts + (kk >> 2) * kKPartsChunk + (kk & 3) * 32);
      wgmma_m64n64k8(slo, desc_sw128(base + kOffQlo + qoff), kd, kk & 7);
      wgmma_m64n64k8(shi, desc_sw128(base + kOffQhi + qoff), kd, kk & 7);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(slo);
    fence_operands(shi);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float part = ((slo[16 + c] + slo[c]) + shi[16 + c]) + shi[c];
      sc[c] = half == 0 ? part : sc[c] + part;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ q,
                     const uint8_t* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ lse, int n_head, int t_len,
                     float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kOffBar;
  volatile uint32_t* keys = reinterpret_cast<uint32_t*>(smem + kOffKeys);

  const int tid = threadIdx.x;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kBq;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      const Stage st(bars, s);
      mbar_init(st.loaded, 1);  // the producer's expect_tx
      mbar_init(st.k_ready, kConverters / 32);
      mbar_init(st.k_free, kWarpgroup / 32);
      mbar_init(st.v_free, kConverters / 32);
      mbar_init(st.vt_ready, kConverters / 32);
      mbar_init(st.vt_free, kWarpgroup / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWarpgroup + 32) {
    convert(smem, bars, keys);
    return;
  }
  if (tid >= kWarpgroup) {
    produce(&tm_k, &tm_v, mask + (int64_t)blockIdx.z * t_len, t_len, bh,
            base, bars, keys);
    return;
  }

  // Consumer warpgroup: the live tiles in order, tile n from stage n % 2.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows 16*warp + g and + 8
  const int t4 = lane & 3;  // accumulator columns 8j + 2*t4 and + 1
  const int64_t head = (int64_t)bh * t_len;

  // Q's rows [q0, q0 + 64), zero past T, split into its two parts.
  const float* qh = q + head * kD;
  for (int f = tid; f < kBq * kD / 4; f += kWarpgroup) {
    const int r = f >> 5;
    const int c4 = f & 31;  // float4 column: dims 4*c4 .. 4*c4 + 3
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t_len)
      x = *reinterpret_cast<const float4*>(qh + (int64_t)(q0 + r) * kD + 4 * c4);
    const uint32_t off = (c4 >> 3) * kQChunk + sw128(r, c4 & 7);
    store_split4(smem + kOffQhi + off, smem + kOffQlo + off, x);
  }
  fence_proxy_async();
  named_sync<1, kWarpgroup>();

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  // wgmma accumulators. Each chain's first wgmma ignores their value
  // (acc = 0), but they are defined once here so that no code reads an
  // indeterminate value.
  float shi[32], slo[32], pv[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) shi[i] = slo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) pv[i] = 0.f;

  for (int n = 0;; ++n) {
    const int s = n & 1;
    const Stage st(bars, s);
    const uint32_t parity = (n >> 1) & 1;
    mbar_wait(st.k_ready, parity);
    const uint32_t tile_keys = keys[s];
    if (tile_keys == 0) break;  // the end
    float sc[16];
    scores(sc, shi, slo, base, base + kOffK + s * 2 * kTilePart);
    warp_arrive(st.k_free);

    // Online softmax: rows h = 0 (16*warp + g) and h = 1 (+ 8); this
    // thread's keys k0 + 8j + 2*t4 + e.
    float rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = (tile_keys >> (8 * j + 2 * t4 + e)) & 1u ? x * sm_scale
                                                       : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], row_reduce_max(mx));
      const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[h] - shift);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = expf(x - shift);
          sum += x;
        }
      l[h] = l[h] * alpha + row_reduce_sum(sum);
      m[h] = m_new;
      rescale[h] = alpha;
    }

    // P's parts as A fragments, k-step j = keys 8j .. 8j + 7 (columns of
    // V^T permuted as vt_column): a = {sc[4j], sc[4j+2], sc[4j+1], sc[4j+3]}.
    uint32_t phi[4][4], plo[4][4];  // [k-step][fragment register]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split(sc[idx[r]], hi, lo);
        phi[j][r] = __float_as_uint(hi);
        plo[j][r] = __float_as_uint(lo);
      }
    }

    // This tile's P V in a fresh accumulator (the 8 small products first),
    // added to the rescaled O in software: chaining every tile's wgmma into
    // O would drift by the tensor cores' truncation over thousands of keys.
    const uint32_t vt = base + kOffVt + s * 2 * kTilePart;
    mbar_wait(st.vt_ready, parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n128k8_rs(pv, plo[j], desc_sw128(vt + 32 * j), j);
      wgmma_m64n128k8_rs(pv, phi[j], desc_sw128(vt + kTilePart + 32 * j), 1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_m64n128k8_rs(pv, phi[j], desc_sw128(vt + 32 * j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_operands(phi[j]);
      fence_operands(plo[j]);
    }
    warp_arrive(st.vt_free);
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[4 * c + r] = fmaf(o[4 * c + r], rescale[r >> 1], pv[4 * c + r]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= t_len) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    float* orow = out + (head + r) * kD + 2 * t4;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[4 * c + 2 * h] / denom, o[4 * c + 2 * h + 1] / denom);
    if (lse != nullptr && t4 == 0)
      lse[head + r] = l[h] == 0.f ? CUDART_INF_F : m[h] + logf(l[h]);
  }
}

}  // namespace

// q, k, v, out: (batch, n_head, t_len, 128) float32; mask: (batch, t_len)
// bytes; lse: (batch, n_head, t_len) float32, or null to store none.
// Returns cudaGetLastError() after the launch (0 on success), or the code of
// sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_fwd_f32(const float* q, const float* k,
                                 const float* v, const uint8_t* mask,
                                 float* out, float* lse, int batch,
                                 int n_head, int t_len, float sm_scale,
                                 void* stream) {
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  int err = make_tensor_map_f32(&tm_k, k, heads, t_len, kD, kBk);
  if (err == 0) err = make_tensor_map_f32(&tm_v, v, heads, t_len, kD, kBk);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  flash_mha_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_k, tm_v, q, mask, out, lse, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the kernel takes, in bytes (ptxas reports
// only static shared memory).
extern "C" int flash_mha_fwd_smem_bytes() { return (int)kSmemBytes; }

// Keys per tile, the unit in which the kernel skips wholly padded keys.
extern "C" int flash_mha_fwd_key_tile() { return kBk; }
