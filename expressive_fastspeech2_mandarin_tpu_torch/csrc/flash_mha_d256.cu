// Masked multi-head attention at head dim 256 in float32 (flash attention):
// the forward, written by hand for Hopper (sm_90a) on the TF32 tensor cores
// at float32 accuracy, with a plain C interface for ctypes. The backward at
// D = 256 is csrc/flash_mha_bwd_d256.cu.
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
// What bounds it: operations, as at D = 128 (T/4 flops a byte); the card's
// floor is 4 T^2 D flops over the live key tiles at the TF32 rate. The
// arithmetic is the D = 128 kernel's (csrc/flash_mha.cu): 3xTF32 products
// (tf32_wgmma.cuh) on K-major operands, S from four TF32 products in two
// fresh chains of 8 k-steps summed in software, each tile's P V (lo*hi,
// hi*lo, hi*hi) in a fresh accumulator added to the rescaled output in
// software, 32-key tiles, wholly padded tiles skipped, expf and a division
// by the row sum.
//
// Design: a cluster of kHeadChunks = D / 128 blocks for each 64 query
// rows, one block per 128-column chunk of the head dim (the backward's
// cluster, csrc/flash_mha_bwd_d256.cu). Block r (its rank in the cluster)
// holds columns [128 r, 128 r + 128) of Q and streams the same columns of
// each live K and V tile, so each block runs the D = 128 kernel's block:
//   * warpgroup 0 consumes: a *partial* S over the block's 128 columns
//     (exactly the D = 128 kernel's S), published in shared memory; the
//     other blocks' partials read through distributed shared memory (mapa,
//     ld.shared::cluster) and added in rank order, rank 0's first, so every
//     block forms the same S bits, hence the same running max, row sum, P
//     and lse; then the online softmax and the block's own output columns,
//     out[:, 128 r : 128 r + 128] = P V_r. Rank 0 alone stores lse;
//   * warp 4 produces (TMA, a two-stage mbarrier ring) and warps 5..7
//     convert (K split in place, V transposed and split), as at D = 128.
//     Every block reads the same mask, so all of them skip the same tiles
//     and end their streams at the same tile;
//   * the exchange goes through mbarriers, not cluster barriers: the
//     producer and converter warps run ahead on their own rings, and a
//     cluster-wide barrier would tie them to the consumers' tile. Each
//     consumer warp, once its partial is stored, arrives on the peer's
//     x_full (release at cluster scope); each waits on its own x_full
//     (acquire at cluster scope), reads and adds, then arrives on the
//     peer's x_free. The consumers wait only for the peer's partial
//     itself; the producer waits on x_free only before it reloads that
//     stage, two tiles later, so the peer's reading never holds a tile;
//   * all threads meet at a cluster barrier after the mbarriers' init and
//     before they exit: no block leaves while a peer may still read its
//     shared memory or arrive on its barriers.
//
// Shared memory. The D = 128 block takes 230,504 of the 232,448 bytes a
// block may use, and the exchange needs a 64 x 32 float32 partial (8 KB) a
// tile. Keeping Q raw and splitting it in registers as the A operand (as
// the backward's resident rows are) would free 32 KB, but the consumer
// then holds the output (64 registers), a tile's P V (64) and S's two
// accumulators (64) beside the A fragments of a chain of 8 k-steps (64):
// 256 registers of the 255 a thread may have, before an address. So Q
// stays split in shared memory and the partial goes into the stage's raw V
// buffer (16 KB), which the converters are done with once V^T is written:
// the consumer waits for vt_ready before it publishes, and the producer
// reloads the buffer only after the peer's x_free (in place of the D = 128
// kernel's v_free). Bytes (1024-aligned for the 128-byte swizzle):
//   Q hi, lo                         2 x 64 rows x 512    =  65,536
//   K hi, lo, 2 stages               2 x 2 x 32 x 512     =  65,536
//   raw V, 2 stages (the exchange)   2 x 32 x 512         =  32,768
//   V^T hi, lo, 2 stages             2 x 2 x 128 x 128    =  65,536
//   14 mbarriers 112, 2 key words 8, alignment slack 1,024: 230,520.
// 256 threads a block, one block an SM, clusters of kHeadChunks blocks
// (__cluster_dims__). D = 384 and 512 would be kHeadChunks = 3 and 4 with
// the same block; only D = 256 is built.
//
// Layouts: q, k, v, out (B, H, T, 256) float32, contiguous, 16-byte
// aligned; mask (B, T) bytes, nonzero at padded keys; lse (B, H, T) float32,
// or null.

#include <math_constants.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace sm90;
using namespace tf32x3;

constexpr int kHeadChunks = 2;                 // blocks of a cluster
constexpr int kCols = 128;                     // head-dim columns a block
constexpr int kD = kHeadChunks * kCols;        // head dim
constexpr int kBq = 64;                        // query rows per block
constexpr int kBk = 32;                        // keys per tile (one warp's ballot)
constexpr int kWarpgroup = 128;                // warpgroup 0: the consumers
constexpr int kThreads = 2 * kWarpgroup;       // 1: producer, converters
constexpr int kConverters = kWarpgroup - 32;   // warps 5..7
constexpr uint32_t kQPart = kBq * kCols * 4;   // one part of Q
constexpr uint32_t kTilePart = kBk * kCols * 4;  // one part of a K or V tile
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
constexpr uint32_t kOffBar = kOffVt + 2 * 2 * kTilePart;   // 7 per stage
constexpr uint32_t kOffKeys = kOffBar + 2 * 7 * 8;         // [stage]
constexpr size_t kSmemBytes = kOffKeys + 2 * 4 + 1024;
// A partial S: 64 rows x 32 keys, in the raw V buffer of its tile's stage.
static_assert(kBq * kBk * 4 <= kTilePart, "the exchange fits in raw V");
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

// The mbarriers of stage s (the live tiles n with n % 2 == s).
struct Stage {
  uint32_t loaded;    // K and raw V landed (the producer's expect_tx)
  uint32_t k_ready;   // K split (converter warps)
  uint32_t k_free;    // S done with K (consumer warps)
  uint32_t vt_ready;  // V^T written, raw V read (converter warps)
  uint32_t vt_free;   // P V done with V^T (consumer warps)
  uint32_t x_full;    // the peer's partial S published (its consumer warps)
  uint32_t x_free;    // the peer done reading this block's partial, so raw
                      // V may be reloaded (its consumer warps)
  __device__ Stage(uint32_t bars, int s)
      : loaded(bars + 8 * s), k_ready(bars + 16 + 8 * s),
        k_free(bars + 32 + 8 * s), vt_ready(bars + 48 + 8 * s),
        vt_free(bars + 64 + 8 * s), x_full(bars + 80 + 8 * s),
        x_free(bars + 96 + 8 * s) {}
};

// Hides a value from the compiler's loop-invariant code motion, so that
// the descriptors a loop-invariant shared address feeds are formed where
// they are used and not held in registers across the loop (as in
// csrc/flash_mha_bf16_d256.cu, whose dK/dV kernel spilled without it).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

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

// Each warp arrives once on the mbarrier at `bar` of every other block of
// the cluster, after all its lanes are done (release at cluster scope).
__device__ __forceinline__ void warp_arrive_peers(uint32_t bar,
                                                  uint32_t rank) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (uint32_t r = 0; r < kHeadChunks; ++r)
      if (r != rank) mbar_arrive_cluster(bar, r);
}

// Producer warp: the only reader of the mask. For each live tile (one whose
// 32 keys are not all padded), in order, the n-th into stage n % 2 once S
// is done with the stage's K and the peers are done with its raw V (the
// exchange of tile n - 2): its key bits (bit c: key k0 + c valid) into the
// stage's word, columns [col0, col0 + 128) of K into the K stage's hi rows
// and of V into the raw V buffer. After the last, a word of 0 and a bare
// arrival end the stream.
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const uint8_t* mrow, int t_len,
                                        int col0, int bh, uint32_t base,
                                        uint32_t bars,
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
      mbar_wait_cluster(st.x_free, free_parity);
      keys[s] = bits;
      if (bits == 0) {
        mbar_arrive(st.loaded);  // the end: no tile follows
      } else {
        mbar_expect_tx(st.loaded, 2 * kTilePart);
        const uint32_t kdst = base + kOffK + s * 2 * kTilePart;
        const uint32_t vdst = base + kOffVraw + s * kTilePart;
        for (int c = 0; c < kCols / 32; ++c) {
          tma_load_3d(kdst + c * kKPartsChunk, tm_k, col0 + 32 * c, i * kBk,
                      bh, st.loaded);
          tma_load_3d(vdst + c * kKChunk, tm_v, col0 + 32 * c, i * kBk, bh,
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
// row, 32 keys, 32 banks. vt_ready also tells the consumers that raw V is
// read, so the exchange may take it.
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
    for (int c4 = warp; c4 < kCols / 4; c4 += kConverters / 32) {
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
  }
}

// The block's partial S = Q K^T over its 128 columns for one K stage at
// float32 accuracy: four TF32 products per product (Q hi and Q lo each times
// [K hi; K lo], one m64n64 per k-step and part of Q). The tensor cores add
// into an accumulator rounding toward zero, so each half of the 128
// columns (8 k-steps) starts a fresh chain; the halves, and in each the
// small parts before hi*hi, are summed in software into sc, which starts
// at 0 (the rule of csrc/tf32_flash_bwd.cuh's rows_product: when the first
// half's sum defined sc, S came out as twice the second half). A half's
// registers 0..15 hold columns 0..31 (times K hi) and 16..31 columns
// 32..63 (times K lo), the m64n32 layout each.
__device__ __forceinline__ void scores(float (&sc)[16], float (&shi)[32],
                                       float (&slo)[32], uint32_t base,
                                       uint32_t k_parts) {
#pragma unroll
  for (int c = 0; c < 16; ++c) sc[c] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wgmma_fence();
    fence_operands(shi);
    fence_operands(slo);
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
    for (int c = 0; c < 16; ++c)
      sc[c] += ((slo[16 + c] + slo[c]) + shi[16 + c]) + shi[c];
  }
}

// This block's partial x (m64n32 layout) into its exchange buffer `mine`,
// where the cluster's other blocks read it: one float4 a column quarter.
__device__ __forceinline__ void publish(uint8_t* mine, const float (&x)[16],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(mine + (i * kWarpgroup + tid) * 16) =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// x = the sum of the cluster's partials, rank 0's first: this block's own
// from registers, the others' from their exchange buffers at shared address
// `mine` (the same offset in every block).
__device__ __forceinline__ void gather(float (&x)[16], uint32_t mine,
                                       uint32_t rank, int tid) {
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
        const float4 y = ld_cluster4(peer + (i * kWarpgroup + tid) * 16);
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

// The consumer warpgroup: the live tiles in order, tile n from stage n % 2.
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t base,
                                        uint32_t bars,
                                        const volatile uint32_t* keys,
                                        const float* __restrict__ q,
                                        float* __restrict__ out,
                                        float* __restrict__ lse, int64_t head,
                                        int q0, int col0, uint32_t rank,
                                        int t_len, float sm_scale) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows 16*warp + g and + 8
  const int t4 = lane & 3;  // accumulator columns 8j + 2*t4 and + 1

  // Q's rows [q0, q0 + 64), columns [col0, col0 + 128), zero past T, split
  // into its two parts.
  const float* qh = q + head * kD + col0;
  for (int f = tid; f < kBq * kCols / 4; f += kWarpgroup) {
    const int r = f >> 5;
    const int c4 = f & 31;  // float4 column: dims 4*c4 .. 4*c4 + 3
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t_len)
      x = *reinterpret_cast<const float4*>(qh + (int64_t)(q0 + r) * kD +
                                           4 * c4);
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
    if (tile_keys == 0) break;  // the end (the same tile in every block)
    const uint32_t b = opaque(base);
    float sc[16];
    scores(sc, shi, slo, b, b + kOffK + s * 2 * kTilePart);
    warp_arrive(st.k_free);

    // The exchange, in raw V of this stage once the converters have read
    // it: publish, tell the peers, wait for theirs, add in rank order, and
    // tell the peers theirs are read.
    const uint32_t xs = kOffVraw + s * kTilePart;
    mbar_wait(st.vt_ready, parity);
    publish(smem + xs, sc, tid);
    fence_proxy_async();  // before the producer's TMA rewrites raw V
    warp_arrive_peers(st.x_full, rank);
    mbar_wait_cluster(st.x_full, parity);
    gather(sc, b + xs, rank, tid);
    warp_arrive_peers(st.x_free, rank);

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
      fence_operands(phi[j]);
      fence_operands(plo[j]);
    }

    // This tile's P V over the block's 128 output columns in a fresh
    // accumulator (the 8 small products first), added to the rescaled O in
    // software: chaining every tile's wgmma into O would drift by the
    // tensor cores' truncation over thousands of keys. V^T is ready: the
    // exchange waited for it.
    const uint32_t vt = b + kOffVt + s * 2 * kTilePart;
    wgmma_fence();
    fence_operands(pv);
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
    float* orow = out + (head + r) * kD + col0 + 2 * t4;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[4 * c + 2 * h] / denom, o[4 * c + 2 * h + 1] / denom);
    if (lse != nullptr && rank == 0 && t4 == 0)
      lse[head + r] = l[h] == 0.f ? CUDART_INF_F : m[h] + logf(l[h]);
  }
}

__global__ void __cluster_dims__(kHeadChunks, 1, 1)
    __launch_bounds__(kThreads, 1)
flash_mha_fwd_d256_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ q,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ lse,
                          int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kOffBar;
  volatile uint32_t* keys = reinterpret_cast<uint32_t*>(smem + kOffKeys);

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int col0 = kCols * rank;
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = (blockIdx.x / kHeadChunks) * kBq;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      const Stage st(bars, s);
      mbar_init(st.loaded, 1);  // the producer's expect_tx
      mbar_init(st.k_ready, kConverters / 32);
      mbar_init(st.k_free, kWarpgroup / 32);
      mbar_init(st.vt_ready, kConverters / 32);
      mbar_init(st.vt_free, kWarpgroup / 32);
      mbar_init(st.x_full, (kHeadChunks - 1) * kWarpgroup / 32);
      mbar_init(st.x_free, (kHeadChunks - 1) * kWarpgroup / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every block's mbarriers initialised

  if (tid >= kWarpgroup + 32) {
    convert(smem, bars, keys);
  } else if (tid >= kWarpgroup) {
    produce(&tm_k, &tm_v, mask + (int64_t)blockIdx.z * t_len, t_len, col0,
            bh, base, bars, keys);
  } else {
    consume(smem, base, bars, keys, q, out, lse, (int64_t)bh * t_len, q0,
            col0, rank, t_len, sm_scale);
  }
  __syncwarp();
  cluster_sync();  // no peer reads this block's shared memory any more
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The forward. q, k, v, out: (batch, n_head, t_len, 256) float32; mask:
// (batch, t_len) bytes; lse: (batch, n_head, t_len) float32, or null to
// store none. Returns cudaGetLastError() after the launch (0 on success; a
// refused cluster launch is its error), or the code of
// sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_fwd_f32_d256(const float* q, const float* k,
                                      const float* v, const uint8_t* mask,
                                      float* out, float* lse, int batch,
                                      int n_head, int t_len, float sm_scale,
                                      void* stream) {
  // The runtime call first: it makes the device's context current in this
  // thread, which cuTensorMapEncodeTiled needs.
  int err = set_smem(flash_mha_fwd_d256_kernel, kSmemBytes);
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0) err = make_tensor_map_f32(&tm_k, k, heads, t_len, kD, kBk);
  if (err == 0) err = make_tensor_map_f32(&tm_v, v, heads, t_len, kD, kBk);
  if (err != 0) return err;
  const dim3 grid(kHeadChunks * ((t_len + kBq - 1) / kBq), n_head, batch);
  flash_mha_fwd_d256_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      tm_k, tm_v, q, mask, out, lse, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the forward's block, in bytes (ptxas reports
// only static shared memory).
extern "C" int flash_mha_d256_smem_bytes() { return (int)kSmemBytes; }

// Keys per tile, the unit in which the forward skips wholly padded keys.
extern "C" int flash_mha_d256_key_tile() { return kBk; }

// Blocks of a cluster: the 128-column chunks of the head dim.
extern "C" int flash_mha_d256_cluster() { return kHeadChunks; }
