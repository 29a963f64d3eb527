// Masked multi-head attention backward (flash attention), written by hand
// for Hopper (sm_90a) on the tensor cores, with a plain C interface for
// ctypes.
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
//   * the dQ kernel: a block per (b, h, 64 query rows). It writes Δ for its
//     rows, then streams the key tiles with a valid key, recomputing S, dP,
//     P and dS, and accumulates dq;
//   * the dK/dV kernel, launched after it on the same stream: a block per
//     (b, h, 64 keys). A block whose keys are all padded writes zeros and
//     exits; the others stream every query tile (padded queries too: they
//     have dO and count for dk, dv), reading the Δ the dQ kernel wrote, and
//     accumulate dk and dv.
//
// What bounds it: operations. The backward recomputes S and dP in both
// kernels and forms dq, dk and dv: 14*B*H*T^2*D flops over the live tiles
// against ~40*B*H*T*D bytes, T/3 flops a byte. The card's floor is one
// TF32 product over the live tiles at 495 TF/s; float32 accuracy costs
// three TF32 products a product, as in the forward (tf32_wgmma.cuh); S,
// whose error exp(s - lse) magnifies, and dP take a fourth, lo*lo, which
// their stacked B operand (below) gives in the same instruction. What
// binds first is shared memory and registers: a TF32 wgmma reads only
// K-major operands, and the third product of each kernel runs along the
// dimension the streamed tile is not K-major in (dq = dS K needs K^T;
// dk, dv need Q^T, dO^T). Split copies of those transposes do not fit
// beside two stages, and one warpgroup cannot hold dk and dv (128
// registers a thread) beside S, dP and their operands.
//
// Design (a block: 256 threads, two consumer warpgroups; 230,688 B (dQ)
// and 230,928 B (dK/dV) of shared memory, one block per SM):
//   * the block's 64 resident rows (Q and dO for dQ; K and V for dK/dV)
//     stay raw, in one copy, and feed S and dP as the register (A)
//     operand: each k-step's fragment is loaded with ld.shared and split
//     into hi and lo in registers;
//   * 32-row tiles of the streamed operands (K and V for dQ; Q and dO for
//     dK/dV) come by TMA through a two-stage mbarrier ring, one tile ahead:
//     warp 0 issues tile n + 1 as tile n starts, and warpgroup 1, once its
//     dP of tile n is done (before warpgroup 0's S), splits tile n + 1 in
//     place into hi rows and lo rows ([hi; lo] per 32-column chunk);
//   * warpgroup 0 computes S (S^T in dK/dV) and P; warpgroup 1 at the
//     same time dP (dP^T), and then dS from P. Both take four TF32
//     products, as two m64n64k8 a k-step whose B is the streamed tile's
//     [hi; lo] rows of a chunk (so lo*lo comes in the same instruction as
//     lo*hi), A from registers; four m64n32 a k-step were no faster.
//     Chains of kChain k-steps, each fresh, summed in software;
//   * the third products are taken transposed, so that no transposed copy
//     is needed: dq^T = K^T dS^T, dk^T = Q^T dS, dv^T = dO^T P. Their A
//     operand is the streamed tile read column-wise from its hi and lo
//     rows (already split); their B operand is dS (or P^T, dS^T) written
//     from the accumulator registers, split, into a 64 x 32 swizzled tile,
//     which is K-major as it stands. Warpgroup w forms the dims
//     [64 w, 64 w + 64) of the output: one m64n64k8 chain a tile of lo*hi,
//     hi*lo, hi*hi in a fresh accumulator, added to the running sum in
//     software (the tensor cores truncate as they accumulate: one chain
//     over thousands of rows drifts). So each thread holds 32 running
//     floats for dq, 64 for dk and dv;
//   * in dK/dV warpgroup 1 reads P back from the staged tile as hi + lo
//     (within 2^-22 of P); in dQ P goes through a raw float32 buffer;
//   * the dQ kernel reads the mask once, into a map of each key tile's key
//     bits in shared memory (the first 2048 tiles; past them warp 0 reads
//     the mask); warp 0 skips key tiles with no valid key (exact: they add
//     exp(-inf) = 0) and ends the stream with a word of 0. The dK/dV
//     kernel reads the mask for its own 64 keys;
//   * lse and Δ of a query tile come by cp.async, 4 bytes a lane
//     (head*T + q0 is not 16-byte aligned for every T), counted on the
//     tile's mbarrier, so that no consumer warp waits on device memory;
//     past T they read as 0, where Q and dO are 0, so those queries add
//     exactly 0;
//   * ragged T needs no padding; offsets are 64-bit; exp is the accurate
//     expf.
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 128) float32,
// contiguous, 16-byte aligned; mask (B, T) bytes, nonzero at padded keys;
// lse and delta (B, H, T) float32.

#include <math_constants.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace sm90;
using namespace tf32x3;

constexpr int kD = 128;                      // head dim
constexpr int kRows = 64;                    // resident rows per block
constexpr int kTile = 32;                    // rows per streamed tile
constexpr int kWarpgroup = 128;
constexpr int kThreads = 2 * kWarpgroup;     // two consumer warpgroups
constexpr int kSteps = kD / 8;               // k-steps of S and dP
constexpr int kChain = 4;                    // k-steps per fresh S/dP chain
// A resident tile: four chunks of 32 columns, 64 rows each, raw.
constexpr uint32_t kResChunk = kRows * 128;
constexpr uint32_t kResTile = 4 * kResChunk;
// A streamed tile: four chunks of 32 columns, each 32 hi rows then 32 lo
// rows (4096 B apart), which one m64n64 B operand reads together.
constexpr uint32_t kStChunk = 2 * kTile * 128;
constexpr uint32_t kStLo = kTile * 128;
constexpr uint32_t kStTile = 4 * kStChunk;
constexpr uint32_t kStage = 2 * kStTile;     // two streamed operands
// A staged operand part: 64 rows x 32 columns, one swizzled chunk.
constexpr uint32_t kAccPart = kRows * 128;
constexpr uint32_t kOffRes = 0;              // two resident operands
constexpr uint32_t kOffStage = 2 * kResTile;  // [stage]
constexpr uint32_t kOffAcc = kOffStage + 2 * kStage;
// dQ: dS hi, lo; P raw; Δ of the rows; the key words.
constexpr uint32_t kDqOffP = kOffAcc + 2 * kAccPart;
constexpr uint32_t kDqOffDelta = kDqOffP + kRows * kTile * 4;
constexpr uint32_t kDqOffBar = kDqOffDelta + kRows * 4;
constexpr uint32_t kDqOffWords = kDqOffBar + 2 * 8;
// The key bits of the first kMapTiles key tiles, read once at the start.
constexpr int kMapTiles = 2048;
constexpr uint32_t kDqOffMap = kDqOffWords + 16;
constexpr size_t kDqSmemBytes = kDqOffMap + kMapTiles * 4 + 1024;
// dK/dV: P^T hi, lo, dS^T hi, lo; lse and Δ of each stage's queries.
constexpr uint32_t kDkvOffStats = kOffAcc + 4 * kAccPart;
constexpr uint32_t kDkvOffBar = kDkvOffStats + 2 * 2 * kTile * 4;
constexpr size_t kDkvSmemBytes = kDkvOffBar + 2 * 8 + 1024;
static_assert(kDqSmemBytes <= 232448 && kDkvSmemBytes <= 232448,
              "more shared memory than a block may use");

__device__ __forceinline__ uint32_t loaded_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}

// Both streamed tiles of stage `dst` (hi rows of each chunk), by TMA.
__device__ __forceinline__ void load_stage(const CUtensorMap* tm0,
                                           const CUtensorMap* tm1, int row,
                                           int bh, uint32_t dst,
                                           uint32_t bar) {
  mbar_expect_tx(bar, 2 * kTile * kD * 4);
  for (int c = 0; c < kD / 32; ++c) {
    tma_load_3d(dst + c * kStChunk, tm0, 32 * c, row, bh, bar);
    tma_load_3d(dst + kStTile + c * kStChunk, tm1, 32 * c, row, bh, bar);
  }
}

// Threads [0, n): a landed stage's two tiles split in place, hi rows
// rewritten, lo rows 32 rows further (same swizzle).
template <int n>
__device__ __forceinline__ void split_stage(uint8_t* stage, int tid) {
  constexpr int kPerTile = kTile * kD / 4;  // float4 of one part
#pragma unroll
  for (int f = tid; f < 2 * kPerTile; f += n) {
    const int x = f % kPerTile;
    uint8_t* hi = stage + (f / kPerTile) * kStTile +
                  (x / (kStLo / 16)) * kStChunk + 16 * (x % (kStLo / 16));
    store_split4(hi, hi + kStLo, *reinterpret_cast<const float4*>(hi));
  }
  fence_proxy_async();
}

// Rows [r0, r0 + 64) of one head's (T, 128) matrix, raw, zero past T, into
// a resident tile (all threads).
__device__ __forceinline__ void load_resident(uint8_t* dst, const float* src,
                                              int r0, int t_len) {
  for (int f = threadIdx.x; f < kRows * kD / 4; f += kThreads) {
    const int r = f >> 5, c4 = f & 31;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t_len)
      x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * kD +
                                           4 * c4);
    *reinterpret_cast<float4*>(dst + (c4 >> 3) * kResChunk +
                               sw128(r, c4 & 7)) = x;
  }
}

// out (64 x 32, m64n32 layout) = A B^T over D = 128: A the resident tile
// (raw; each fragment split in registers), B the streamed tile at shared
// address `b` ([hi; lo] per chunk). Four TF32 products as two m64n64k8
// a k-step, each with both parts of B as its 64 columns: A hi times
// [B hi; B lo] into `hi` (hi*hi in columns 0..31, hi*lo in 32..63), A lo
// times [B hi; B lo] into `lo`. Each chain of kChain k-steps starts fresh
// and is summed in software, small products first; then the chains. (out
// starts at 0 and takes every chain's sum: ptxas returned wrong sums when
// the first chain's sum defined it.)
__device__ __forceinline__ void rows_product(float (&out)[16],
                                             float (&hi)[32], float (&lo)[32],
                                             const uint8_t* a, uint32_t b) {
#pragma unroll
  for (int c = 0; c < 16; ++c) out[c] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < kSteps; c0 += kChain) {
    uint32_t ahi[kChain][4], alo[kChain][4];
#pragma unroll
    for (int i = 0; i < kChain; ++i) {
      load_split_frag<false>(ahi[i], alo[i], a, 0, 8 * (c0 + i), kResChunk);
      fence_operands(ahi[i]);
      fence_operands(alo[i]);
    }
    wgmma_fence();
    fence_operands(hi);
    fence_operands(lo);
#pragma unroll
    for (int i = 0; i < kChain; ++i) {
      const int kk = c0 + i;
      const uint64_t bk =
          desc_sw128(b + (kk >> 2) * kStChunk + (kk & 3) * 32);
      wgmma_m64n64k8_rs(lo, alo[i], bk, i);
      wgmma_m64n64k8_rs(hi, ahi[i], bk, i);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(hi);
    fence_operands(lo);
#pragma unroll
    for (int i = 0; i < kChain; ++i) {
      fence_operands(ahi[i]);
      fence_operands(alo[i]);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c)
      out[c] += ((lo[16 + c] + lo[c]) + hi[16 + c]) + hi[c];
  }
}

// acc (64 x 64, m64n64 layout) += rows [64 half, 64 half + 64) of A^T B
// over the 32 streamed rows: A the streamed tile at `a` ([hi; lo] per
// chunk, read column-wise: A^T(m, k) = tile(k, 64 half + m)), B the staged
// tile whose hi part is at shared address `b` and lo part at b + kAccPart
// (rows n, columns k). Three products in a fresh accumulator (lo*hi and
// hi*lo first), added to acc in software.
__device__ __forceinline__ void cols_product(float (&acc)[32],
                                             float (&fresh)[32],
                                             const uint8_t* a, int half,
                                             uint32_t b) {
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_parts_frag<true>(ahi[kk], alo[kk], a, a + kStLo, 8 * kk, 64 * half,
                          kStChunk);
    fence_operands(ahi[kk]);
    fence_operands(alo[kk]);
  }
  wgmma_fence();
  fence_operands(fresh);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k8_rs(fresh, alo[kk], desc_sw128(b + 32 * kk), kk);
    wgmma_m64n64k8_rs(fresh, ahi[kk], desc_sw128(b + kAccPart + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k8_rs(fresh, ahi[kk], desc_sw128(b + 32 * kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(fresh);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_operands(ahi[kk]);
    fence_operands(alo[kk]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += fresh[i];
}

// Byte offset in a staged 64 x 32 tile of accumulator register 4j + 2h + e
// (row 16w + g + 8h, column 8j + 2t + e; w the warp in its warpgroup),
// swizzled as a K-major B operand reads it.
__device__ __forceinline__ uint32_t staged_offset(int j, int h) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  return sw128(16 * warp + 8 * h + (lane >> 2), 2 * j + ((lane & 3) >> 1)) +
         8 * (lane & 1);
}

// The m64n32 accumulator x, split, into a staged tile (hi at `dst`, lo
// kAccPart further).
__device__ __forceinline__ void stage_parts(uint8_t* dst,
                                            const float (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = staged_offset(j, h);
      float2 hi, lo;
      split(x[4 * j + 2 * h], hi.x, lo.x);
      split(x[4 * j + 2 * h + 1], hi.y, lo.y);
      *reinterpret_cast<float2*>(dst + off) = hi;
      *reinterpret_cast<float2*>(dst + kAccPart + off) = lo;
    }
}

// The values a stage_parts of the same thread wrote, as hi + lo.
__device__ __forceinline__ void read_staged(float (&x)[16],
                                            const uint8_t* src) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = staged_offset(j, h);
      const float2 hi = *reinterpret_cast<const float2*>(src + off);
      const float2 lo = *reinterpret_cast<const float2*>(src + kAccPart + off);
      x[4 * j + 2 * h] = hi.x + lo.x;
      x[4 * j + 2 * h + 1] = hi.y + lo.y;
    }
}

// Rows [r0, r0 + 64), dims [64 half, 64 half + 64) of a (T, 128) output from
// the running m64n64 accumulator (row m: dim 64 half + m; column n: the
// output's row r0 + n), times scale; rows past T are not stored.
__device__ __forceinline__ void store_transposed(float* dst,
                                                 const float (&acc)[32],
                                                 int half, int r0, int t_len,
                                                 float scale) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * j + 2 * t4 + e;
      if (r >= t_len) continue;
      float* row = dst + (int64_t)r * kD + 64 * half + 16 * warp + g;
      row[0] = acc[4 * j + e] * scale;
      row[8] = acc[4 * j + 2 + e] * scale;
    }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& base) {
  const uint32_t addr = smem_addr(raw);
  base = (addr + 1023u) & ~1023u;
  return raw + (base - addr);
}

// ---------------------------------------------------------------------------
// The dQ kernel.

// Key bits of tile i (bit c: key 32 i + c valid), one tile a thread.
__device__ __forceinline__ uint32_t tile_bits(const uint8_t* mrow, int t_len,
                                              int i) {
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    const int key = i * kTile + c;
    bits |= (uint32_t)(key < t_len && mrow[key] == 0) << c;
  }
  return bits;
}

// Warp 0: the next live key tile after tile `after` (one whose 32 keys are
// not all padded) goes into stage s: its key bits into the stage's word,
// K and V by TMA (lane 0). Past the last, a word of 0 and a bare arrival
// end the stream. The first kMapTiles tiles' bits come from the map; past
// it, from the mask. Returns the tile's index.
__device__ __forceinline__ int next_key_tile(const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             const uint8_t* mrow, int t_len,
                                             int bh, int after, int s,
                                             uint32_t base, uint32_t bars,
                                             volatile uint32_t* words,
                                             const uint32_t* map) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kTile - 1) / kTile;
  int i = after + 1;
  uint32_t bits = 0;
  for (; i < n_tiles; ++i) {
    const int key = i * kTile + lane;
    bits = i < kMapTiles ? map[i]
                         : __ballot_sync(0xffffffffu,
                                         key < t_len && mrow[key] == 0);
    if (bits != 0) break;
  }
  if (lane == 0) {
    words[s] = bits;
    if (bits == 0)
      mbar_arrive(loaded_bar(bars, s));  // the end: no tile follows
    else
      load_stage(tm_k, tm_v, i * kTile, bh, base + kOffStage + s * kStage,
                 loaded_bar(bars, s));
  }
  __syncwarp();
  return i;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ q,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ out,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int n_head, int t_len, float sm_scale) {
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
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  uint32_t* map = reinterpret_cast<uint32_t*>(smem + kDqOffMap);
  const int n_map = min((t_len + kTile - 1) / kTile, kMapTiles);
  for (int i = tid; i < n_map; i += kThreads)
    map[i] = tile_bits(mrow, t_len, i);
  if (tid == 0) {
    mbar_init(loaded_bar(bars, 0), 1);
    mbar_init(loaded_bar(bars, 1), 1);
    mbar_init_fence();
  }
  __syncthreads();
  int tile = -1;
  if (warp == 0)
    tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, bh, tile, 0, base, bars,
                         words, map);

  uint8_t* qs = smem + kOffRes;
  uint8_t* dos = qs + kResTile;
  load_resident(qs, q + head * kD, q0, t_len);
  load_resident(dos, dout + head * kD, q0, t_len);
  // Δ of the block's rows, 8 a warp (32 lanes x float4 = 128 dims); rows
  // past T get 0 (their P is 0).
  for (int i = 0; i < kRows / 8; ++i) {
    const int r = 8 * warp + i;
    float part = 0.f;
    if (q0 + r < t_len) {
      const int64_t off = (head + q0 + r) * kD + 4 * lane;
      const float4 o = *reinterpret_cast<const float4*>(out + off);
      const float4 d = *reinterpret_cast<const float4*>(dout + off);
      part = fmaf(o.x, d.x, fmaf(o.y, d.y, fmaf(o.z, d.z, o.w * d.w)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      delta_s[r] = part;
      if (q0 + r < t_len) delta[head + q0 + r] = part;
    }
  }
  __syncthreads();
  // This thread's rows: 16 (warp % 4) + g + 8h.
  float lse_r[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * (warp & 3) + g + 8 * h;
    lse_r[h] = q0 + r < t_len ? lse[head + q0 + r] : CUDART_INF_F;
    dlt[h] = delta_s[r];
  }

  // Running dq^T of this warpgroup's half of the dims (rows: dims
  // 64 wg + m; columns: the block's rows) and the wgmma accumulators,
  // defined once here (each chain's first wgmma ignores their value).
  float dqt[32], fresh[32], hi[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqt[i] = fresh[i] = hi[i] = lo[i] = 0.f;
  uint8_t* ds_st = smem + kOffAcc;

  // The first tile is split by all threads; every later one by warpgroup
  // 1, which finishes dP before warpgroup 0 finishes S, in the tile
  // before it.
  mbar_wait(loaded_bar(bars, 0), 0);
  if (words[0] != 0) split_stage<kThreads>(smem + kOffStage, tid);

  for (int n = 0;; ++n) {
    const int s = n & 1;
    mbar_wait(loaded_bar(bars, s), (n >> 1) & 1);
    const uint32_t keys = words[s];
    if (keys == 0) break;  // the end
    uint8_t* stage = smem + kOffStage + s * kStage;
    // Every thread is past tile n - 1: stage s ^ 1 and the staged dS and
    // P are free, and tile n is split.
    __syncthreads();
    if (warp == 0)
      tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, bh, tile, s ^ 1, base,
                           bars, words, map);
    const uint32_t kst = base + kOffStage + s * kStage;
    float x[16];
    if (wg == 0) {
      rows_product(x, hi, lo, qs, kst);  // S = Q K^T
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
    } else {
      rows_product(x, hi, lo, dos, kst + kStTile);  // dP = dO V^T
      mbar_wait(loaded_bar(bars, s ^ 1), ((n + 1) >> 1) & 1);
      if (words[s ^ 1] != 0)
        split_stage<kWarpgroup>(smem + kOffStage + (s ^ 1) * kStage, wtid);
    }
    __syncthreads();  // P written, tile n + 1 split
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
  store_transposed(dq + head * kD, dqt, wg, q0, t_len, sm_scale);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel.

// Warp 0: query tile i into stage s: its lse and Δ by the lanes with
// cp.async (0 past T, where Q and dO read as 0 too, so those queries add
// exactly 0), counted on the stage's mbarrier; Q and dO by TMA (lane 0).
__device__ __forceinline__ void load_query_tile(const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do,
                                                const float* lse,
                                                const float* delta,
                                                int t_len, int bh, int i,
                                                int s, uint32_t base,
                                                uint32_t bars) {
  const int lane = threadIdx.x & 31;
  const bool in = i * kTile + lane < t_len;
  const int64_t r = (int64_t)bh * t_len + (in ? i * kTile + lane : 0);
  const uint32_t dst = base + kDkvOffStats + (s * 2 * kTile + lane) * 4;
  cp_async4(dst, lse + r, in ? 4 : 0);
  cp_async4(dst + kTile * 4, delta + r, in ? 4 : 0);
  cp_async_mbar_arrive(loaded_bar(bars, s));
  __syncwarp();
  if (lane == 0)
    load_stage(tm_q, tm_do, i * kTile, bh, base + kOffStage + s * kStage,
               loaded_bar(bars, s));
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;

  // A block whose keys are all padded: dk and dv are 0 there.
  const bool live = tid < kRows && k0 + tid < t_len && mrow[k0 + tid] == 0;
  if (!__syncthreads_or(live)) {
    for (int f = tid; f < kRows * kD / 4; f += kThreads) {
      const int r = k0 + (f >> 5);
      if (r >= t_len) continue;
      const int64_t off = (head + r) * kD + 4 * (f & 31);
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
    load_query_tile(&tm_q, &tm_do, lse, delta, t_len, bh, 0, 0, base, bars);

  uint8_t* ks = smem + kOffRes;
  uint8_t* vs = ks + kResTile;
  load_resident(ks, k + head * kD, k0, t_len);
  load_resident(vs, v + head * kD, k0, t_len);
  // This thread's keys: 16 (warp % 4) + g + 8h.
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * (warp & 3) + g + 8 * h;
    valid[h] = key < t_len && mrow[key] == 0;
  }
  __syncthreads();

  // Running dk^T and dv^T of this warpgroup's half of the dims (rows: dims
  // 64 wg + m; columns: the block's keys) and the wgmma accumulators,
  // defined once here.
  float dkt[32], dvt[32], fresh[32], hi[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dkt[i] = dvt[i] = fresh[i] = hi[i] = lo[i] = 0.f;
  uint8_t* p_st = smem + kOffAcc;            // P^T hi, lo
  uint8_t* ds_st = p_st + 2 * kAccPart;      // dS^T hi, lo

  // The first tile is split by all threads; every later one by warpgroup
  // 1, which finishes dP^T before warpgroup 0 finishes S^T, in the tile
  // before it.
  mbar_wait(loaded_bar(bars, 0), 0);
  split_stage<kThreads>(smem + kOffStage, tid);

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n & 1;
    mbar_wait(loaded_bar(bars, s), (n >> 1) & 1);
    uint8_t* stage = smem + kOffStage + s * kStage;
    // Every thread is past tile n - 1: stage s ^ 1, its row stats and the
    // staged P^T and dS^T are free, and tile n is split.
    __syncthreads();
    if (warp == 0 && n + 1 < n_tiles)
      load_query_tile(&tm_q, &tm_do, lse, delta, t_len, bh, n + 1, s ^ 1,
                      base, bars);
    const uint32_t qst = base + kOffStage + s * kStage;
    const float* lse_s = stats + s * 2 * kTile;
    const float* dlt_s = lse_s + kTile;
    float x[16];
    if (wg == 0) {
      rows_product(x, hi, lo, ks, qst);  // S^T = K Q^T
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
    } else {
      rows_product(x, hi, lo, vs, qst + kStTile);  // dP^T = V dO^T
      if (n + 1 < n_tiles) {
        mbar_wait(loaded_bar(bars, s ^ 1), ((n + 1) >> 1) & 1);
        split_stage<kWarpgroup>(smem + kOffStage + (s ^ 1) * kStage, wtid);
      }
    }
    __syncthreads();  // P^T staged, tile n + 1 split
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
  store_transposed(dk + head * kD, dkt, wg, k0, t_len, sm_scale);
  store_transposed(dv + head * kD, dvt, wg, k0, t_len, 1.f);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The dQ kernel; also writes delta (B, H, T) = rowsum(dout * out) for the
// dK/dV kernel. Returns cudaGetLastError() after the launch (0 on success),
// or the code of sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_bwd_dq_f32(const float* q, const float* k,
                                    const float* v, const uint8_t* mask,
                                    const float* out, const float* dout,
                                    const float* lse, float* delta,
                                    float* dq, int batch, int n_head,
                                    int t_len, float sm_scale, void* stream) {
  // The runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward in its own), which the driver's
  // tensor-map encoder needs.
  int err = set_smem(flash_mha_bwd_dq_kernel, kDqSmemBytes);
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0) err = make_tensor_map_f32(&tm_k, k, heads, t_len, kD, kTile);
  if (err == 0) err = make_tensor_map_f32(&tm_v, v, heads, t_len, kD, kTile);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes,
                            (cudaStream_t)stream>>>(
      tm_k, tm_v, q, mask, out, dout, lse, delta, dq, n_head, t_len,
      sm_scale);
  return (int)cudaGetLastError();
}

// The dK/dV kernel; reads the delta the dQ kernel wrote. Returns
// cudaGetLastError() after the launch (0 on success), or the code of
// sm90::make_tensor_map_f32 if a tensor map cannot be made.
extern "C" int flash_mha_bwd_dkv_f32(const float* q, const float* k,
                                     const float* v, const uint8_t* mask,
                                     const float* dout, const float* lse,
                                     const float* delta, float* dk,
                                     float* dv, int batch, int n_head,
                                     int t_len, float sm_scale,
                                     void* stream) {
  int err = set_smem(flash_mha_bwd_dkv_kernel, kDkvSmemBytes);  // see dQ
  CUtensorMap tm_q, tm_do;
  const uint64_t heads = (uint64_t)batch * n_head;
  if (err == 0) err = make_tensor_map_f32(&tm_q, q, heads, t_len, kD, kTile);
  if (err == 0)
    err = make_tensor_map_f32(&tm_do, dout, heads, t_len, kD, kTile);
  if (err != 0) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, n_head, batch);
  flash_mha_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes,
                             (cudaStream_t)stream>>>(
      tm_q, tm_do, k, v, mask, lse, delta, dk, dv, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of each kernel takes, in bytes (ptxas
// reports only static shared memory).
extern "C" int flash_mha_bwd_dq_smem_bytes() { return (int)kDqSmemBytes; }
extern "C" int flash_mha_bwd_dkv_smem_bytes() { return (int)kDkvSmemBytes; }

// Rows of a streamed tile: the dQ kernel's key tile (the unit in which it
// skips wholly padded keys) and the dK/dV kernel's query tile.
extern "C" int flash_mha_bwd_stream_tile() { return kTile; }

// Resident rows of a block: the dQ kernel's query rows and the dK/dV
// kernel's keys (the unit in which it writes zeros for padded keys).
extern "C" int flash_mha_bwd_block_rows() { return kRows; }
