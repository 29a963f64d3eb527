// The float32 flash backward's block on the TF32 tensor cores (3xTF32,
// tf32_wgmma.cuh): its constants, its shared-memory tiles, the loads, the
// in-place split, the products and the stores. Included by
// csrc/flash_mha_bwd.cu (D = 128: one block holds the head dim) and
// csrc/flash_mha_bwd_d256.cu (D = 256: each block of a cluster holds a
// 128-column chunk of it), whose notes give the kernels.
//
// A block: 256 threads, two consumer warpgroups, 64 resident rows (Q and dO
// in the dQ kernel, K and V in the dK/dV kernel) of 128 columns, raw; 32-row
// tiles of the streamed operands (K and V, or Q and dO) of the same 128
// columns by TMA through a two-stage mbarrier ring, split in place into hi
// and lo rows. The dQ kernels' shared-memory plans are their files'; the
// dK/dV kernels' is the same in both, here.

#pragma once

#include "tf32_wgmma.cuh"

namespace tf32_bwd {

using namespace sm90;
using namespace tf32x3;

constexpr int kCols = 128;                   // head-dim columns a block
constexpr int kRows = 64;                    // resident rows per block
constexpr int kTile = 32;                    // rows per streamed tile
constexpr int kWarpgroup = 128;
constexpr int kThreads = 2 * kWarpgroup;     // two consumer warpgroups
constexpr int kSteps = kCols / 8;            // k-steps of S and dP
constexpr int kChain = 4;                    // k-steps per fresh chain
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
// The key bits of the first kMapTiles key tiles (the dQ kernels read them
// once at the start).
constexpr int kMapTiles = 2048;
// dK/dV: P^T hi, lo; dS^T hi, lo; lse and Δ of each stage's queries.
constexpr uint32_t kDkvOffStats = kOffAcc + 4 * kAccPart;
constexpr uint32_t kDkvOffBar = kDkvOffStats + 2 * 2 * kTile * 4;
constexpr size_t kDkvSmemBytes = kDkvOffBar + 2 * 8 + 1024;
static_assert(kDkvSmemBytes <= 232448,
              "more shared memory than a block may use");

__device__ __forceinline__ uint32_t loaded_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}

// Two streamed tiles into stage `dst` (hi rows of each chunk), by TMA: rows
// [row0, row0 + 32) of tm0 and [row1, row1 + 32) of tm1, columns
// [col0, col0 + 128).
__device__ __forceinline__ void load_stage(const CUtensorMap* tm0, int row0,
                                           const CUtensorMap* tm1, int row1,
                                           int col0, int bh, uint32_t dst,
                                           uint32_t bar) {
  mbar_expect_tx(bar, 2 * kTile * kCols * 4);
  for (int c = 0; c < kCols / 32; ++c) {
    tma_load_3d(dst + c * kStChunk, tm0, col0 + 32 * c, row0, bh, bar);
    tma_load_3d(dst + kStTile + c * kStChunk, tm1, col0 + 32 * c, row1, bh,
                bar);
  }
}

// Threads [0, n): a landed stage's two tiles split in place, hi rows
// rewritten, lo rows 32 rows further (same swizzle).
template <int n>
__device__ __forceinline__ void split_stage(uint8_t* stage, int tid) {
  constexpr int kPerTile = kTile * kCols / 4;  // float4 of one part
#pragma unroll
  for (int f = tid; f < 2 * kPerTile; f += n) {
    const int x = f % kPerTile;
    uint8_t* hi = stage + (f / kPerTile) * kStTile +
                  (x / (kStLo / 16)) * kStChunk + 16 * (x % (kStLo / 16));
    store_split4(hi, hi + kStLo, *reinterpret_cast<const float4*>(hi));
  }
  fence_proxy_async();
}

// Rows [r0, r0 + 64), columns [col0, col0 + 128) of one head's (T, kD)
// matrix, raw, zero past T, into a resident tile (all threads).
template <int kD>
__device__ __forceinline__ void load_resident(uint8_t* dst, const float* src,
                                              int r0, int col0, int t_len) {
  for (int f = threadIdx.x; f < kRows * kCols / 4; f += kThreads) {
    const int r = f >> 5, c4 = f & 31;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t_len)
      x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * kD +
                                           col0 + 4 * c4);
    *reinterpret_cast<float4*>(dst + (c4 >> 3) * kResChunk +
                               sw128(r, c4 & 7)) = x;
  }
}

// out (64 x 32, m64n32 layout) = A B^T over the block's 128 columns: A the
// resident tile (raw; each fragment split in registers), B the streamed tile
// at shared address `b` ([hi; lo] per chunk). Four TF32 products as two
// m64n64k8 a k-step, each with both parts of B as its 64 columns: A hi times
// [B hi; B lo] into `hi`, A lo times [B hi; B lo] into `lo`. Each chain of
// kChain k-steps starts fresh and is summed in software, small products
// first; then the chains (out starts at 0 and takes every chain's sum:
// ptxas returned wrong sums when the first chain's sum defined it). With
// A = a and B = b the chain's sum is
//     ((a_lo b_lo + a_lo b_hi) + a_hi b_lo) + a_hi b_hi;
// kSwapped (for S^T = K Q^T and dP^T = V dO^T) adds the same four terms of
// the roles' swap in the same order, so that S^T and dP^T are S and dP of
// a dQ kernel with the same operands, bit for bit (csrc/flash_mha_bwd_d256.cu
// needs that; csrc/flash_mha_bwd.cu takes the unswapped order in both).
template <bool kSwapped>
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
    // hi[c], lo[c]: times B hi; hi[16 + c], lo[16 + c]: times B lo.
#pragma unroll
    for (int c = 0; c < 16; ++c)
      out[c] += kSwapped ? ((lo[16 + c] + hi[16 + c]) + lo[c]) + hi[c]
                         : ((lo[16 + c] + lo[c]) + hi[16 + c]) + hi[c];
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

// Rows [r0, r0 + 64) and columns [col0 + 64 half, col0 + 64 half + 64) of a
// (T, kD) output from the running m64n64 accumulator (row m: column
// col0 + 64 half + m; column n: the output's row r0 + n), times scale; rows
// past T are not stored.
template <int kD>
__device__ __forceinline__ void store_transposed(float* dst,
                                                 const float (&acc)[32],
                                                 int half, int col0, int r0,
                                                 int t_len, float scale) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * j + 2 * t4 + e;
      if (r >= t_len) continue;
      float* row = dst + (int64_t)r * kD + col0 + 64 * half + 16 * warp + g;
      row[0] = acc[4 * j + e] * scale;
      row[8] = acc[4 * j + 2 + e] * scale;
    }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& base) {
  const uint32_t addr = smem_addr(raw);
  base = (addr + 1023u) & ~1023u;
  return raw + (base - addr);
}

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
// columns [col0, col0 + 128) of K and V by TMA (lane 0). Past the last, a
// word of 0 and a bare arrival end the stream. The first kMapTiles tiles'
// bits come from the map; past it, from the mask. Returns the tile's index.
__device__ __forceinline__ int next_key_tile(const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             const uint8_t* mrow, int t_len,
                                             int col0, int bh, int after,
                                             int s, uint32_t base,
                                             uint32_t bars,
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
      load_stage(tm_k, i * kTile, tm_v, i * kTile, col0, bh,
                 base + kOffStage + s * kStage, loaded_bar(bars, s));
  }
  __syncwarp();
  return i;
}

// Warp 0: query tile i into stage s: its lse and Δ by the lanes with
// cp.async (0 past T, where Q and dO read as 0 too, so those queries add
// exactly 0), counted on the stage's mbarrier; columns [col0, col0 + 128)
// of Q and dO by TMA (lane 0).
__device__ __forceinline__ void load_query_tile(const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do,
                                                const float* lse,
                                                const float* delta,
                                                int t_len, int col0, int bh,
                                                int i, int s, uint32_t base,
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
    load_stage(tm_q, i * kTile, tm_do, i * kTile, col0, bh,
               base + kOffStage + s * kStage, loaded_bar(bars, s));
  __syncwarp();
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tf32_bwd
