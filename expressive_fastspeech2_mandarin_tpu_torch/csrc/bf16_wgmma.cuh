// bf16 products on Hopper's tensor cores with float32 accumulators: wgmma
// m64n64k16 with both operands from 128-byte swizzled shared memory or A
// from registers, B K-major or MN-major (the transpose bit), and the packing
// of a float32 accumulator into the bf16 A fragment of the next product.
// Also the 64-row tiles the bf16 flash kernels stream and keep: their
// layout, their loads and the scan for the next tile with a valid key.
// Included by csrc/flash_mha_bf16.cu and csrc/flash_mha_bwd_bf16.cu; the
// type-neutral plumbing (barriers, TMA, the swizzle, wgmma ordering) is in
// csrc/sm90.cuh. (csrc/mrf_resblock.cu keeps its own forms: unswizzled
// core-matrix operands that always accumulate.)
//
// Layout. A tile of rows of 128 bf16 is two 128-byte swizzled chunks of 64
// columns, one after the other (as TMA lands a (rows, 64) box of a bf16
// tensor map, sm90.cuh). Such a tile is, for a product, either
//   * K-major (the K dimension along the row): A(m, k) or B(k, n) =
//     tile(m or n, k). A k-step of 16 columns is 32 bytes: its descriptor
//     points 32 (k % 4) bytes into chunk k / 4 (sm90::desc_sw128, 1024 bytes
//     between 8-row groups), as for TF32; or
//   * MN-major (B only, the transpose bit set): B(k, n) = tile(k, n), the
//     rows of the tile are K. A k-step is 16 rows: its descriptor points at
//     row 16 k of the chunk that holds the 64 columns n, with 1024 bytes
//     between 8-row groups (the stride byte offset) and, unused by an N of
//     64, the chunk's bytes between 64-column groups (the leading byte
//     offset), as CUTLASS's make_gmma_desc<Major::MN> encodes the 128-byte
//     swizzle.
// So a (rows, 128) tile of keys or queries feeds S = Q K^T (K-major B) and
// P V (MN-major B) as it lies: no transposed copy.
//
// Accumulator of m64n64 (float d[32]): warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (g = lane / 4), columns 8j + 2t and 8j + 2t + 1
// (t = lane % 4) in d[4j], d[4j + 1] (row 16w + g) and d[4j + 2], d[4j + 3]
// (row 16w + g + 8). A from registers (k16): a[0] = (row g, k 2t, 2t + 1),
// a[1] = (row g + 8, k 2t, 2t + 1), a[2] = (row g, k 2t + 8, 2t + 9),
// a[3] = (row g + 8, k 2t + 8, 2t + 9), two bf16 a register, the lower k in
// the low half. So the accumulator's columns 16s .. 16s + 15 are k-step s of
// an A fragment as they lie: a[0] = (d[8s], d[8s + 1]), a[1] =
// (d[8s + 2], d[8s + 3]), a[2] = (d[8s + 4], d[8s + 5]), a[3] =
// (d[8s + 6], d[8s + 7]).

#pragma once

#include <cuda_bf16.h>

#include <cstring>

#include "sm90.cuh"

namespace bf16mma {

// Shared-memory matrix descriptor of an MN-major, 128-byte swizzled B
// operand at shared address `addr`: leading byte offset `lbo` (between
// 64-column groups), 1024 bytes between 8-row groups of K, layout type 1
// (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr,
                                                  uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | ((uint64_t)1 << 62);
}

// Two float32 values rounded to bf16 (to nearest even), `lo` in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// The m64n64 accumulator d rounded to bf16 as the A fragments of the four
// k-steps of a product over its 64 columns.
__device__ __forceinline__ void accumulator_to_a(uint32_t (&a)[4][4],
                                                 const float (&d)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[s][r] = pack_bf16x2(d[8 * s + 2 * r], d[8 * s + 2 * r + 1]);
}

// d(64 x 64) = A(64 x 16, descriptor, K-major) * B(16 x 64, descriptor;
// kTransB 0: K-major, 1: MN-major) + (acc ? d : 0).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
}

// d(64 x 64) = A(64 x 16, registers) * B(16 x 64, descriptor; kTransB as
// above) + (acc ? d : 0).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(kTransB));
}

// ---------------------------------------------------------------------------
// 64-row tiles of (T, 128) bf16 matrices, as the flash kernels stream and
// keep them.

constexpr int kTileRows = 64;
constexpr uint32_t kChunk = kTileRows * 128;  // 64 rows x 64 columns
constexpr uint32_t kTile = 2 * kChunk;        // 64 rows x 128 columns

// Byte offset of the 16 bytes that hold columns 8c .. 8c + 7 (c = 0..15)
// of row `row` in a tile as TMA lands it (two 128-byte swizzled chunks of
// 64 columns, kChunk bytes each).
__device__ __forceinline__ uint32_t tile16_offset(uint32_t row, uint32_t c) {
  return (c >> 3) * kChunk + sm90::sw128(row, c & 7u);
}

// Rows [r0, r0 + 64) of one head's (T, 128) matrix, zero past T, into the
// tile at `dst`, laid out as TMA lands it (every thread of `n_threads`, 16
// bytes a store).
template <int n_threads>
__device__ __forceinline__ void load_rows(uint8_t* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int t_len) {
  for (int f = threadIdx.x; f < kTileRows * 16; f += n_threads) {
    const int r = f >> 4, c = f & 15;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * 128 +
                                          8 * c);
    *reinterpret_cast<uint4*>(dst + tile16_offset(r, c)) = x;
  }
}

// Row tile `tile` (rows [64 tile, 64 tile + 64) of head `bh`) of two
// tensor maps over (B*H, T, 128) bf16 views into two tiles at shared
// address `dst`, one after the other, by TMA, counted on the mbarrier
// `bar` (rows past T land as zero).
__device__ __forceinline__ void load_tile_pair(const CUtensorMap* tm0,
                                               const CUtensorMap* tm1,
                                               int tile, int bh, uint32_t dst,
                                               uint32_t bar) {
  sm90::mbar_expect_tx(bar, 2 * kTile);
  for (int c = 0; c < 2; ++c) {
    sm90::tma_load_3d(dst + c * kChunk, tm0, 64 * c, tile * kTileRows, bh,
                      bar);
    sm90::tma_load_3d(dst + kTile + c * kChunk, tm1, 64 * c,
                      tile * kTileRows, bh, bar);
  }
}

// The first 64-key tile from `i` on with a valid key (mask row `mrow`,
// nonzero at padded keys), and its key bits (bit c: key 64 tile + c
// valid); the tile count and 0 bits past the last. Two ballots a tile;
// every lane of the warp returns the same, so warps that scan alike agree
// without shared state.
__device__ __forceinline__ int next_live_tile(const uint8_t* mrow, int t_len,
                                              int i, uint64_t& bits) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (t_len + kTileRows - 1) / kTileRows;
  for (; i < n_tiles; ++i) {
    const int k0 = i * kTileRows + lane, k1 = k0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, k0 < t_len && mrow[k0] == 0);
    const uint32_t hi = __ballot_sync(0xffffffffu, k1 < t_len && mrow[k1] == 0);
    bits = ((uint64_t)hi << 32) | lo;
    if (bits != 0) return i;
  }
  bits = 0;
  return n_tiles;
}

// d = A B over D = 128 (8 k-steps): A the K-major tile at shared address
// `a`, B the K-major tile at `b` (B(k, n) = tile(n, k)). S = Q K^T and
// dP = dO V^T take this form.
__device__ __forceinline__ void rows_product(float (&d)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<0>(
        d, sm90::desc_sw128(a + (kk >> 2) * kChunk + (kk & 3) * 32),
        sm90::desc_sw128(b + (kk >> 2) * kChunk + (kk & 3) * 32), kk);
}

// d[half] (+)= A B for the 64 columns [64 half, 64 half + 64) of B: A the
// four k-steps of registers `a` (64 rows of the tile), B the MN-major tile
// at shared address `b` (B(k, n) = tile(k, n)). P V, dS K, P^T dO and
// dS^T Q take this form. `acc` 0 starts the sums afresh.
__device__ __forceinline__ void cols_product(float (&d)[2][32],
                                             const uint32_t (&a)[4][4],
                                             uint32_t b, int acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      wgmma_m64n64k16_rs<1>(
          d[half], a[kk],
          desc_sw128_mn(b + half * kChunk + kk * 16 * 128, kChunk),
          acc | kk);
}

}  // namespace bf16mma
