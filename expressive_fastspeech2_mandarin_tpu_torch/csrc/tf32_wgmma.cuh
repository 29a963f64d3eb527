// float32 products on Hopper's tensor cores at float32 accuracy (3xTF32): the
// operand split, A fragments loaded from shared memory, and TF32 wgmma.
// Included by csrc/flash_mha.cu, csrc/flash_mha_bwd.cu, csrc/flash_mha_d256.cu,
// csrc/flash_mha_bwd_d256.cu and csrc/mrf_resblock.cu (its float32 kernel). The type-neutral
// plumbing (barriers, TMA, the swizzle and descriptors, wgmma ordering) is
// in csrc/sm90.cuh.
//
// 3xTF32. A float32 x is split into two TF32 values (10 explicit mantissa
// bits, the low 13 bits of the float32 pattern zero):
//     hi = rna(x),   lo = rna(x - hi),   rna = round to nearest, ties away
// (CUTLASS's OpMultiplyAddFastF32 split; x - hi is exact in float32). Both
// parts are stored with their low 13 bits already zero, so the product does
// not depend on what the tensor cores do with a raw float32's low bits. A
// product a*b becomes three TF32 products, lo*hi + hi*lo + hi*hi, each exact
// in the float32 accumulator's precision; the dropped lo*lo and the rounding
// of lo leave about 2^-21 relative, against 2^-11 for a single TF32 product
// (a fourth product, lo*lo, leaves the rounding of lo alone).
// tests/test_torch_flash_tc.py emulates the split bit for bit on the CPU.
//
// Layout. Every TF32 wgmma operand is K-major (TF32 wgmma takes no
// transpose). The flash kernels' are 128-byte swizzled (sm90.cuh): rows of
// 32 float32, a K extent of 128 as four such tiles ("chunks" of 32 columns)
// one after the other; a k-step's descriptor points 32 bytes further into
// the row. The MRF kernel's are unswizzled core matrices (its note).

#pragma once

#include "sm90.cuh"

namespace tf32x3 {

// ---------------------------------------------------------------------------
// The split.

// float32 rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives), as a float32 whose low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Split four values and store the parts as float4 at the same offset of two
// buffers.
__device__ __forceinline__ void store_split4(uint8_t* hi, uint8_t* lo,
                                             float4 x) {
  float4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
}

// ---------------------------------------------------------------------------
// A fragments from shared memory. A tile of rows of 128 float32 is stored as
// four 128-byte swizzled chunks of 32 columns, `chunk` bytes apart (a chunk
// starts on a 1024-byte boundary). For a wgmma whose A(m, k) is
// tile(row0 + m, col0 + k) (rows of the tile are M), the k-step's four
// registers are (row0 + r, col0 + c) for (r, c) = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of warp w's rows r + 16w.
__device__ __forceinline__ uint32_t tile_offset(uint32_t row, uint32_t col,
                                                uint32_t chunk) {
  return (col >> 5) * chunk + sm90::sw128(row, (col & 31) >> 2) +
         4 * (col & 3);
}

// For a wgmma whose A(m, k) is tile(row0 + k, col0 + m), the transpose (rows
// of the tile are K): registers (k, m) = (t, g), (t, g + 8), (t + 4, g),
// (t + 4, g + 8) of warp w's columns m + 16w.
template <bool kTransposed>
__device__ __forceinline__ void load_frag(float (&x)[4], const uint8_t* tile,
                                          uint32_t row0, uint32_t col0,
                                          uint32_t chunk) {
  const uint32_t lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const uint32_t g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t m = 16 * w + g + 8 * (r & 1), k = t + 4 * (r >> 1);
    const uint32_t off = kTransposed ? tile_offset(row0 + k, col0 + m, chunk)
                                     : tile_offset(row0 + m, col0 + k, chunk);
    x[r] = *reinterpret_cast<const float*>(tile + off);
  }
}

// An A fragment of a raw float32 tile, split into its TF32 parts.
template <bool kTransposed>
__device__ __forceinline__ void load_split_frag(uint32_t (&hi)[4],
                                                uint32_t (&lo)[4],
                                                const uint8_t* tile,
                                                uint32_t row0, uint32_t col0,
                                                uint32_t chunk) {
  float x[4];
  load_frag<kTransposed>(x, tile, row0, col0, chunk);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float h, l;
    split(x[r], h, l);
    hi[r] = __float_as_uint(h);
    lo[r] = __float_as_uint(l);
  }
}

// An A fragment whose parts are already split, in two tiles at the same
// offsets (hi and lo).
template <bool kTransposed>
__device__ __forceinline__ void load_parts_frag(uint32_t (&hi)[4],
                                                uint32_t (&lo)[4],
                                                const uint8_t* tile_hi,
                                                const uint8_t* tile_lo,
                                                uint32_t row0, uint32_t col0,
                                                uint32_t chunk) {
  float h[4], l[4];
  load_frag<kTransposed>(h, tile_hi, row0, col0, chunk);
  load_frag<kTransposed>(l, tile_lo, row0, col0, chunk);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    hi[r] = __float_as_uint(h[r]);
    lo[r] = __float_as_uint(l[r]);
  }
}

// ---------------------------------------------------------------------------
// TF32 wgmma, float32 accumulators in registers. Accumulator layout of
// m64nN: warp w of the warpgroup holds rows 16w + g and 16w + g + 8
// (g = lane / 4), columns 8j + 2t and 8j + 2t + 1 (t = lane % 4) in d[4j],
// d[4j + 1] (row 16w + g) and d[4j + 2], d[4j + 3] (row 16w + g + 8).
// A from registers (m64nNk8): a[0] = (row g, k t), a[1] = (row g + 8, k t),
// a[2] = (row g, k t + 4), a[3] = (row g + 8, k t + 4).
// The tensor cores add each product into the accumulator rounding toward
// zero, so a long chain of wgmma into one accumulator drifts (about half a
// unit in the last place of the running sum per wgmma, all one way): keep
// chains short, add the small products (lo) first, and sum the chains in
// software, which rounds to nearest. A chain starts with acc = 0 (the
// accumulator's old value ignored) rather than zeroed registers: writing
// accumulator registers outside wgmma makes ptxas serialize the wgmma.

// d(64 x 64) = A(64 x 8, descriptor) * B(8 x 64, descriptor) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d(64 x 32) = A(64 x 8, descriptor) * B(8 x 32, descriptor) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d(64 x 128) = A(64 x 8, descriptor) * B(8 x 128, descriptor)
// + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d(64 x 64) = A(64 x 8, registers) * B(8 x 64, descriptor) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d(64 x 128) = A(64 x 8, registers) * B(8 x 128, descriptor) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

}  // namespace tf32x3
