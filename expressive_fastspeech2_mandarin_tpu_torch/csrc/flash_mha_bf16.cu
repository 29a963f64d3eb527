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
// (ops/flash_mha.py:flash_mha_plain on bf16 inputs); a row with no valid key
// is exactly 0 and its log-sum-exp +inf; given an lse pointer, the kernel
// stores each row's float32 log-sum-exp for the backward
// (csrc/flash_mha_bwd_bf16.cu).
//
// What bounds it: operations. Two products of 2*T*T*D flops per (b, h)
// against 8*B*H*T*D bytes of bf16 (q, k, v read, out written): T/2 flops a
// byte, far above the ~295 at which the bf16 tensor cores stop waiting on
// memory for the sequences that take this kernel. The card's floor is those
// flops over the key tiles with a valid key at 989 TF/s.
//
// Design (a block: 64 query rows of one (b, h), one warpgroup of 128
// threads; 82,960 bytes of shared memory):
//   * bf16 wgmma reads either major order from shared memory, so the K and
//     V tiles feed the tensor cores as TMA lands them (bf16_wgmma.cuh):
//     S = Q K^T with K K-major, O += P V with V MN-major (the transpose
//     bit). No converter warps, no V transpose, no hi/lo split: one product
//     for S, one for P V;
//   * 64-key tiles of K and V come by TMA (a 3-D tensor map over the
//     (B*H, T, 128) view: rows past T read as zero, no head reads its
//     neighbour's rows) through a two-stage mbarrier ring. Every warp scans
//     the mask for the next tile with a valid key (two ballots a tile), so
//     the block agrees on the sequence without shared state; thread 0
//     issues tile n + 1 once the whole block is past tile n - 1 (a block
//     barrier), one tile ahead. Wholly padded tiles are neither loaded nor
//     computed: they would add exp(-inf) = 0 and not move the running max;
//   * S is 8 k-steps of wgmma m64n64k16 (Q and K from swizzled shared
//     memory); P goes from the S accumulator's registers, rounded to bf16,
//     straight into the A fragments of P V (the accumulator's layout is the
//     A fragment's: no shuffle); P V is 4 k-steps of two m64n64k16 (the two
//     64-dim halves of V) into a fresh accumulator, added to the rescaled
//     O in software;
//   * online softmax in float32 registers: each row's max and sum reduce
//     over the 4 threads that share it; exp is the accurate expf. A row
//     with no valid key keeps max -inf, is shifted by 0 (so its
//     probabilities are 0), ends with sum 0 and stores 0 and lse +inf;
//   * ragged T needs no padding: keys past T are masked, the epilogue stores
//     rows below T only; offsets into q and out are 64-bit.
//
// Shared memory (bytes; every part 1024-aligned for the 128-byte swizzle):
//   Q                      64 rows x 256          = 16,384
//   K, V, 2 stages         2 x 2 x 64 x 256       = 65,536
//   2 mbarriers 16, alignment slack 1,024: 82,960.
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
constexpr int kBq = kTileRows;                 // query rows per block
constexpr int kBk = kTileRows;                 // keys per tile
constexpr int kThreads = 128;                  // one warpgroup
constexpr uint32_t kOffQ = 0;
constexpr uint32_t kOffStage = kOffQ + kTile;  // [stage][K, V]
constexpr uint32_t kOffBar = kOffStage + 2 * 2 * kTile;
constexpr size_t kSmemBytes = kOffBar + 2 * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ float row_reduce_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_reduce_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_mha_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const bf16* __restrict__ q,
                          const uint8_t* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int n_head, int t_len, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kOffBar;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows 16*warp + g and + 8
  const int t4 = lane & 3;  // accumulator columns 8j + 2*t4 and + 1
  const int bh = blockIdx.z * n_head + blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int64_t head = (int64_t)bh * t_len;
  const uint8_t* mrow = mask + (int64_t)blockIdx.z * t_len;
  const int n_tiles = (t_len + kBk - 1) / kBk;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  uint64_t bits;
  int tile = next_live_tile(mrow, t_len, 0, bits);
  if (tid == 0 && tile < n_tiles)
    load_tile_pair(&tm_k, &tm_v, tile, bh, base + kOffStage, bars);

  load_rows<kThreads>(smem + kOffQ, q + head * kD, q0, t_len);  // Q
  fence_proxy_async();
  __syncthreads();

  float o[2][32], pv[2][32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    o[0][i] = o[1][i] = pv[0][i] = pv[1][i] = sc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int n = 0; tile < n_tiles; ++n) {
    const int s = n & 1;
    uint64_t next_bits;
    const int next = next_live_tile(mrow, t_len, tile + 1, next_bits);
    mbar_wait(bars + 8 * s, (n >> 1) & 1);
    __syncthreads();  // the block is past tile n - 1: stage s ^ 1 is free
    if (tid == 0 && next < n_tiles)
      load_tile_pair(&tm_k, &tm_v, next, bh,
                     base + kOffStage + (s ^ 1) * 2 * kTile,
                     bars + 8 * (s ^ 1));
    const uint32_t kst = base + kOffStage + s * 2 * kTile;

    wgmma_fence();
    rows_product(sc, base + kOffQ, kst);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // Online softmax on a copy of S (no code but wgmma writes an
    // accumulator): rows h = 0 (16*warp + g) and h = 1 (+ 8); this thread's
    // keys 64 tile + 8j + 2*t4 + e.
    float x[32], rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * h + e;
          x[c] = (bits >> (8 * j + 2 * t4 + e)) & 1u ? sc[c] * sm_scale
                                                     : -CUDART_INF_F;
          mx = fmaxf(mx, x[c]);
        }
      const float m_new = fmaxf(m[h], row_reduce_max(mx));
      const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[h] - shift);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * h + e;
          x[c] = expf(x[c] - shift);
          sum += x[c];
        }
      l[h] = l[h] * alpha + row_reduce_sum(sum);
      m[h] = m_new;
      rescale[h] = alpha;
    }

    // P, rounded to bf16, as the A fragments of P V; V MN-major.
    uint32_t pa[4][4];
    accumulator_to_a(pa, x);
    wgmma_fence();
    cols_product(pv, pa, kst + kTile, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pv[0]);
    fence_operands(pv[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[half][i] = fmaf(o[half][i], rescale[(i >> 1) & 1], pv[half][i]);
    tile = next;
    bits = next_bits;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
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
      lse[head + r] = l[h] == 0.f ? CUDART_INF_F : m[h] + logf(l[h]);
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
  CUtensorMap tm_k, tm_v;
  const uint64_t heads = (uint64_t)batch * n_head;
  int err = make_tensor_map_bf16(&tm_k, k, heads, t_len, kD, kBk);
  if (err == 0) err = make_tensor_map_bf16(&tm_v, v, heads, t_len, kD, kBk);
  if (err != 0) return err;
  const dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  flash_mha_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), mask, static_cast<bf16*>(out),
      lse, n_head, t_len, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the kernel takes, in bytes (ptxas reports
// only static shared memory).
extern "C" int flash_mha_fwd_bf16_smem_bytes() { return (int)kSmemBytes; }

// Keys per tile, the unit in which the kernel skips wholly padded keys.
extern "C" int flash_mha_fwd_bf16_key_tile() { return kBk; }
