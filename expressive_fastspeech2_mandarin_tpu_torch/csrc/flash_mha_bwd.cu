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
// The block's constants, loads, products and stores are in
// csrc/tf32_flash_bwd.cuh, which the D = 256 backward
// (csrc/flash_mha_bwd_d256.cu) shares.
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, H, T, 128) float32,
// contiguous, 16-byte aligned; mask (B, T) bytes, nonzero at padded keys;
// lse and delta (B, H, T) float32.

#include <math_constants.h>

#include "tf32_flash_bwd.cuh"

namespace {

using namespace tf32_bwd;

constexpr int kD = kCols;                    // head dim
// dQ: dS hi, lo; P raw; Δ of the rows; the key words; the key bits of the
// first kMapTiles key tiles.
constexpr uint32_t kDqOffP = kOffAcc + 2 * kAccPart;
constexpr uint32_t kDqOffDelta = kDqOffP + kRows * kTile * 4;
constexpr uint32_t kDqOffBar = kDqOffDelta + kRows * 4;
constexpr uint32_t kDqOffWords = kDqOffBar + 2 * 8;
constexpr uint32_t kDqOffMap = kDqOffWords + 16;
constexpr size_t kDqSmemBytes = kDqOffMap + kMapTiles * 4 + 1024;
static_assert(kDqSmemBytes <= 232448,
              "more shared memory than a block may use");

// ---------------------------------------------------------------------------
// The dQ kernel.

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
    tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, 0, bh, tile, 0, base,
                         bars, words, map);

  uint8_t* qs = smem + kOffRes;
  uint8_t* dos = qs + kResTile;
  load_resident<kD>(qs, q + head * kD, q0, 0, t_len);
  load_resident<kD>(dos, dout + head * kD, q0, 0, t_len);
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
      tile = next_key_tile(&tm_k, &tm_v, mrow, t_len, 0, bh, tile, s ^ 1,
                           base, bars, words, map);
    const uint32_t kst = base + kOffStage + s * kStage;
    float x[16];
    if (wg == 0) {
      rows_product<false>(x, hi, lo, qs, kst);  // S = Q K^T
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
      rows_product<false>(x, hi, lo, dos, kst + kStTile);  // dP = dO V^T
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
  store_transposed<kD>(dq + head * kD, dqt, wg, 0, q0, t_len, sm_scale);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel.

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
    load_query_tile(&tm_q, &tm_do, lse, delta, t_len, 0, bh, 0, 0, base,
                    bars);

  uint8_t* ks = smem + kOffRes;
  uint8_t* vs = ks + kResTile;
  load_resident<kD>(ks, k + head * kD, k0, 0, t_len);
  load_resident<kD>(vs, v + head * kD, k0, 0, t_len);
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
      load_query_tile(&tm_q, &tm_do, lse, delta, t_len, 0, bh, n + 1,
                      s ^ 1, base, bars);
    const uint32_t qst = base + kOffStage + s * kStage;
    const float* lse_s = stats + s * 2 * kTile;
    const float* dlt_s = lse_s + kTile;
    float x[16];
    if (wg == 0) {
      rows_product<false>(x, hi, lo, ks, qst);  // S^T = K Q^T
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
      rows_product<false>(x, hi, lo, vs, qst + kStTile);  // dP^T = V dO^T
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
  store_transposed<kD>(dk + head * kD, dkt, wg, 0, k0, t_len, sm_scale);
  store_transposed<kD>(dv + head * kD, dvt, wg, 0, k0, t_len, 1.f);
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
