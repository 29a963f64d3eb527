// Hopper (sm_90a) plumbing that does not depend on the operand type: shared
// addresses, mbarriers, bulk and TMA copies, named barriers, cluster
// barriers and distributed shared memory, the wgmma fence/commit/wait, the
// 128-byte swizzle and its descriptors, and float32 and bf16 tensor maps.
// Included by csrc/mrf_resblock.cu (bf16 wgmma, and TF32 through
// csrc/tf32_wgmma.cuh), through csrc/tf32_wgmma.cuh by csrc/flash_mha.cu,
// csrc/flash_mha_bwd.cu, csrc/flash_mha_d256.cu and csrc/flash_mha_bwd_d256.cu
// (TF32 wgmma) and, through csrc/bf16_wgmma.cuh, by csrc/flash_mha_bf16.cu,
// csrc/flash_mha_bwd_bf16.cu and csrc/flash_mha_bf16_d256.cu (bf16 wgmma).
//
// The 128-byte swizzle, as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it: a tile
// is rows of 128 bytes; within each 1024-byte-aligned atom of 8 rows, the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). A K-major wgmma operand
// whose K extent is wider than 128 bytes is several such tiles ("chunks")
// one after the other. A descriptor points at a k-step's first column with
// 1024 bytes between 8-row groups.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// Shared memory, barriers, bulk copies.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait for the phase of parity `parity` to complete. (No watchdog: a trap
// in the wait loop makes ptxas serialize the wgmma that follow it.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// The producer's arrival, which also announces the bytes its copies bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Contiguous bytes from device memory to shared memory; completion is
// counted on the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 4 bytes from device memory to shared memory, asynchronously; src_bytes 0
// writes zero and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The mbarrier `bar` waits, besides its arrivals, for the completion of
// every cp.async this thread issued before.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// One box of a 3-D tensor map into shared memory at `dst`, counted on the
// mbarrier `bar`; coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Generic-proxy stores to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the first `n` threads of the block.
template <int id, int n>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(id), "n"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters: a block's rank in its cluster, the cluster-wide
// barrier, and reads of a peer block's shared memory (distributed shared
// memory).

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster-wide barrier in two halves: every thread of every block of
// the cluster arrives, and later waits for all the arrivals; shared-memory
// accesses (any block's) before an arrival are ordered before those after
// the wait. A thread alternates arrive and wait; between them it may do
// work that does not depend on the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address, in the cluster's shared window, of shared address `addr` of
// the block of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Arrive on the mbarrier at shared address `bar` of the block of rank
// `rank` in the cluster, releasing at cluster scope what this thread (and,
// after a __syncwarp, its warp) wrote and read before.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile("{\n.reg .b32 remote;\n"
               "mapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
               "[remote];\n}\n"
               :: "r"(bar), "r"(rank) : "memory");
}

// mbar_wait for a phase that other blocks of the cluster complete
// (mbar_arrive_cluster): acquire at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(addr)
               : "memory");
  return x;
}

// ---------------------------------------------------------------------------
// wgmma ordering. The compiler takes each wgmma asm as done when issued.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin the registers a wgmma reads and writes, after wgmma_wait and before
// the wgmma that use them, so that no access to an accumulator is moved
// across the wgmma or the wait and no register of an A fragment is reused
// while a wgmma may still read it (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// ---------------------------------------------------------------------------
// The 128-byte swizzle and descriptors.

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled
// tile of 128-byte rows that starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t sw128(uint32_t row, uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// Shared-memory matrix descriptor of a K-major, 128-byte swizzled operand
// at shared address `addr`: 1024 bytes between 8-row groups (stride byte
// offset), the leading byte offset unused by this layout (1), layout type 1
// (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024u >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is looked up in libcuda.so.1,
// which the CUDA runtime has loaded, so the library links against nothing
// but the runtime. Each returns 0, or a nonzero code: 900 if libcuda has no
// such function, else 1000 + the CUresult.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map over a (outer, rows, inner) array of `elem_bytes`-byte
// elements, contiguous, boxes of (1, box_rows, 128 bytes of the inner
// dimension) landing 128-byte swizzled; rows past `rows` read as zero.
inline int make_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                           uint32_t elem_bytes, const void* base,
                           uint64_t outer, uint64_t rows, uint64_t inner,
                           uint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 900;
  const cuuint64_t dims[3] = {inner, rows, outer};
  const cuuint64_t strides[2] = {inner * elem_bytes,
                                 rows * inner * elem_bytes};
  const cuuint32_t box[3] = {128 / elem_bytes, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// float32: boxes of 32 columns.
inline int make_tensor_map_f32(CUtensorMap* map, const void* base,
                               uint64_t outer, uint64_t rows, uint64_t inner,
                               uint32_t box_rows) {
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, outer,
                         rows, inner, box_rows);
}

// bf16: boxes of 64 columns.
inline int make_tensor_map_bf16(CUtensorMap* map, const void* base,
                                uint64_t outer, uint64_t rows, uint64_t inner,
                                uint32_t box_rows) {
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                         outer, rows, inner, box_rows);
}

}  // namespace sm90
