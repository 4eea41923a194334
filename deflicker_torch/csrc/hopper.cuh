// Hopper (sm_90a) building blocks of the IMLP chain's and the correlation
// lookup's kernels: mbarriers, TMA loads and stores of tiled tensor maps,
// wgmma with shared-memory matrix descriptors, and on the host the encoding
// of bf16 tensor maps.  Layouts and encodings: PTX ISA,
// "Asynchronous Warpgroup Level Matrix Multiply-Accumulate" (matrix
// descriptor, register fragments) and "Tensor Memory Accelerator".
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed, in one loop of
// PTX (as CUTLASS writes it; a loop in C++ around try_wait was slower in
// the forward).  A wait still open after 2^28
// tries (seconds; a copy or a product takes microseconds) traps: a fault in
// a ring's protocol fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 n;\nmov.b32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 268435456;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---- TMA -------------------------------------------------------------------

// one box of a 3-D tiled tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 4-D tiled tensor map (coordinates innermost first)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// one box of shared memory, laid out as the map's swizzle lays it, into a
// 3-D tiled tensor map (coordinates innermost first); elements outside the
// tensor are not written.  Completion is tracked by bulk groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// wait until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// orders this thread's shared-memory stores before later async-proxy reads
// (wgmma operands, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// This thread's warpgroup, read through a shuffle so that the compiler
// knows it is the same across the warp: wgmma under a branch on it is then
// not taken for divergent code (which ptxas serializes).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a tile stored as TMA's 128-byte swizzle writes it: rows of
// 128 bytes (64 bf16), 8-row groups of 1,024 bytes, the tile 1,024-byte
// aligned.  K-major operand: rows are M (or N) indices, the 64 contraction
// elements of a row contiguous; `sbo` = bytes between 8-row groups, `lbo`
// unused.  MN-major operand: rows are contraction indices, each holding 64
// consecutive M (or N) indices; `sbo` = bytes between 8-row groups along the
// contraction, `lbo` = bytes between 64-wide column blocks.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

// byte offset of element (r, c), c < 64, in such a tile
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

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

// Pins the accumulator registers at this point of the program: placed after
// wgmma_wait, no read of d is scheduled before the products have landed.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 f32, the warpgroup's fragments) += A (64 x 16) · B (16 x 128),
// bf16 operands in shared memory.  TA / TB = 1: the operand is MN-major.
// Fragment of thread (warp w of the group, lane l): d[4j + q] is row
// 16w + l/4 + 8(q/2), column 8j + 2(l%4) + q%2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled looked up through the runtime: the libraries link
// only the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)f;
  }
  return fn;
}

// bf16 map of RANK dimensions (innermost first): dims, the byte strides of
// dimensions 1..RANK-1 and the box; 128-byte swizzle, elements outside the
// tensor (negative coordinates too) read as zero
template <int RANK>
inline bool make_map_nd(CUtensorMap* m, const void* base, const uint64_t (&dims)[RANK],
                        const uint64_t (&strides)[RANK - 1], const uint32_t (&box)[RANK]) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ((uintptr_t)base & 15)) return false;
  cuuint64_t d[RANK], s[RANK - 1];
  cuuint32_t b[RANK], e[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < RANK) {
      if (strides[i] & 15) return false;
      s[i] = strides[i];
    }
  }
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, RANK, const_cast<void*>(base), d, s, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the chain's (columns, rows, videos) map
inline bool make_map(CUtensorMap* m, const void* base, int cols, int rows, int V, size_t row_bytes,
                     size_t video_bytes, int box_cols, int box_rows) {
  return make_map_nd<3>(m, base, {(uint64_t)cols, (uint64_t)rows, (uint64_t)V},
                        {(uint64_t)row_bytes, (uint64_t)video_bytes},
                        {(uint32_t)box_cols, (uint32_t)box_rows, 1u});
}

}  // namespace hopper
