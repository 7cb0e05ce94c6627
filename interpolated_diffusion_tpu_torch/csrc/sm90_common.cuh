// Hopper (sm_90a) primitives shared by the wgmma + TMA kernels of the port
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, sla_fwd_sm90.cu, sla_bwd_sm90.cu,
// fused_block.cu):
// mbarriers, named barriers, TMA tile loads, cp.async counted on an mbarrier,
// the shared-memory matrix descriptors of the 128- and 64-byte swizzles (and
// the K-major / MN-major k-step descriptors of the backward kernels), wgmma
// (bf16 with both operands in shared memory and with A in registers; s8 with
// both in shared memory), the accumulator -> A fragment pack, the tensor-map
// encoders (an entry of libcuda that the runtime hands out, so nothing new is
// linked) and the SM count.
#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace id_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier (PTX ISA) --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrives on `bar` once every cp.async this thread has started is complete
// (.noinc: the arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Named barriers 1 and 2 (0 is __syncthreads) between two warpgroups that take
// turns: 256 = one warpgroup that waits and one that arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// --- TMA -----------------------------------------------------------------------

// One [1, rows, 64] box of a [BH, L, D] tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One [rows, 64] box of a [rows, cols] tensor map: c0 the column, c1 the row.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes.
// K-major operands (the contraction index runs along the 128-byte row):
// sbo = 1024 (the next 8 rows), lbo unused. MN-major operand (the contraction
// index runs over rows): sbo = 1024 (the next 8 rows), lbo = the distance to
// the next 64 columns (the next box).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The same for the 64-byte swizzle (rows of 64 bytes): sbo = 512 (the next 8
// rows), layout type 2.
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// Descriptor of k-step ks (16 columns) of a bf16 K-major operand stored as
// 64-column boxes `box` bytes apart (128-byte swizzle).
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int ks, int box) {
  return smem_desc(addr + (ks / 4) * box + (ks % 4) * 32, 16, 1024);
}

// Descriptor of k-step kk (16 rows) of a bf16 MN-major operand: the
// contraction index runs over the rows of a tile whose 64-column boxes are
// `box` bytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int kk, int box) {
  return smem_desc(addr + kk * (16 * 128), box, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulator registers are written until wgmma_wait returns: keep the
// compiler from moving their uses across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ID_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ID_F32(d, i) ID_F8(d, i), ID_F8(d, i + 8), ID_F8(d, i + 16), ID_F8(d, i + 24)
#define ID_R8(d, i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),           \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define ID_R32(d, i) ID_R8(d, i), ID_R8(d, i + 8), ID_R8(d, i + 16), ID_R8(d, i + 24)
#define ID_REGS_0_31                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define ID_REGS_32_63                                                                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define ID_REGS_64_95                                                                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// d[64 x N] (+)= A[64 x 16] B[N x 16]^T, A and B K-major in shared memory, for
// N = 64, 128 and 192 (d holds N / 2 floats a thread). `acc` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" ID_REGS_0_31 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ID_F32(d, 0)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" ID_REGS_0_31 ", " ID_REGS_32_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ID_F32(d, 0), ID_F32(d, 32)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{" ID_REGS_0_31 ", " ID_REGS_32_63 ", " ID_REGS_64_95 "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : ID_F32(d, 0), ID_F32(d, 32), ID_F32(d, 64)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T in s8 with s32 sums, A and B
// K-major in shared memory (integer wgmma takes no transpose and no scales).
// The accumulator layout is that of the f32 forms.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{" ID_REGS_0_31 ", " ID_REGS_32_63 "}, %64, %65, p;\n}\n"
      : ID_R32(d, 0), ID_R32(d, 32)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A (bf16 pairs) in registers, B
// MN-major in shared memory (the last immediate, trans-b = 1; scale-d is a
// predicate, here always true: the accumulator starts at zero).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" ID_REGS_0_31 ", " ID_REGS_32_63 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ID_F32(d, 0), ID_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same for a 64-wide output (Dh = 64).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" ID_REGS_0_31 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ID_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A fragments of the next wgmma (16 columns a k-step) from the f32
// accumulator of a 64 x 16K product, packed to bf16 in place. Accumulator
// layout of wgmma m64nN (PTX ISA), lane = 4 g + t of warp w of the
// warpgroup: register 4 j + e holds row 16 w + g + 8 (e / 2), column
// 8 j + 2 t + e % 2; the A fragment of m64k16 holds rows g, g + 8 and columns
// 2t, 2t + 1 (+ 8) in the same order, so two neighbouring column blocks pack
// into one k-step.
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&s)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = id_attn::pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = id_attn::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = id_attn::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = id_attn::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// --- host side -----------------------------------------------------------------

// cuTensorMapEncodeTiled is an entry of libcuda, which this library does not
// link: the runtime hands out its address.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return e == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; `strides` in bytes for dims
// 1..rank-1) as a tensor map with the given box in the 128-byte swizzle (the
// box is 64 elements wide); out-of-range elements are filled with zeros. The
// map holds the data pointer, so it is encoded per call, on the host, without
// an allocation.
inline bool make_bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [BH, L, D] bf16, contiguous, as a 3-D map with [1, rows, 64] boxes in the
// 128-byte swizzle (a box never crosses a head); out-of-range rows are filled
// with zeros.
inline bool make_heads_map(CUtensorMap* map, const void* ptr, int BH, int L, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return make_bf16_map(map, ptr, 3, dims, strides, box);
}

// [BH, L, D] int8, contiguous, as a 3-D map with [1, rows, D] boxes: one box
// holds whole rows, in the 128-byte swizzle at D = 128 and the 64-byte swizzle
// at D = 64; out-of-range rows are filled with zeros.
inline bool make_i8_heads_map(CUtensorMap* map, const void* ptr, int BH, int L, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || (D != 64 && D != 128)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)L * D};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device (a persistent grid's size), asked on every call: a
// process may hold devices of more than one kind.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace id_sm90
