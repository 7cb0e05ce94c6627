// Packed small-L multi-head attention for Hopper (sm_90a).
//
// Replaces interpolated_diffusion_tpu/kernels/small_mha.py::_kernel_packed
// (launched by _fwd_pallas_packed, public small_mha_packed). The TPU kernel
// stacks G samples into one [G*L, G*L] block-diagonal matmul per head so the
// 128x128 MXU sees full tiles; off-block probabilities are exactly 0 in f32,
// so attention per (sample, head) computes the same numbers and needs neither
// the batch padding nor the -1e30 mask.
//
// What bounds it on the H100: at the maze Stage-2 shape (B=1024, L=64, H=12,
// Dh=32) the QK^T and P.V products are ~6.4 GFLOP while q/k/v/o move ~200 MB
// (counted from the shapes), so the kernel should be bound by device-memory
// bytes. One block per (sample, head) reads its q/k/v tiles once into shared
// memory (16-byte loads), runs both products on the tensor cores (WMMA bf16
// 16x16x16, f32 accumulate; a first CUDA-core version was bound by
// shared-memory loads), takes each row's softmax on two lanes (a warp-wide
// reduction per row serialised the warp on shuffle latency), keeps logits
// and probabilities on chip, and writes o once in the packed [B, L, H*Dh]
// layout with no head transpose. It is still latency-bound, several times
// above its byte bound (PERF.md). L is padded to a multiple of 16 inside the
// block; padded keys get probability 0 and padded query rows are not written.
//
// Numerics follow the TPU kernel: f32 logits times Dh^-0.5, row softmax in
// f32 (max-subtracted exp, divide by the sum), P rounded to bf16, P.V with
// f32 accumulation, output rounded to bf16.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "id_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kMaxWarps = 4;
constexpr int kMaxL = 256;

struct Layout {  // shared-memory carve-up, byte offsets (each 128-aligned)
  int Lp, ldx, lds, ldp;
  size_t q, k, v, s, p, o, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int L, int Dh, int warps) {
  Layout t;
  t.Lp = (L + 15) / 16 * 16;
  t.ldx = Dh + 8;      // q/k/v rows, bf16
  t.lds = t.Lp + 4;    // per-warp logits, f32
  t.ldp = t.Lp + 8;    // per-warp probabilities, bf16
  size_t off = 0;
  const size_t tile = align128((size_t)t.Lp * t.ldx * sizeof(bf16));
  t.q = off; off += tile;
  t.k = off; off += tile;
  t.v = off; off += tile;
  t.s = off; off += align128((size_t)warps * 16 * t.lds * sizeof(float));
  t.p = off; off += align128((size_t)warps * 16 * t.ldp * sizeof(bf16));
  t.o = off; off += align128((size_t)warps * 16 * 16 * sizeof(float));
  t.total = off;
  return t;
}

// Rows [0, L) of one head's [L, Dh] slice into shared memory (16-byte
// chunks), rows [L, Lp) zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int L,
                                          int Lp, int Dh, int ldx) {
  const int chunks = Dh / 8;
  for (int c = threadIdx.x; c < Lp * chunks; c += blockDim.x) {
    const int r = c / chunks, d = (c % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < L) val = *reinterpret_cast<const uint4*>(src + r * ld + d);
    *reinterpret_cast<uint4*>(dst + r * ldx + d) = val;
  }
}

__global__ void small_mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, bf16* __restrict__ o, int L,
                                 int H, int Dh, long long ldq, long long ldk, long long ldv,
                                 long long ldo, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const Layout t = make_layout(L, Dh, warps);
  bf16* Qs = reinterpret_cast<bf16*>(smem + t.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + t.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + t.v);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long row0 = (long long)b * L;
  const int col0 = h * Dh;
  load_tile(Qs, q + row0 * ldq + col0, ldq, L, t.Lp, Dh, t.ldx);
  load_tile(Ks, k + row0 * ldk + col0, ldk, L, t.Lp, Dh, t.ldx);
  load_tile(Vs, v + row0 * ldv + col0, ldv, L, t.Lp, Dh, t.ldx);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* S = reinterpret_cast<float*>(smem + t.s) + warp * 16 * t.lds;
  bf16* P = reinterpret_cast<bf16*>(smem + t.p) + warp * 16 * t.ldp;
  float* Ostage = reinterpret_cast<float*>(smem + t.o) + warp * 16 * 16;

  for (int r0 = warp * 16; r0 < t.Lp; r0 += warps * 16) {
    // S[16, Lp] = Q[r0:r0+16] K^T (f32 accumulate)
    for (int n0 = 0; n0 < t.Lp; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < Dh; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + r0 * t.ldx + k0, t.ldx);
        wmma::load_matrix_sync(bk, Ks + n0 * t.ldx + k0, t.ldx);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(S + n0, acc, t.lds, wmma::mem_row_major);
    }
    __syncwarp();
    // row softmax over the L real keys, two lanes per row (a warp-wide
    // reduction per row would serialise 16 shuffle chains); padded keys get 0
    {
      const int r = lane / 2, half = lane % 2;
      const float* srow = S + r * t.lds;
      float m = -INFINITY;
      for (int j = half; j < L; j += 2) m = fmaxf(m, srow[j] * scale);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      float sum = 0.f;
      for (int j = half; j < L; j += 2) sum += expf(srow[j] * scale - m);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      bf16* prow = P + r * t.ldp;
      for (int j = half; j < t.Lp; j += 2)
        prow[j] = __float2bfloat16(j < L ? expf(srow[j] * scale - m) / sum : 0.f);
    }
    __syncwarp();
    // O[16, Dh] = P[16, Lp] V[Lp, Dh] (f32 accumulate), rows < L written as bf16
    for (int d0 = 0; d0 < Dh; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < t.Lp; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, P + k0, t.ldp);
        wmma::load_matrix_sync(bv, Vs + k0 * t.ldx + d0, t.ldx);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Ostage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c = (lane % 2) * 8;
      if (r0 + r < L) {
        __align__(16) bf16 packed[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(Ostage[r * 16 + c + e]);
        *reinterpret_cast<uint4*>(o + (row0 + r0 + r) * ldo + col0 + d0 + c) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
}

}  // namespace

cudaError_t launch_small_mha(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* o,
                             int B, int L, int H, int Dh,
                             long long ldq, long long ldk, long long ldv,
                             long long ldo, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || L > kMaxL || (Dh != 32 && Dh != 64) || ldq % 8 || ldk % 8 ||
      ldv % 8 || ldo % 8)
    return cudaErrorInvalidValue;
  const int Lp = (L + 15) / 16 * 16;
  const int warps = Lp / 16 < kMaxWarps ? Lp / 16 : kMaxWarps;
  const size_t smem = make_layout(L, Dh, warps).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  small_mha_kernel<<<B * H, warps * 32, smem, stream>>>(q, k, v, o, L, H, Dh, ldq, ldk, ldv,
                                                        ldo, scale);
  return cudaGetLastError();
}

extern "C" int id_small_mha_packed(const void* q, const void* k, const void* v, void* o,
                                   int B, int L, int H, int Dh, long long ldq,
                                   long long ldk, long long ldv, long long ldo,
                                   float scale, void* stream) {
  return (int)launch_small_mha(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, L, H, Dh,
      ldq, ldk, ldv, ldo, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* id_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
