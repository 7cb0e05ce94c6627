// Small-L multi-head attention for Hopper (sm_90a): both TPU kernels of
// interpolated_diffusion_tpu/kernels/small_mha.py.
//
// _kernel_packed (launched by _fwd_pallas_packed, public small_mha_packed)
// stacks G samples into one [G*L, G*L] block-diagonal matmul per head so the
// 128x128 MXU sees full tiles; off-block probabilities are exactly 0 in f32,
// so attention per (sample, head) computes the same numbers and needs neither
// the batch padding nor the -1e30 mask. _kernel (launched by _fwd_pallas,
// public small_mha) is attention per (sample, head) with no mask to begin
// with, so the two entries share this file's device code: small_mha_kernel
// for L <= 256 (both entries), small_mha_tiled_kernel for 256 < L (small_mha
// alone, whose window is H*L <= 1024; see below).
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
// Above L = 256 one (sample, head) no longer fits q, k, v and a [16, L] f32
// logits strip per warp in one block's shared memory. small_mha_tiled_kernel
// gives each block 64 query rows of one (sample, head) and walks the keys in
// tiles of 64 twice: the first walk takes each row's running max and sum of
// exponentials, the second recomputes the logits tile, writes P = exp(s - m)
// / sum as bf16 and adds P.V into accumulators that stay in registers. Two
// walks cost the Q.K^T product twice but need no rescaling of partial
// outputs and give P the TPU kernel's rounding point (normalised, then bf16).
// At these shapes (few heads, B*H*L^2*Dh small) the product is cheap; the
// keys come from L2 after the first block of a head has read them.
//
// Numerics follow the TPU kernels: f32 logits times Dh^-0.5, row softmax in
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

constexpr int kTile = 64;        // query rows per block and keys per tile
constexpr int kTiledWarps = 4;   // 16 query rows each

// Shared memory of the tiled kernel: q, k, v tiles [kTile, DH + 8] bf16, then
// per warp a [16, kTile + 4] f32 logits strip and a [16, kTile + 8] bf16
// strip of probabilities (every part a multiple of 128 bytes).
template <int DH>
struct TiledLayout {
  static constexpr int ldx = DH + 8, lds = kTile + 4, ldp = kTile + 8;
  static constexpr size_t tile = (size_t)kTile * ldx * sizeof(bf16);
  static constexpr size_t s_bytes = (size_t)kTiledWarps * 16 * lds * sizeof(float);
  static constexpr size_t p_bytes = (size_t)kTiledWarps * 16 * ldp * sizeof(bf16);
  static constexpr size_t total = 3 * tile + s_bytes + p_bytes;
  static_assert(tile % 128 == 0 && s_bytes % 128 == 0 && p_bytes % 128 == 0, "alignment");
};

// Rows [r0, r0 + kTile) of one head's [L, DH] slice into shared memory, rows
// at or beyond L zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int r0,
                                          int L) {
  constexpr int chunks = DH / 8, ldx = DH + 8;
  for (int c = threadIdx.x; c < kTile * chunks; c += blockDim.x) {
    const int r = c / chunks, d = (c % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + d);
    *reinterpret_cast<uint4*>(dst + r * ldx + d) = val;
  }
}

// S[16, kTile] = Q[16 rows of this warp] K_tile^T into the warp's f32 strip.
template <int DH>
__device__ __forceinline__ void logits_tile(const bf16* Qw, const bf16* Ks, float* S, int lds) {
  constexpr int ldx = DH + 8;
  for (int n0 = 0; n0 < kTile; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < DH; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qw + k0, ldx);
      wmma::load_matrix_sync(bk, Ks + n0 * ldx + k0, ldx);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(S + n0, acc, lds, wmma::mem_row_major);
  }
}

// grid (ceil(L / kTile), B * H), kTiledWarps * 32 threads.
template <int DH>
__global__ void __launch_bounds__(kTiledWarps * 32)
small_mha_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int L, int H,
                       long long ldq, long long ldk, long long ldv, long long ldo,
                       float scale) {
  using T = TiledLayout<DH>;
  constexpr int ldx = T::ldx, lds = T::lds, ldp = T::ldp;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + T::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * T::tile);
  float* Ss = reinterpret_cast<float*>(smem + 3 * T::tile);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 3 * T::tile + T::s_bytes);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kTile;
  const long long row0 = (long long)b * L;
  const int col0 = h * DH;
  const bf16* qh = q + row0 * ldq + col0;
  const bf16* kh = k + row0 * ldk + col0;
  const bf16* vh = v + row0 * ldv + col0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* Qw = Qs + warp * 16 * ldx;
  float* S = Ss + warp * 16 * lds;
  bf16* P = Ps + warp * 16 * ldp;
  const int r = lane / 2, half = lane % 2;   // two lanes per query row
  const float* srow = S + r * lds;

  load_rows<DH>(Qs, qh, ldq, q0, L);

  // first walk: running max m and sum of exp(s - m) of every row
  float m = -INFINITY, sum = 0.f;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();   // the previous tile is consumed (and Qs is loaded)
    load_rows<DH>(Ks, kh, ldk, k0, L);
    __syncthreads();
    logits_tile<DH>(Qw, Ks, S, lds);
    __syncwarp();
    const int n = min(kTile, L - k0);   // real keys in this tile (>= 1)
    float tmax = -INFINITY;
    for (int j = half; j < n; j += 2) tmax = fmaxf(tmax, srow[j] * scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float part = 0.f;
    for (int j = half; j < n; j += 2) part += expf(srow[j] * scale - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    sum = sum * expf(m - m_new) + part;   // exp(-inf) = 0 on the first tile
    m = m_new;
    __syncwarp();
  }
  const float inv = 1.f / sum;

  // second walk: P = exp(s - m) / sum as bf16, O += P V in registers
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
  for (int d = 0; d < DH / 16; ++d) wmma::fill_fragment(oacc[d], 0.f);
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_rows<DH>(Ks, kh, ldk, k0, L);
    load_rows<DH>(Vs, vh, ldv, k0, L);
    __syncthreads();
    logits_tile<DH>(Qw, Ks, S, lds);
    __syncwarp();
    const int n = min(kTile, L - k0);
    bf16* prow = P + r * ldp;
    for (int j = half; j < kTile; j += 2)
      prow[j] = __float2bfloat16(j < n ? expf(srow[j] * scale - m) * inv : 0.f);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DH / 16; ++d) {
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, P + kk, ldp);
        wmma::load_matrix_sync(bv, Vs + kk * ldx + d * 16, ldx);
        wmma::mma_sync(oacc[d], a, bv, oacc[d]);
      }
    }
    __syncwarp();
  }

  // rows < L written as bf16 through the warp's (now free) logits strip
  const int c = half * 8;
#pragma unroll
  for (int d = 0; d < DH / 16; ++d) {
    wmma::store_matrix_sync(S, oacc[d], 16, wmma::mem_row_major);
    __syncwarp();
    const int row = q0 + warp * 16 + r;
    if (row < L) {
      __align__(16) bf16 packed[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(S[r * 16 + c + e]);
      *reinterpret_cast<uint4*>(o + (row0 + row) * ldo + col0 + d * 16 + c) =
          *reinterpret_cast<const uint4*>(packed);
    }
    __syncwarp();
  }
}

template <int DH>
cudaError_t launch_tiled(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L,
                         int H, long long ldq, long long ldk, long long ldv, long long ldo,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = TiledLayout<DH>::total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_mha_tiled_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((L + kTile - 1) / kTile, B * H);
  small_mha_tiled_kernel<DH><<<grid, kTiledWarps * 32, smem, stream>>>(q, k, v, o, L, H, ldq, ldk,
                                                                    ldv, ldo, scale);
  return cudaGetLastError();
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

// small_mha: any L (the Python wrapper holds it to the TPU kernel's window
// H * L <= 1024). L <= 256 runs the one-block-per-head kernel above, longer
// sequences the tiled one. B * H <= 65535 for the tiled grid.
extern "C" int id_small_mha(const void* q, const void* k, const void* v, void* o, int B, int L,
                            int H, int Dh, long long ldq, long long ldk, long long ldv,
                            long long ldo, float scale, void* stream) {
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= kMaxL) return (int)launch_small_mha(qb, kb, vb, ob, B, L, H, Dh, ldq, ldk, ldv, ldo,
                                               scale, s);
  if (B <= 0 || (long long)B * H > 65535 || (Dh != 32 && Dh != 64) || ldq % 8 || ldk % 8 ||
      ldv % 8 || ldo % 8)
    return (int)cudaErrorInvalidValue;
  if (Dh == 32)
    return (int)launch_tiled<32>(qb, kb, vb, ob, B, L, H, ldq, ldk, ldv, ldo, scale, s);
  return (int)launch_tiled<64>(qb, kb, vb, ob, B, L, H, ldq, ldk, ldv, ldo, scale, s);
}

extern "C" const char* id_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
