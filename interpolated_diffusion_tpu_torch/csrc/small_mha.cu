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
// gives each block (8 warps) 128 query rows of one (sample, head) and walks
// the keys once in tiles of 64 with an online softmax. At its shapes
// (L <= 1024, one or two heads: [64, 512, 128] H=2 is 8.6 GFLOP and 33.5 MB,
// a bound of 0.010 ms) the work is tiny and what bounds the kernel is latency
// and, since every query block of a head reads all its K and V again, L2
// traffic. A first version staged every logits tile through a shared f32
// strip, read it back a scalar at a time, computed Q K^T twice and loaded
// tiles through registers between two barriers; it took twenty times its
// bound. Here S, the running max and sum, P and the O accumulator stay in
// registers (mma.sync m16n8k16, whose accumulator layout is the A fragment of
// the next product); K / V tiles arrive through a three-stage cp.async ring
// (two tiles in flight under every product, one barrier a tile); the scale is
// folded into exp2; K and V fragments come by ldmatrix (V transposed on the
// way); O goes from registers straight into the packed [B, L, H * Dh] layout;
// q, k, v are read through their row strides (views of one qkv tensor); 128
// query rows a block halve the K / V reads of 64. Rounding point: P = exp(s -
// running max) is rounded to bf16 and the sum divides the f32 accumulator at
// the end, as in this repository's flash kernels; the TPU kernel and the plain
// twin round P = exp(s - m) / sum. Both are one bf16 rounding of P per key,
// and the difference against the twin stays within the same tolerance
// (PERF.md has both errors).
//
// Numerics otherwise follow the TPU kernels: f32 logits times Dh^-0.5, row
// softmax in f32 (max-subtracted exp, divide by the sum), P rounded to bf16,
// P.V with f32 accumulation, output rounded to bf16.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_common.cuh"
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

constexpr int kTile = 64;        // keys per tile
constexpr int kQRows = 128;      // query rows per block, 16 per warp
constexpr int kTiledThreads = 256;
constexpr int kTiledStages = 3;  // K / V ring depth

// Shared memory of the tiled kernel: kQRows rows of Q, then a ring of
// kTiledStages K and V tiles, each [kTile, DH] bf16, with rows padded by 16
// bytes so that the 8 rows one fragment load touches fall in distinct banks.
template <int DH>
struct TiledCfg {
  static constexpr int kLd = 2 * DH + 16;          // bytes per shared row
  static constexpr int kTileBytes = kTile * kLd;
  static constexpr int kOffK = kQRows * kLd, kOffV = kOffK + kTiledStages * kTileBytes;
  static constexpr int kBytes = kOffV + kTiledStages * kTileBytes;    // 72 KB at DH = 64
};

// Rows [r0, r0 + ROWS) of one head's [L, DH] slice (row stride ld elements)
// into shared memory by cp.async; rows at or beyond L are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_head_rows(unsigned char* dst, const bf16* src, long long ld,
                                               int r0, int L) {
  constexpr int chunks = DH / 8;
  for (int c = threadIdx.x; c < ROWS * chunks; c += kTiledThreads) {
    const int r = c / chunks, off = (c % chunks) * 16;
    const bool ok = r0 + r < L;
    const unsigned char* row = reinterpret_cast<const unsigned char*>(src + (long long)(r0 + r) * ld);
    id_attn::cp_async16(dst + r * TiledCfg<DH>::kLd + off,
                        ok ? row + off : reinterpret_cast<const unsigned char*>(src), ok);
  }
}

// grid (B * H * ceil(L / kQRows)), 256 threads. Fragment layouts as in
// attention_common.cuh: lane = 4 * g + t; the warp's rows g and g + 8.
template <int DH>
__global__ void __launch_bounds__(kTiledThreads, 2)
small_mha_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int L, int H,
                       int q_tiles, long long ldq, long long ldk, long long ldv, long long ldo,
                       float scale_log2) {
  using C = TiledCfg<DH>;
  using namespace id_attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kQRows;
  const int b = bh / H, col0 = (bh % H) * DH;
  const long long row0 = (long long)b * L;
  const bf16* qh = q + row0 * ldq + col0;
  const bf16* kh = k + row0 * ldk + col0;
  const bf16* vh = v + row0 * ldv + col0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int n_tiles = (L + kTile - 1) / kTile;
  auto load_tile = [&](int i, int stage) {
    load_head_rows<DH, kTile>(smem + C::kOffK + stage * C::kTileBytes, kh, ldk, i * kTile, L);
    load_head_rows<DH, kTile>(smem + C::kOffV + stage * C::kTileBytes, vh, ldv, i * kTile, L);
  };

  // groups in flight: (Q, tile 0), tile 1, then one per iteration (empty past
  // the last tile), so that "all but the newest" always means "tile it landed"
  load_head_rows<DH, kQRows>(smem, qh, ldq, q0, L);
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  constexpr int kNd = DH / 8;    // 8-wide output column blocks
  constexpr int kKs = DH / 16;   // k-steps of Q K^T
  float acc[kNd][4];
#pragma unroll
  for (int i = 0; i < kNd; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  uint32_t qf[kKs][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kTiledStages;
    cp_async_wait<1>();
    __syncthreads();   // tile it is visible; every warp is done with tile it - 1,
                       // whose stage the next load refills while this tile is multiplied
    if (it + 2 < n_tiles) load_tile(it + 2, (it + 2) % kTiledStages);
    cp_async_commit();

    if (it == 0) {   // Q fragments, once
      const unsigned char* qa = smem + (warp * 16 + g) * C::kLd;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        const int c0 = (ks * 16 + t4 * 2) * 2;
        qf[ks][0] = ld32(qa + c0);
        qf[ks][1] = ld32(qa + 8 * C::kLd + c0);
        qf[ks][2] = ld32(qa + c0 + 16);
        qf[ks][3] = ld32(qa + 8 * C::kLd + c0 + 16);
      }
    }
    const unsigned char* sK = smem + C::kOffK + stage * C::kTileBytes;
    const unsigned char* sV = smem + C::kOffV + stage * C::kTileBytes;
    const int key0 = it * kTile;

    // S = Q K^T for the warp's 16 rows x 64 keys, in base-2 logits
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      // K fragments of two k-steps a load: lanes 8i..8i+7 address key rows
      // nb * 8 .. + 7 at dims 8i .. 8i + 7 of the pair
      const unsigned char* kb = sK + (nb * 8 + (lane & 7)) * C::kLd + (lane >> 3) * 16;
      float sf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kKs; ks += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + ks * 32);
        mma_bf16(sf, qf[ks], bk[0], bk[1]);
        mma_bf16(sf, qf[ks + 1], bk[2], bk[3]);
      }
      const int key = key0 + nb * 8 + 2 * t4;
      s[nb][0] = key < L ? sf[0] * scale_log2 : -INFINITY;
      s[nb][1] = key + 1 < L ? sf[1] * scale_log2 : -INFINITY;
      s[nb][2] = key < L ? sf[2] * scale_log2 : -INFINITY;
      s[nb][3] = key + 1 < L ? sf[3] * scale_log2 : -INFINITY;
    }

    // online softmax (every tile holds a real key, so the max is finite)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ex2(s[nb][e] - m_run[e / 2]);
        rowsum[e / 2] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S registers as the A operand, 16 keys a
    // step; V fragments by ldmatrix.trans, two column blocks a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned char* vb = sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::kLd +
                                ((lane >> 4) & 1) * 16;
#pragma unroll
      for (int nd = 0; nd < kNd; nd += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + nd * 16);
        mma_bf16(acc[nd], pa, bv[0], bv[1]);
        mma_bf16(acc[nd + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / l, straight from registers into the packed [B, L, H * DH] layout
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l_run[r]);   // all lanes: before any row drops out
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    bf16* orow = o + (row0 + row) * ldo + col0;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t4) =
          pack_bf16(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
  }
}

template <int DH>
cudaError_t launch_tiled(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L,
                         int H, long long ldq, long long ldk, long long ldv, long long ldo,
                         float scale, cudaStream_t stream) {
  constexpr int smem = TiledCfg<DH>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_mha_tiled_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int q_tiles = (L + kQRows - 1) / kQRows;
  const long long blocks = (long long)B * H * q_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  small_mha_tiled_kernel<DH><<<(unsigned)blocks, kTiledThreads, smem, stream>>>(
      q, k, v, o, L, H, q_tiles, ldq, ldk, ldv, ldo, scale * 1.4426950408889634f);
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
// sequences the tiled one.
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
  if (B <= 0 || H <= 0 || (Dh != 32 && Dh != 64) || ldq % 8 || ldk % 8 || ldv % 8 || ldo % 8)
    return (int)cudaErrorInvalidValue;
  if (Dh == 32)
    return (int)launch_tiled<32>(qb, kb, vb, ob, B, L, H, ldq, ldk, ldv, ldo, scale, s);
  return (int)launch_tiled<64>(qb, kb, vb, ob, B, L, H, ldq, ldk, ldv, ldo, scale, s);
}

extern "C" const char* id_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
