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
// for L <= 256 (both entries, and the attention inside fused_film_block),
// small_mha_tiled_kernel for 256 < L (small_mha alone, whose window is
// H*L <= 1024; see below).
//
// What bounds it on the H100: at the maze Stage-2 shape (B=1024, L=64, H=12,
// Dh=32) the QK^T and P.V products are ~6.4 GFLOP while q/k/v/o move ~200 MB
// (counted from the shapes), so the kernel should be bound by device-memory
// bytes. A first version (one block per (sample, head), WMMA, logits through
// a shared f32 strip that was read back a scalar at a time three times over,
// P and O staged through shared memory again) was bound by latency at five
// times its byte bound. small_mha_kernel now is the register-resident form of
// the tiled kernel below, with two differences that its contract forces:
//  - a warp holds the logits of its 16 query rows for ALL keys in registers
//    (L / 2 floats a thread: 32 at L = 64, 128 at L = 256; the kernel is
//    instantiated for strips of 16, 32, 64, 128 and 256 keys), so each row's
//    full max and sum are known before P = exp2(s - max) / sum is rounded to
//    bf16: the TPU kernel's rounding point, with no online rescale;
//  - a block takes several neighbouring heads of one sample: as many as make
//    128 columns (4 heads of 32, 2 of 64), so that its cp.async loads are
//    256-byte runs of the q / k / v rows instead of 64-byte pieces and the
//    grid is B * H / 4 blocks of 48 KB tiles rather than B * H of 4 KB; fewer
//    heads when L is long, so that the tiles stay within 64 KB and 2-4 blocks
//    share an SM, whose loads then run under each other's products. The four
//    warps of a block share out the (head, 16 query rows) items.
// S's accumulators (mma.sync m16n8k16) are packed in place into the A
// fragments of P.V, K and V fragments come by ldmatrix (V transposed on the
// way), the scale is folded into exp2, and O goes from registers straight
// into the packed [B, L, H * Dh] layout with no head transpose. L is padded
// to a multiple of 16 inside the block; padded keys get probability 0 and
// padded query rows are not written. PERF.md has its time beside the bound.
//
// Above L = 256 a warp's logits strip no longer fits its registers.
// small_mha_tiled_kernel
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
#include <stdint.h>

#include "attention_common.cuh"
#include "id_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 256;
constexpr int kSmallThreads = 128;   // 4 warps, each 16 query rows of one head at a time
constexpr int kGroupCols = 128;      // columns (heads x head dim) a block loads at most

// Heads a block of small_mha_kernel takes: as many as make 128 columns (a
// 256-byte run of every q / k / v row), fewer while the three tiles would not
// fit 64 KB (so that a few blocks share an SM), never more than H.
__host__ __device__ inline int heads_per_block(int Lp, int Dh, int H) {
  int hg = kGroupCols / Dh;
  while (hg > 1 && 3 * Lp * (2 * hg * Dh + 16) > 64 * 1024) hg /= 2;
  return hg < H ? hg : H;
}

// Rows [0, Lp) of `heads` neighbouring heads' [L, heads * DH] slice (row stride
// ld elements) into shared memory rows of `lds` bytes by cp.async; rows at or
// past L are zero-filled.
template <int DH>
__device__ __forceinline__ void load_group(unsigned char* dst, int lds, const bf16* src,
                                           long long ld, int L, int Lp, int heads) {
  const int chunks = heads * DH / 8;   // 16-byte pieces a row
  for (int c = threadIdx.x; c < Lp * chunks; c += kSmallThreads) {
    const int r = c / chunks, off = (c % chunks) * 16;
    const bool ok = r < L;
    const unsigned char* row = reinterpret_cast<const unsigned char*>(src + (long long)r * ld);
    id_attn::cp_async16(dst + r * lds + off,
                        ok ? row + off : reinterpret_cast<const unsigned char*>(src), ok);
  }
}

// Attention of one sample and `hg` neighbouring heads per block, L <= LMAX <=
// 256. grid (B * ceil(H / hg)), 128 threads. A warp takes one (head, 16 query
// rows) item at a time; its logits for all L keys (LMAX / 2 floats a thread),
// the probabilities and the output accumulator never leave registers.
// Fragment layouts as in attention_common.cuh: lane = 4 * g + t; the warp's
// rows g and g + 8.
template <int DH, int LMAX>
__global__ void __launch_bounds__(kSmallThreads, LMAX <= 64 ? 4 : LMAX <= 128 ? 2 : 1)
small_mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int L, int H, int hg,
                 int groups, long long ldq, long long ldk, long long ldv, long long ldo,
                 float scale_log2) {
  using namespace id_attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * hg;
  const int heads = H - h0 < hg ? H - h0 : hg;   // the last group may be short
  const int Lp = (L + 15) / 16 * 16;
  // shared rows hold hg heads and 16 bytes of padding, so that the 8 rows one
  // fragment load touches fall in distinct banks
  const int lds = 2 * hg * DH + 16;
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + Lp * lds;
  unsigned char* sV = sK + Lp * lds;
  const long long row0 = (long long)b * L;
  const int col0 = h0 * DH;
  load_group<DH>(sQ, lds, q + row0 * ldq + col0, ldq, L, Lp, heads);
  load_group<DH>(sK, lds, k + row0 * ldk + col0, ldk, L, Lp, heads);
  load_group<DH>(sV, lds, v + row0 * ldv + col0, ldv, L, Lp, heads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  constexpr int kNb = LMAX / 8;   // 8-key column blocks of S
  constexpr int kNd = DH / 8;     // 8-wide output column blocks
  constexpr int kKs = DH / 16;    // k-steps of Q K^T
  const int row_blocks = Lp / 16;

  for (int item = warp; item < heads * row_blocks; item += kSmallThreads / 32) {
    const int hh = item / row_blocks, r0 = (item % row_blocks) * 16;
    const int hcol = hh * DH * 2;   // the head's byte offset inside a shared row

    uint32_t qf[kKs][4];
    const unsigned char* qa = sQ + (r0 + g) * lds + hcol;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int c0 = (ks * 16 + t4 * 2) * 2;
      qf[ks][0] = ld32(qa + c0);
      qf[ks][1] = ld32(qa + 8 * lds + c0);
      qf[ks][2] = ld32(qa + c0 + 16);
      qf[ks][3] = ld32(qa + 8 * lds + c0 + 16);
    }

    // S = Q K^T for the warp's 16 rows and every key, in base-2 logits; keys
    // at or past L get -inf (key 0 is real, so every row's max is finite)
    float s[kNb][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      if (nb * 8 < Lp) {
        // K fragments of two k-steps a load: lanes 8i..8i+7 address key rows
        // nb * 8 .. + 7 at dims 8i .. 8i + 7 of the pair
        const unsigned char* kb = sK + (nb * 8 + (lane & 7)) * lds + hcol + (lane >> 3) * 16;
        float sf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kKs; ks += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + ks * 32);
          mma_bf16(sf, qf[ks], bk[0], bk[1]);
          mma_bf16(sf, qf[ks + 1], bk[2], bk[3]);
        }
        const int key = nb * 8 + 2 * t4;
        s[nb][0] = key < L ? sf[0] * scale_log2 : -INFINITY;
        s[nb][1] = key + 1 < L ? sf[1] * scale_log2 : -INFINITY;
        s[nb][2] = key < L ? sf[2] * scale_log2 : -INFINITY;
        s[nb][3] = key + 1 < L ? sf[3] * scale_log2 : -INFINITY;
        mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
      }
    }

    // the row's whole softmax before P is rounded: exp2(s - max) / sum
    float sum[2] = {0.f, 0.f};
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      if (nb * 8 < Lp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = ex2(s[nb][e] - mx[e / 2]);
          sum[e / 2] += s[nb][e];
        }
      }
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

    // O = P V: P (bf16) from the S registers as the A operand, 16 keys a step;
    // V fragments by ldmatrix.trans, two column blocks a load
    float acc[kNd][4];
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      if (kk * 16 < Lp) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]),
            pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]),
            pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]),
            pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1])};
        const unsigned char* vb = sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lds +
                                  hcol + ((lane >> 4) & 1) * 16;
#pragma unroll
        for (int nd = 0; nd < kNd; nd += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + nd * 16);
          mma_bf16(acc[nd], pa, bv[0], bv[1]);
          mma_bf16(acc[nd + 1], pa, bv[2], bv[3]);
        }
      }
    }

    // o straight from registers into the packed [B, L, H * DH] layout
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= L) continue;
      bf16* orow = o + (row0 + row) * ldo + col0 + hh * DH;
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t4) =
            pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
  }
}

template <int DH, int LMAX>
cudaError_t launch_small(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L,
                         int H, long long ldq, long long ldk, long long ldv, long long ldo,
                         float scale, cudaStream_t stream) {
  const int Lp = (L + 15) / 16 * 16;
  const int hg = heads_per_block(Lp, DH, H), groups = (H + hg - 1) / hg;
  const int smem = 3 * Lp * (2 * hg * DH + 16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_mha_kernel<DH, LMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (long long)B * groups;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  small_mha_kernel<DH, LMAX><<<(unsigned)blocks, kSmallThreads, smem, stream>>>(
      q, k, v, o, L, H, hg, groups, ldq, ldk, ldv, ldo, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The instantiation whose register-resident logits strip (LMAX keys) is the
// shortest that holds L.
template <int DH>
cudaError_t launch_small_dh(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L,
                            int H, long long ldq, long long ldk, long long ldv, long long ldo,
                            float scale, cudaStream_t stream) {
  if (L <= 16) return launch_small<DH, 16>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
  if (L <= 32) return launch_small<DH, 32>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
  if (L <= 64) return launch_small<DH, 64>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
  if (L <= 128)
    return launch_small<DH, 128>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
  return launch_small<DH, 256>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
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
  if (B <= 0 || H <= 0 || L <= 0 || L > kMaxL || (Dh != 32 && Dh != 64) || ldq % 8 || ldk % 8 ||
      ldv % 8 || ldo % 8)
    return cudaErrorInvalidValue;
  if (Dh == 32) return launch_small_dh<32>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
  return launch_small_dh<64>(q, k, v, o, B, L, H, ldq, ldk, ldv, ldo, scale, stream);
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
// H * L <= 1024). L <= 256 runs small_mha_kernel, longer sequences the tiled
// one.
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
