// Block-sparse (SLA) attention backward for Hopper (sm_90a): dQ and dK/dV.
// (The dense flash backward is flash_bwd_sm90.cu.)
//
// Replaces two TPU kernels of
// interpolated_diffusion_tpu/kernels/block_sparse_attention.py:
//   attn_bwd_dq_kernel<D>     _dq_kernel    (_bwd_pallas)
//   attn_bwd_dkdv_kernel<D>   _dkdv_kernel  (_bwd_pallas)
// The TPU kernels walk a sequential grid axis (key blocks for dQ, query blocks
// for dK/dV) and carry their f32 sums in VMEM scratch. Here a block of 4 warps
// owns 64 query rows (dQ) or 64 key rows (dK/dV), walks the tiles of the other
// side in a loop, and keeps its sums in registers, so that every output row is
// written by exactly one block: no atomics, the same bits every run.
//
// What bounds them on the H100: at the Wan2.1-1.3B training shapes (BH = 24,
// L = 7800, Dh = 128, 3 key blocks of 256 per query block) the two kernels do
// ~184 GFLOP of products over ~0.25 GB of q/k/v/do/dq/dk/dv traffic: far
// above the bf16 ridge, so the tensor-core rate bounds them. All five products (Q K^T,
// dO V^T, dS K, P^T dO, dS^T Q) run on the tensor cores through mma.sync
// (bf16 m16n8k16, f32 accumulate). S, P, dP and dS never leave registers: the
// accumulator fragments of S are repacked as the A operand of the next
// product. Operands whose contraction index is the shared-memory row (K in
// dS K, dO in P^T dO, Q in dS^T Q) are read with ldmatrix.trans. The walked
// tiles come through a two-stage cp.async ring. The dK/dV kernel holds two
// 16 x D f32 accumulators per warp; it takes each 64-row query tile in two
// halves of 32 rows so that S^T and dP^T need 16 registers each instead of
// 32. wgmma, TMA and warp specialisation are later work.
//
// Semantics, as the TPU kernels and the plain twins:
//  - s = (q . k) * scale * log2(e) in f32, -inf at key positions >= kv_len;
//    p = exp2(s - lse) with the forward's base-2 lse;
//  - dp = do . v in f32; ds = p * (dp - delta) * scale (scale, not
//    scale * log2(e)); delta = sum(o * do) over the head dim comes from the
//    caller; ds is rounded to bf16 before ds . k and ds^T . q, p before
//    p^T . do; sums in f32; dq, dk, dv written as bf16;
//  - SLA dK/dV: a query block contributes to key block n as many times as n
//    occurs in its LUT row; p^T is multiplied by that count before the
//    rounding, so a LUT with duplicated ids gives gradients consistent with
//    the forward and with dQ (which walks the LUT entry by entry). Each block
//    finds its query blocks by scanning the head's LUT once;
//  - query rows past Lq are read as zeros (q, do, delta) and add nothing; K/V
//    rows past the tensor are read as zeros and masked; the LUT granularity
//    (block_m, block_n: multiples of 64) expands into 64-row tiles.
#include "attention_common.cuh"
#include "id_kernels.cuh"

namespace {

using namespace id_attn;

struct BwdParams {
  const bf16* q;       // [BH, Lq, D]
  const bf16* k;       // [BH, Lk, D]
  const bf16* v;       // [BH, Lk, D]
  const bf16* dout;    // [BH, Lq, D]
  const float* lse;    // [BH, Lq], base 2
  const float* delta;  // [BH, Lq]
  const int* lut;      // [BH, m_blocks, topk]
  bf16* dq;            // [BH, Lq, D] (dQ kernel)
  bf16* dk;            // [BH, Lk, D] (dK/dV kernel)
  bf16* dv;            // [BH, Lk, D]
  int Lq, Lk, kv_len, m_blocks, topk, block_m, block_n;
  float scale_log2;    // softmax scale * log2(e)
  float scale;
};

template <int D>
struct BCfg {
  static constexpr int kRow = 2 * D;        // bytes of one row in memory
  static constexpr int kLd = 2 * D + 16;    // shared-memory row stride (bank spread)
  static constexpr int kTile = 64 * kLd;
  static constexpr int kNd = D / 8;         // 8-wide output column blocks
  static constexpr int kKs = D / 16;        // k-steps over the head dim
};

// A fragment (rows g, g + 8 of a 16-row slab at `rows`, k columns of step ks)
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* rows, int g, int t4,
                                       int ks) {
  const unsigned char* r = rows + g * LD + (ks * 16 + t4 * 2) * 2;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * LD);
  a[2] = ld32(r + 16);
  a[3] = ld32(r + 8 * LD + 16);
}

// acc[nd] += A(16 x 16) . B, B = rows [k0, k0 + 16) of a shared tile with the
// row as contraction index, all D columns: two column blocks per ldmatrix.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                         const unsigned char* tile, int k0, int lane) {
  constexpr int LD = BCfg<D>::kLd;
  const unsigned char* base = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              ((lane >> 4) & 1) * 16;
#pragma unroll
  for (int nd = 0; nd < D / 8; nd += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, base + nd * 16);
    mma_bf16(acc[nd], a, b[0], b[1]);
    mma_bf16(acc[nd + 1], a, b[2], b[3]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per 64 query rows, loop over the key tiles of its LUT row
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const BwdParams p) {
  using C = BCfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + C::kTile;
  unsigned char* sK = smem + 2 * C::kTile;   // two stages
  unsigned char* sV = smem + 4 * C::kTile;   // two stages
  int* tiles = reinterpret_cast<int*>(smem + 6 * C::kTile);
  __shared__ int n_tiles_s;

  const int bh = blockIdx.y, row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const unsigned char* qg = reinterpret_cast<const unsigned char*>(p.q + (long long)bh * p.Lq * D);
  const unsigned char* dog =
      reinterpret_cast<const unsigned char*>(p.dout + (long long)bh * p.Lq * D);
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(p.k + (long long)bh * p.Lk * D);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(p.v + (long long)bh * p.Lk * D);

  if (threadIdx.x == 0) {
    const int* lut = p.lut + ((long long)bh * p.m_blocks + row0 / p.block_m) * p.topk;
    const int per = p.block_n / kBN;
    int n = 0;
    for (int j = 0; j < p.topk; ++j) {
      const int id = lut[j];
      for (int s = 0; s < per && id >= 0; ++s) {
        const long long start = (long long)id * p.block_n + s * kBN;
        if (start < p.kv_len && n < kMaxTiles) tiles[n++] = (int)start;
      }
    }
    n_tiles_s = n;
  }
  __syncthreads();
  const int n_tiles = n_tiles_s;
  auto load_tile = [&](int i, int stage) {
    const int key0 = tiles[i];
    load_rows(sK + stage * C::kTile, C::kLd, kg, C::kRow, key0, p.Lk);
    load_rows(sV + stage * C::kTile, C::kLd, vg, C::kRow, key0, p.Lk);
  };

  load_rows(sQ, C::kLd, qg, C::kRow, row0, p.Lq);
  load_rows(sdO, C::kLd, dog, C::kRow, row0, p.Lq);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // rows r0 = row0 + 16 * warp + g and r0 + 8 of this thread
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    const bool ok = row < p.Lq;
    lse_r[r] = ok ? p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta_r[r] = ok ? p.delta[(long long)bh * p.Lq + row] : 0.f;
  }
  float acc[C::kNd][4];
#pragma unroll
  for (int i = 0; i < C::kNd; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const unsigned char* qa = sQ + warp * 16 * C::kLd;
  const unsigned char* doa = sdO + warp * 16 * C::kLd;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* tK = sK + stage * C::kTile;
    const unsigned char* tV = sV + stage * C::kTile;
    const int key0 = tiles[it];

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::kKs; ++ks) {
      uint32_t a[4];
      load_a<C::kLd>(a, qa, g, t4, ks);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const unsigned char* kb = tK + (nb * 8 + g) * C::kLd + (ks * 16 + t4 * 2) * 2;
        mma_bf16(s[nb], a, ld32(kb), ld32(kb + 16));
      }
    }
#pragma unroll
    for (int ks = 0; ks < C::kKs; ++ks) {
      uint32_t a[4];
      load_a<C::kLd>(a, doa, g, t4, ks);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const unsigned char* vb = tV + (nb * 8 + g) * C::kLd + (ks * 16 + t4 * 2) * 2;
        mma_bf16(dp[nb], a, ld32(vb), ld32(vb + 16));
      }
    }
    // dS = P (dP - delta) scale, P = exp2(S - lse), 0 at masked keys
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nb * 8 + 2 * t4 + (e & 1);
        const float pr =
            key < p.kv_len ? exp2f(s[nb][e] * p.scale_log2 - lse_r[e / 2]) : 0.f;
        s[nb][e] = pr * (dp[nb][e] - delta_r[e / 2]) * p.scale;
      }
    // dQ += dS K: dS (bf16) from the registers as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_rows<D>(acc, a, tK, kk * 16, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= p.Lq) continue;
    bf16* out = p.dq + ((long long)bh * p.Lq + row) * D;
#pragma unroll
    for (int nd = 0; nd < C::kNd; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8 + 2 * t4) =
          pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per 64 key rows, loop over the query tiles whose LUT row
// names this key block, weighted by how often
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const BwdParams p, int n_qtiles_max) {
  using C = BCfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::kTile;
  unsigned char* sQ = smem + 2 * C::kTile;    // two stages
  unsigned char* sdO = smem + 4 * C::kTile;   // two stages
  float* sLse = reinterpret_cast<float*>(smem + 6 * C::kTile);   // [2][64]
  float* sDelta = sLse + 2 * kBM;                                // [2][64]
  int* q_rows = reinterpret_cast<int*>(sDelta + 2 * kBM);        // first row of each query tile
  int* q_cnts = q_rows + n_qtiles_max;                           // its weight
  int* m_cnts = q_cnts + n_qtiles_max;                           // [m_blocks]
  __shared__ int n_tiles_s;

  const int bh = blockIdx.y, key0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const unsigned char* qg = reinterpret_cast<const unsigned char*>(p.q + (long long)bh * p.Lq * D);
  const unsigned char* dog =
      reinterpret_cast<const unsigned char*>(p.dout + (long long)bh * p.Lq * D);
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(p.k + (long long)bh * p.Lk * D);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(p.v + (long long)bh * p.Lk * D);
  const float* lseg = p.lse + (long long)bh * p.Lq;
  const float* deltag = p.delta + (long long)bh * p.Lq;

  // how often each query block's LUT row names this key block
  const int nb = key0 / p.block_n;
  const int* lut = p.lut + (long long)bh * p.m_blocks * p.topk;
  for (int m = threadIdx.x; m < p.m_blocks; m += kThreads) {
    int c = 0;
    for (int j = 0; j < p.topk; ++j) c += lut[m * p.topk + j] == nb;
    m_cnts[m] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int per = p.block_m / kBM;
    int nt = 0;
    for (int m = 0; m < p.m_blocks; ++m) {
      if (m_cnts[m] == 0) continue;
      for (int s = 0; s < per; ++s) {
        const int row = m * p.block_m + s * kBM;
        if (row < p.Lq && nt < n_qtiles_max) {
          q_rows[nt] = row;
          q_cnts[nt++] = m_cnts[m];
        }
      }
    }
    n_tiles_s = nt;
  }
  __syncthreads();
  const int n_tiles = n_tiles_s;
  auto load_tile = [&](int i, int stage) {
    const int row0 = q_rows[i];
    load_rows(sQ + stage * C::kTile, C::kLd, qg, C::kRow, row0, p.Lq);
    load_rows(sdO + stage * C::kTile, C::kLd, dog, C::kRow, row0, p.Lq);
    if (threadIdx.x < kBM) {
      const int r = row0 + threadIdx.x;
      const bool ok = r < p.Lq;
      cp_async4(sLse + stage * kBM + threadIdx.x, ok ? lseg + r : lseg, ok);
      cp_async4(sDelta + stage * kBM + threadIdx.x, ok ? deltag + r : deltag, ok);
    }
  };

  load_rows(sK, C::kLd, kg, C::kRow, key0, p.Lk);
  load_rows(sV, C::kLd, vg, C::kRow, key0, p.Lk);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's key rows: key0 + 16 * warp + g and + 8
  float dk[C::kNd][4], dv[C::kNd][4];
#pragma unroll
  for (int i = 0; i < C::kNd; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const unsigned char* ka = sK + warp * 16 * C::kLd;
  const unsigned char* va = sV + warp * 16 * C::kLd;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = key0 + warp * 16 + g + 8 * r < p.kv_len;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* tQ = sQ + stage * C::kTile;
    const unsigned char* tdO = sdO + stage * C::kTile;
    const float* tLse = sLse + stage * kBM;
    const float* tDelta = sDelta + stage * kBM;
    const float cnt = (float)q_cnts[it];

#pragma unroll 1   // the halves share registers; unrolled they would not fit in 255
    for (int half = 0; half < 2; ++half) {   // 32 query rows at a time
      const int qoff = half * 32;
      // S^T = K Q^T for the warp's 16 keys x 32 queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C::kKs; ++ks) {
        uint32_t a[4];
        load_a<C::kLd>(a, ka, g, t4, ks);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const unsigned char* qb = tQ + (qoff + nb * 8 + g) * C::kLd + (ks * 16 + t4 * 2) * 2;
          mma_bf16(st[nb], a, ld32(qb), ld32(qb + 16));
        }
      }
      // P^T = exp2(S^T - lse) * count, 0 at masked keys
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qoff + nb * 8 + 2 * t4 + (e & 1);
          st[nb][e] = key_ok[e / 2] ? exp2f(st[nb][e] * p.scale_log2 - tLse[qc]) * cnt : 0.f;
        }
      // dV += P^T dO: P^T (bf16) as the A operand, 16 queries a step
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                               pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                               pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                               pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        mma_rows<D>(dv, a, tdO, qoff + kk * 16, lane);
      }
      // dP^T = V dO^T
#pragma unroll
      for (int ks = 0; ks < C::kKs; ++ks) {
        uint32_t a[4];
        load_a<C::kLd>(a, va, g, t4, ks);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const unsigned char* ob = tdO + (qoff + nb * 8 + g) * C::kLd + (ks * 16 + t4 * 2) * 2;
          mma_bf16(dpt[nb], a, ld32(ob), ld32(ob + 16));
        }
      }
      // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qoff + nb * 8 + 2 * t4 + (e & 1);
          st[nb][e] = st[nb][e] * (dpt[nb][e] - tDelta[qc]) * p.scale;
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                               pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                               pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                               pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        mma_rows<D>(dk, a, tQ, qoff + kk * 16, lane);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + g + 8 * r;
    if (key >= p.Lk) continue;
    bf16* outk = p.dk + ((long long)bh * p.Lk + key) * D;
    bf16* outv = p.dv + ((long long)bh * p.Lk + key) * D;
#pragma unroll
    for (int nd = 0; nd < C::kNd; ++nd) {
      *reinterpret_cast<uint32_t*>(outk + nd * 8 + 2 * t4) =
          pack_bf16(dk[nd][2 * r], dk[nd][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(outv + nd * 8 + 2 * t4) =
          pack_bf16(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

constexpr size_t kMaxSmem = 227 * 1024;

bool bad_shapes(const BwdParams& p, int BH) {
  if (BH <= 0 || BH > 65535 || p.Lq <= 0 || p.Lk <= 0 || p.kv_len < 0 || p.kv_len > p.Lk)
    return true;
  return p.block_m <= 0 || p.block_m % kBM || p.block_n <= 0 || p.block_n % kBN ||
         p.topk <= 0 || p.m_blocks != (p.Lq + p.block_m - 1) / p.block_m ||
         (long long)p.topk * (p.block_n / kBN) > kMaxTiles;
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int BH, cudaStream_t stream) {
  const size_t smem = 6 * BCfg<D>::kTile + kMaxTiles * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Lq + kBM - 1) / kBM, BH);
  attn_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const BwdParams& p, int BH, cudaStream_t stream) {
  // room for the query-tile list: every query block expands into block_m / 64 tiles
  const int n_qtiles_max = p.m_blocks * (p.block_m / kBM);
  const size_t smem = 6 * BCfg<D>::kTile + 4 * kBM * sizeof(float) +
                      (2 * (size_t)n_qtiles_max + p.m_blocks) * sizeof(int);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Lk + kBN - 1) / kBN, BH);
  attn_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(p, n_qtiles_max);
  return cudaGetLastError();
}

int dispatch_dq(const BwdParams& p, int BH, int D, void* stream) {
  if (bad_shapes(p, BH)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dq<64>(p, BH, s);
  if (D == 128) return (int)launch_dq<128>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_dkdv(const BwdParams& p, int BH, int D, void* stream) {
  if (bad_shapes(p, BH)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dkdv<64>(p, BH, s);
  if (D == 128) return (int)launch_dkdv<128>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* lut, void* dq, void* dk,
                      void* dv, int Lq, int Lk, int kv_len, int topk, int block_m, int block_n,
                      float scale_log2, float scale) {
  return BwdParams{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                   static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<const int*>(lut), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), Lq, Lk, kv_len,
                   block_m > 0 ? (Lq + block_m - 1) / block_m : 0, topk, block_m, block_n,
                   scale_log2, scale};
}

}  // namespace

// SLA backward, dQ: q/k/v/dout bf16 [BH, L, D], lse/delta f32 [BH, Lq], lut
// int32 [BH, ceil(Lq / block_m), topk] -> dq bf16 [BH, Lq, D].
extern "C" int id_sla_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* lut, void* dq,
                             int BH, int Lq, int Lk, int D, int kv_len, int topk, int block_m,
                             int block_n, float scale_log2, float scale, void* stream) {
  return dispatch_dq(make_params(q, k, v, dout, lse, delta, lut, dq, nullptr, nullptr, Lq, Lk,
                                 kv_len, topk, block_m, block_n, scale_log2, scale),
                     BH, D, stream);
}

// SLA backward, dK and dV: as id_sla_bwd_dq -> dk, dv bf16 [BH, Lk, D].
extern "C" int id_sla_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* lut, void* dk,
                               void* dv, int BH, int Lq, int Lk, int D, int kv_len, int topk,
                               int block_m, int block_n, float scale_log2, float scale,
                               void* stream) {
  return dispatch_dkdv(make_params(q, k, v, dout, lse, delta, lut, nullptr, dk, dv, Lq, Lk,
                                   kv_len, topk, block_m, block_n, scale_log2, scale),
                       BH, D, stream);
}
