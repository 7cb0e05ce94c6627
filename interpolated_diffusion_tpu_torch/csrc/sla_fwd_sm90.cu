// Block-sparse attention forward for Hopper (sm_90a): SLA (bf16 Q K^T) and
// int8 SLA (SageSLA, s8 Q K^T) as one walk over the LUT's key tiles on wgmma
// products, with Q, K and V arriving by TMA; one producer warp, two consumer
// warpgroups, a persistent grid.
//
// Replaces two TPU kernels of interpolated_diffusion_tpu/kernels/:
//   sla_fwd_kernel<D, false>  block_sparse_attention.py::_fwd_kernel
//                             (_fwd_pallas; public block_sparse_attention,
//                             block_sparse_attention_lse)
//   sla_fwd_kernel<D, true>   int8_attention.py::_fwd_kernel_int8
//                             (_fwd_pallas_int8; public
//                             int8_block_sparse_attention)
// The TPU kernels walk a sequential grid axis over the LUT's key blocks and
// carry the running max / sum / accumulator in VMEM scratch; here one block
// owns 128 query rows of one (batch, head) and walks the key tiles that the
// LUT names in a loop, with every running statistic in registers.
//
// What bounds them on the H100: at the Wan2.1-1.3B shapes (BH = 48 or 24,
// L = 7800, Dh = 128, 768 keys a query row) the products are ~147 GFLOP (BH
// 48) against ~0.3 GB of q / k / v / o traffic, far above the card's ridge, so
// the tensor-core rate bounds them (int8 Q K^T at twice the bf16 rate). Their
// first version (mma.sync, 4 warps of 16 rows, each warp reading the whole K
// and V tile from shared memory for its own rows, a two-stage cp.async ring
// with two __syncthreads a tile) was held by shared-memory traffic at 14-20%
// of that rate. The design here is the dense flash forward's
// (flash_fwd_sm90.cu) carried over to the LUT:
//  - a work item is (head, 128 query rows); the grid is persistent (one block
//    an SM) with the query tile running fastest, so that the blocks at work
//    share a few heads' K / V in L2 while the LUT revisits them out of order;
//  - the producer warp reads the item's LUT row(s) itself (32 ids a load,
//    handed out by shuffles), expands each id into 128-key tiles, drops those
//    at or past kv_len, and starts the TMA loads of Q and of each K / V tile
//    from the 3-D [BH, L, Dh] tensor maps with the LUT-chosen key offset as
//    the row coordinate: the gather costs nothing but the coordinate, and rows
//    past L arrive as zeros. Each stage's key offset, the key limit of each
//    consumer warpgroup and a last-tile flag go to the consumers in a small
//    shared-memory slot, published by the stage's full barrier. The ring is
//    guarded by full / empty mbarriers, K and V apart;
//  - each of the two consumer warpgroups owns 64 query rows. S = Q K^T is one
//    chain of wgmma m64n128k16 (bf16) or m64n128k32 (s8, s32 sums) from shared
//    memory; the online softmax stays in registers; P is packed to bf16 in the
//    registers of S (the A fragment layout of the next wgmma) and O += P V
//    reads V through an MN-major descriptor. setmaxnreg moves the producer
//    warpgroup's registers to the consumers. The loop is software-pipelined
//    inside a warpgroup (S of the next tile is started before P V of this
//    one) and the two warpgroups take turns at the tensor cores (pingpong on
//    named barriers). The last P V of an item is peeled: a wgmma under a
//    condition makes ptxas serialise the chain (note C7514);
//  - int8: Q and K come through byte tensor maps (one box holds whole rows:
//    the 128-byte swizzle at Dh = 128, the 64-byte swizzle at Dh = 64). The
//    query scales are read once an item, two a thread; the producer warp's
//    lanes copy each tile's 128 key scales into shared memory by cp.async,
//    counted on the stage's full barrier (a TMA box of a head's scales cannot
//    start 16-byte aligned when Lk % 4 != 0). P V stays bf16.
// Shapes the wrapper takes that this walk pays extra for (none is on the Wan
// paths, which use blocks of 128 and 256): when block_m is an odd multiple of
// 64, the two halves of an item may lie in different query blocks; the
// producer then walks both LUT rows one after the other and each warpgroup
// masks the tiles of the other's row (its key limit is the tile's first key),
// which doubles the item's products. When block_n % 128 == 64, the last tile
// of each id is a full 128-key tile whose upper 64 keys are masked.
// Both head dims the wrappers take (64 and 128) run this kernel.
//
// Semantics, as the TPU kernels and the plain twins:
//  - logits in base 2, scaled by scale * log2(e); int8 logits are
//    (float)s32 * (sq[row] * sk[key]) * scale_log2, in that order;
//  - the LUT [BH, M, topk] names key blocks of block_n rows for each query
//    block of block_m rows (both multiples of 64); duplicated ids count twice;
//    keys at or past kv_len get probability 0 (their logits are -inf before the
//    max; a zero-filled key is not a masked key), and a tile wholly at or past
//    kv_len is not walked (the sentinel of block_sparse_attention_lse);
//  - a row with no visible key gives o = 0 and lse = log2(1e-30), never NaN:
//    an item with no tile walks one fully masked tile, and the softmax's base
//    is 0 while the row's max is -inf;
//  - P is rounded to bf16 for P V, the row sum uses f32 P (P rounded per
//    128-key tile); o = acc * (1 / l) rounded to bf16 (the TPU kernels divide,
//    acc / l: the product can differ by an f32 ulp, one division a row instead
//    of D), lse = m + log2(l) (f32, base 2).
// Each output row has one writer and there are no atomics: two calls give the
// same bits.
#include <math.h>
#include <stdint.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace {

using id_attn::bf16;
using id_attn::ex2;
using id_attn::kMaxTiles;   // topk * block_n / 64 per query block (the wrapper's bound)
using id_attn::pack_bf16;
using id_attn::quad_max;
using id_attn::quad_sum;
using namespace id_sm90;

constexpr int kBM = 128;          // query rows per work item, 64 per consumer warpgroup
constexpr int kBN = 128;          // keys per tile
constexpr int kBox = 64;          // bf16 per 128-byte swizzled row of a TMA box
constexpr int kStages = 2;        // K / V ring depth: a third stage bought nothing
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup

struct Params {
  const int* lut;         // [BH, m_blocks, topk]
  const float* q_scale;   // [BH, Lq] (int8 only)
  const float* k_scale;   // [BH, Lk] (int8 only)
  bf16* o;                // [BH, Lq, D]
  float* lse;             // [BH, Lq], base 2
  int Lq, Lk, kv_len, m_blocks, topk, block_m, block_n, q_tiles, n_items;
  float scale_log2;       // softmax scale * log2(e)
};

template <int D, bool INT8>
struct Cfg {
  // Q and K: bf16 in D / 64 boxes of [rows, 64] (128-byte rows); int8 in one
  // box of [rows, D] (D-byte rows). V: bf16 boxes of [128 keys, 64].
  static constexpr int kQKBoxes = INT8 ? 1 : D / kBox;
  static constexpr int kQKBoxRow = INT8 ? D : 128;
  static constexpr int kQKBoxBytes = kBM * kQKBoxRow;   // kBM == kBN
  static constexpr int kQKTile = kQKBoxes * kQKBoxBytes;
  static constexpr int kVBoxBytes = kBN * 128;
  static constexpr int kVTile = (D / kBox) * kVBoxBytes;
  static constexpr int kOffK = kQKTile;
  static constexpr int kOffV = kOffK + kStages * kQKTile;
  static constexpr int kOffSk = kOffV + kStages * kVTile;   // int8: the key scales of each stage
  static constexpr int kOffSlot = kOffSk + (INT8 ? kStages * kBN * 4 : 0);
  static constexpr int kOffBar = kOffSlot + kStages * 16;
  // q full / empty, then full_k, full_v, empty_k, empty_v per stage
  static constexpr int kBars = 2 + 4 * kStages;
  // + 1024: the kernel aligns its base itself (the swizzle pattern of TMA and
  // of the wgmma descriptors is a function of the address bits)
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
  // full_k: the TMA's expect_tx, and (int8) the producer lanes' scale copies
  static constexpr int kFullK = INT8 ? 1 + 32 : 1;
};

// Descriptor of k-step ks (32 bytes) of a K-major Q or K operand whose boxes
// are `box` bytes apart.
template <int D, bool INT8>
__device__ __forceinline__ uint64_t qk_desc(uint32_t addr, int ks, int box) {
  if constexpr (INT8 && D == 64) return smem_desc_sw64(addr + ks * 32, 16, 512);
  return smem_desc(addr + (ks / 4) * box + (ks % 4) * 32, 16, 1024);
}

// grid (min(SMs, work items)), 384 threads; a block takes items blockIdx.x,
// + gridDim.x, ... Accumulator layout of wgmma m64nN (PTX ISA; the same for
// s32), lane = 4 g + t of warp w of the warpgroup: register 4 j + e holds row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
template <int D, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
sla_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Cfg<D, INT8>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  int4* slots = reinterpret_cast<int4*>(sbase + C::kOffSlot);   // {key0, lim wg 0, lim wg 1, last}
  const uint32_t bars = base + C::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), C::kFullK);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerWarps * 32) {
    // ---- producer warp: lane 0 starts every TMA load and writes the slots;
    // the lanes share the LUT reads and (int8) copy the key scales. It runs
    // ahead of the consumers across work items. -------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != kConsumerWarps) return;
    const int lane = threadIdx.x % 32;
    int t = 0;   // tiles loaded so far: ring stage and phase
    auto load_tile = [&](int bh, int key0, int lim0, int lim1, int last) {
      const int s = t % kStages, parity = (t / kStages) & 1;
      mbar_wait(empty_k(s), parity ^ 1);   // passes at once on the first round
      if (lane == 0) {
        slots[s] = make_int4(key0, lim0, lim1, last);   // published by full_k's arrival
        mbar_expect_tx(full_k(s), C::kQKTile);
#pragma unroll
        for (int h = 0; h < C::kQKBoxes; ++h)
          tma_load_3d(base + C::kOffK + s * C::kQKTile + h * C::kQKBoxBytes, &map_k, full_k(s),
                      h * kBox, key0, bh);
      }
      if constexpr (INT8) {   // keys past Lk get scale 0 (they are masked)
        float* sk = reinterpret_cast<float*>(sbase + C::kOffSk + s * kBN * 4);
        const float* ks = p.k_scale + (long long)bh * p.Lk;
#pragma unroll
        for (int i = lane; i < kBN; i += 32) {
          const bool ok = key0 + i < p.Lk;
          id_attn::cp_async4(sk + i, ok ? ks + key0 + i : ks, ok);
        }
        cp_async_mbar_arrive(full_k(s));
      }
      mbar_wait(empty_v(s), parity ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full_v(s), C::kVTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h)
          tma_load_3d(base + C::kOffV + s * C::kVTile + h * C::kVBoxBytes, &map_v, full_v(s),
                      h * kBox, key0, bh);
      }
      ++t;
    };

    for (int item = blockIdx.x, n = 0; item < p.n_items; item += gridDim.x, ++n) {
      const int bh = item / p.q_tiles, row0 = (item % p.q_tiles) * kBM;
      mbar_wait(q_empty, (n & 1) ^ 1);   // passes at once on the first item
      if (lane == 0) {
        mbar_expect_tx(q_full, C::kQKTile);
#pragma unroll
        for (int h = 0; h < C::kQKBoxes; ++h)
          tma_load_3d(base + h * C::kQKBoxBytes, &map_q, q_full, h * kBox, row0, bh);
      }
      // The LUT rows of the two 64-row halves: one row unless block_m is an
      // odd multiple of 64 (a half wholly past Lq follows the first). Each
      // tile is loaded once the next is known, so that the last carries its
      // flag; an item with no tile walks one fully masked tile.
      const int mb0 = row0 / p.block_m;
      const int mb1 = row0 + 64 < p.Lq ? (row0 + 64) / p.block_m : mb0;
      const int halves = mb1 != mb0 ? 2 : 1;
      int pend = -1, pend_lim0 = 0, pend_lim1 = 0;
      for (int half = 0; half < halves; ++half) {
        const int* row = p.lut + ((long long)bh * p.m_blocks + (half ? mb1 : mb0)) * p.topk;
        const int own = halves == 1 ? 3 : 1 << half;   // warpgroups that see this row's keys
        for (int j0 = 0; j0 < p.topk; j0 += 32) {
          const int mine = j0 + lane < p.topk ? row[j0 + lane] : -1;
          const int cnt = min(32, p.topk - j0);
          for (int jj = 0; jj < cnt; ++jj) {
            const int id = __shfl_sync(0xffffffffu, mine, jj);
            if (id < 0) continue;
            const long long first = (long long)id * p.block_n;
            const int end = first + p.block_n < p.kv_len ? (int)(first + p.block_n) : p.kv_len;
            for (long long key0 = first; key0 < end; key0 += kBN) {
              if (pend >= 0) load_tile(bh, pend, pend_lim0, pend_lim1, 0);
              pend = (int)key0;
              pend_lim0 = own & 1 ? end : pend;
              pend_lim1 = own & 2 ? end : pend;
            }
          }
        }
      }
      if (pend >= 0) load_tile(bh, pend, pend_lim0, pend_lim1, 1);
      else load_tile(bh, 0, 0, 0, 1);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");   // 2 x 128 x 232 + 128 x 40
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_addr = base + wg * (64 * C::kQKBoxRow);   // this warpgroup's 64 rows of each box

    float s[64];
    int si[INT8 ? 64 : 1];
    float acc[D / 2];
    float m_run[2], l_run[2], alpha[2], sq[2];
    uint32_t pa[8][4];
    int t = 0;   // tiles consumed before this work item

    // S = Q K^T for ring tile u (64 rows x 128 keys), one wgmma group left in
    // flight; returns the tile's slot
    auto start_s = [&](int u) -> int4 {
      const int st = u % kStages;
      const uint32_t k_addr = base + C::kOffK + st * C::kQKTile;
      mbar_wait(full_k(st), (u / kStages) & 1);
      const int4 info = slots[st];
      if constexpr (INT8) {
#pragma unroll
        for (int ks = 0; ks < D / 32; ++ks)
          wgmma_s8(si, qk_desc<D, INT8>(q_addr, ks, C::kQKBoxBytes),
                   qk_desc<D, INT8>(k_addr, ks, C::kQKBoxBytes), ks > 0);
      } else {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss(s, qk_desc<D, INT8>(q_addr, ks, C::kQKBoxBytes),
                   qk_desc<D, INT8>(k_addr, ks, C::kQKBoxBytes), ks > 0);
      }
      wgmma_commit();
      return info;
    };
    // O += P V for ring tile u, 16 keys a k-step; one group left in flight
    auto start_pv = [&](int u) {
      const int st = u % kStages;
      const uint32_t v_addr = base + C::kOffV + st * C::kVTile;
      mbar_wait(full_v(st), (u / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(acc, pa[kk], smem_desc(v_addr + kk * (16 * 128), C::kVBoxBytes, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // Once S of ring tile u is complete: base-2 logits (int8: dequantised with
    // the stage's key scales, read before the stage is released), keys at or
    // past this warpgroup's limit at -inf, then the online softmax in place:
    // P = exp2(s - max), the running max and sum, alpha = exp2(old - new max).
    // While a row has no visible key its max is -inf and the base 0, so P = 0.
    auto softmax = [&](int u, const int4& info) {
      if constexpr (INT8) {
        fence_regs(si);
        const float* sk =
            reinterpret_cast<const float*>(sbase + C::kOffSk + (u % kStages) * kBN * 4);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * j + 2 * t4);
          s[4 * j] = (float)si[4 * j] * (sq[0] * k2.x) * p.scale_log2;
          s[4 * j + 1] = (float)si[4 * j + 1] * (sq[0] * k2.y) * p.scale_log2;
          s[4 * j + 2] = (float)si[4 * j + 2] * (sq[1] * k2.x) * p.scale_log2;
          s[4 * j + 3] = (float)si[4 * j + 3] * (sq[1] * k2.y) * p.scale_log2;
        }
        __syncwarp();   // every lane has read the scales before lane 0 releases the stage
      } else {
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= p.scale_log2;
      }
      release(empty_k(u % kStages));
      const int key0 = info.x, lim = wg ? info.z : info.y;
      if (key0 + kBN > lim) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int key = key0 + 8 * j + 2 * t4;
          if (key >= lim) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (key + 1 >= lim) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
      float b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        const float m_new = fmaxf(m_run[r], quad_max(mx));
        b[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m_run[r] - b[r]);
        m_run[r] = m_new;
      }
      float rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = ex2(s[i] - b[(i % 4) / 2]);
        rowsum[(i % 4) / 2] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
    };

    // Pingpong: named barrier 1 + wg lets this warpgroup start its products;
    // it is opened by the other warpgroup once that one has started its own.
    // Both walk the same tiles, so they take the same number of turns.
    // Warpgroup 0 goes first.
    if (wg == 1) named_arrive(1);

    for (int item = blockIdx.x, n = 0; item < p.n_items; item += gridDim.x, ++n) {
      const int bh = item / p.q_tiles, row0 = (item % p.q_tiles) * kBM;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      if constexpr (INT8) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
          sq[r] = row < p.Lq ? p.q_scale[(long long)bh * p.Lq + row] : 0.f;
        }
      }

      // Software pipeline, as flash_fwd_sm90.cu: while the tensor cores run
      // O += P_u V_u and S = Q K_{u+1}^T, the warpgroup takes the softmax of
      // tile u + 1; O is rescaled by its alpha once P_u V_u has landed. The
      // walk ends at the tile whose slot says last; its P V is peeled off.
      mbar_wait(q_full, n & 1);
      wgmma_fence();
      int4 cur = start_s(t);
      wgmma_wait<0>();
      softmax(t, cur);   // acc is 0: alpha unused
      pack_a(pa, s);
      while (!cur.w) {
        named_sync(1 + wg);
        wgmma_fence();
        const int4 nxt = start_s(t + 1);
        start_pv(t);
        named_arrive(2 - wg);
        wgmma_wait<1>();   // S of tile t + 1
        softmax(t + 1, nxt);
        wgmma_wait<0>();   // P V of tile t
        fence_regs(acc);
        release(empty_v(t % kStages));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
        pack_a(pa, s);
        ++t;
        cur = nxt;
      }
      release(q_empty);    // every S of this item is complete: Q may be overwritten
      wgmma_fence();
      start_pv(t);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v(t % kStages));
      ++t;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = fmaxf(quad_sum(l_run[r]), 1e-30f);
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row >= p.Lq) continue;
        const float inv = 1.f / l;
        bf16* orow = p.o + ((long long)bh * p.Lq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (t4 == 0)
          p.lse[(long long)bh * p.Lq + row] = (m_run[r] == -INFINITY ? 0.f : m_run[r]) + log2f(l);
      }
    }
  }
}

template <int D, bool INT8>
cudaError_t launch(const void* q, const void* k, const void* v, Params p, int BH,
                   cudaStream_t stream) {
  using C = Cfg<D, INT8>;
  CUtensorMap mq, mk, mv;
  const bool maps = INT8 ? make_i8_heads_map(&mq, q, BH, p.Lq, D, kBM) &&
                               make_i8_heads_map(&mk, k, BH, p.Lk, D, kBN)
                         : make_heads_map(&mq, q, BH, p.Lq, D, kBM) &&
                               make_heads_map(&mk, k, BH, p.Lk, D, kBN);
  if (!maps || !make_heads_map(&mv, v, BH, p.Lk, D, kBN)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      sla_fwd_kernel<D, INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return e;
  p.q_tiles = (p.Lq + kBM - 1) / kBM;
  const long long n_items = (long long)p.q_tiles * BH;
  const int sms = sm_count();
  if (sms <= 0 || n_items > 2147483647LL) return cudaErrorInvalidValue;
  p.n_items = (int)n_items;
  const int grid = n_items < sms ? (int)n_items : sms;
  sla_fwd_kernel<D, INT8><<<grid, kThreads, C::kBytes, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <bool INT8>
int dispatch(const void* q, const void* k, const void* v, const Params& p, int BH, int D,
             void* stream) {
  if (BH <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.kv_len < 0 || p.kv_len > p.Lk)
    return (int)cudaErrorInvalidValue;
  if (p.block_m <= 0 || p.block_m % 64 || p.block_n <= 0 || p.block_n % 64 || p.topk <= 0 ||
      p.m_blocks != (p.Lq + p.block_m - 1) / p.block_m ||
      (long long)p.topk * (p.block_n / 64) > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, INT8>(q, k, v, p, BH, s);
  if (D == 128) return (int)launch<128, INT8>(q, k, v, p, BH, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* lut, const void* q_scale, const void* k_scale, void* o, void* lse,
                   int Lq, int Lk, int kv_len, int topk, int block_m, int block_n,
                   float scale_log2) {
  return Params{static_cast<const int*>(lut), static_cast<const float*>(q_scale),
                static_cast<const float*>(k_scale), static_cast<bf16*>(o),
                static_cast<float*>(lse), Lq, Lk, kv_len,
                block_m > 0 ? (Lq + block_m - 1) / block_m : 0, topk, block_m, block_n, 0, 0,
                scale_log2};
}

}  // namespace

// Block-sparse attention forward (SLA): q/k/v bf16 [BH, L, D], lut int32
// [BH, ceil(Lq / block_m), topk], all contiguous -> o bf16 [BH, Lq, D], lse
// f32 [BH, Lq] (base 2). D in {64, 128}. The tensor maps hold the data
// pointers, so they are encoded per call (on the host, no allocation).
extern "C" int id_sla_fwd(const void* q, const void* k, const void* v, const void* lut,
                          void* o, void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                          int topk, int block_m, int block_n, float scale_log2,
                          void* stream) {
  const Params p = make_params(lut, nullptr, nullptr, o, lse, Lq, Lk, kv_len, topk, block_m,
                               block_n, scale_log2);
  return dispatch<false>(q, k, v, p, BH, D, stream);
}

// int8 block-sparse attention forward (SageSLA): q/k int8 [BH, L, D] with f32
// row scales [BH, L], v bf16; otherwise as id_sla_fwd.
extern "C" int id_sla_int8_fwd(const void* q, const void* k, const void* v,
                               const void* q_scale, const void* k_scale, const void* lut,
                               void* o, void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                               int topk, int block_m, int block_n, float scale_log2,
                               void* stream) {
  const Params p = make_params(lut, q_scale, k_scale, o, lse, Lq, Lk, kv_len, topk, block_m,
                               block_n, scale_log2);
  return dispatch<true>(q, k, v, p, BH, D, stream);
}
