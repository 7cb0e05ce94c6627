// Block-sparse (SLA) attention backward for Hopper (sm_90a): dQ walks the
// LUT, dK/dV walks its inverse, both on wgmma products with tiles that arrive
// by TMA; one producer warp, two consumer warpgroups, persistent grids.
//
// Replaces two TPU kernels of
// interpolated_diffusion_tpu/kernels/block_sparse_attention.py:
//   sla_bwd_dq_kernel<D>     _dq_kernel    (_bwd_pallas, dQ call)
//   sla_bwd_dkdv_kernel<D>   _dkdv_kernel  (_bwd_pallas, dK/dV call)
// The TPU kernels walk a sequential grid axis (the LUT row's entries for dQ,
// every query block for dK/dV) and carry their f32 sums in VMEM scratch. Here
// a block owns 128 query rows (dQ) or 128 key rows (dK/dV) of one (batch,
// head), walks the tiles of the other side in a loop and keeps its sums in
// registers, so that every output row is written by exactly one block: no
// atomics on data, the same bits every run, as the TPU's two separate calls.
//
// What bounds them on the H100: at the Wan2.1-1.3B training shapes (BH = 24,
// L = 7800, Dh = 128, 3 key blocks of 256 per query block) dQ does three
// products (S = Q K^T, dP = dO V^T, dQ = dS K) and dK/dV four (S^T, dP^T,
// dV = P^T dO, dK = dS^T Q) over ~0.2 GB of q / k / v / do / outputs: far
// above the bf16 ridge, so the tensor-core rate bounds both. Their first
// version (mma.sync, 4 warps of 16 rows each reading the whole walked tile
// from shared memory, a two-stage cp.async ring with two __syncthreads a
// tile, a tile list built by one thread, one block per 64 rows) ran at 17-23%
// of that bound. The design here is the dense flash backward's
// (flash_bwd_sm90.cu) carried over to the LUT, as sla_fwd_sm90.cu carried the
// flash forward:
//  - the resident tiles (128 rows) and the walked tiles (64 rows) come by TMA
//    from 3-D [BH, L, Dh] tensor maps into 128-byte-swizzled shared memory,
//    with the LUT-chosen row as the coordinate (rows past L arrive as zeros),
//    through a ring of kStages stages guarded by full / empty mbarriers. Each
//    stage's walked offset and per-warpgroup limits (dQ) or weights (dK/dV)
//    go to the consumers in a 16-byte slot published by its full barrier;
//  - each consumer warpgroup owns 64 of the item's rows. S and dP (S^T and
//    dP^T) are SS wgmma with both operands K-major; P / dS are packed to bf16
//    in the registers of their f32 accumulators (the A fragment layout of the
//    next wgmma) and multiply K (dQ) or dO and Q (dK/dV) read MN-major from
//    the same swizzled tile. The two warpgroups take turns at the tensor cores
//    (pingpong on named barriers 1, 2); setmaxnreg moves the producer
//    warpgroup's registers to the consumers;
//  - dQ: a work item is (head, 128 query rows), taken in a fixed stride on a
//    persistent grid (every item walks top-k ids: equal work). The producer
//    warp reads the item's LUT row(s) itself (32 ids a load, shuffled out),
//    expands each id into 64-key tiles, so that every multiple of 64 tiles
//    exactly, and drops tiles at or past kv_len. When block_m is an odd
//    multiple of 64 the two 64-row halves of an item may lie in two LUT rows:
//    the producer walks both, and each warpgroup's key limit masks the tiles
//    of the other's row. The loop is software-pipelined inside a warpgroup (S
//    and dP of the next tile run with this tile's dQ product) and its last
//    dQ product is peeled: a wgmma under a condition serialises the chain;
//  - dK/dV: a work item is (head, 128 key rows); its walked side is the list
//    of 64-row query tiles whose query block names the item's key block(s),
//    each with the number of times it names it. The producer warp builds that
//    list itself, 32 query blocks a round: each lane counts its block's
//    matches in the LUT row and a ballot orders the hits, so tiles go out in
//    query order as they are found (no list in memory, no bound on M), and
//    the first round of the next item is scanned before this item's K / V are
//    released. When block_n is an odd multiple of 64 the halves of an item lie
//    in different key blocks, so the slot carries a weight per warpgroup; a
//    weight of 0 gives P = 0 by a select (P of keys that a query block never
//    saw may overflow) and adds exactly nothing. An end slot (no tile) closes
//    each item, so an item that no query block names writes dk = dv = 0. lse
//    and delta rows come by cp.async from the producer's lanes (a TMA box at
//    bh * Lq floats is not 16-byte aligned). A warpgroup takes two turns a
//    tile, S^T / dP^T then dV / dK: P and dS in flight beside the next S^T and
//    dP^T do not fit in registers (flash_bwd_sm90.cu's header);
//  - dK/dV load balance: the number of query tiles an item walks follows how
//    many query blocks chose its key block, which is skewed (a max 2-3.5x
//    the mean on the Wan LUTs), so items are taken from an atomic ticket counter
//    rather than in a fixed stride. The counter only chooses which SM runs an
//    item; an item's sums run in one block in LUT order, so the bits do not
//    depend on it. Each launch takes one of kSchedSlots counters (round robin
//    on the host), and the last block to finish resets it: launches on
//    different streams do not share a counter unless kSchedSlots of them run
//    at once.
// A separate source rather than a LUT-walk parameter of flash_bwd_sm90.cu:
// the walk changes every producer, the dK/dV item schedule and each tile's
// masking and weighting, so the two would share little beyond the order of
// the wgmma calls, and the flash kernels keep their code and their bits.
// Both head dims the wrappers take (64 and 128) run these kernels.
//
// Semantics, as the TPU kernels and the plain twin (_torch_sla_bwd):
//  - s = (q . k) * scale * log2(e) in f32, keys >= kv_len masked (a
//    zero-filled key is not a masked key); p = exp2(s - lse) with the
//    forward's base-2 lse; dp = do . v in f32; ds = p * (dp - delta) * scale,
//    delta = sum(o * do) from the caller;
//  - the LUT [BH, M, topk] names key blocks of block_n rows for each query
//    block of block_m rows (multiples of 64); negative ids name nothing. dQ
//    walks the LUT entry by entry (a duplicated id counts twice); for dK/dV
//    query block m contributes to key block n as many times as n occurs in m's
//    row: p^T is multiplied by that count before the bf16 rounding;
//  - ds rounded to bf16 before ds . k and ds^T . q, p before p^T . do; sums in
//    f32; dq, dk, dv written as bf16; query rows past Lq add nothing; rows
//    past Lq / Lk are not written.
#include <stdint.h>

#include <atomic>
#include <type_traits>

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
using namespace id_sm90;

constexpr int kOwn = 128;        // rows a block owns: query rows (dQ), key rows (dK/dV)
constexpr int kWalk = 64;        // rows of a walked tile: keys (dQ), queries (dK/dV)
constexpr int kBox = 64;         // bf16 per 128-byte swizzled row of a TMA box
constexpr int kStages = 3;       // ring depth of the walked tiles
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;    // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kOwnBox = kOwn * kBox * 2;     // one [128 rows, 64] box: 16 KB
constexpr int kWalkBox = kWalk * kBox * 2;   // one [64 rows, 64] box: 8 KB
constexpr int kRowBytes = kWalk * 4;         // lse or delta of a walked query tile
constexpr int kSchedSlots = 64;              // dK/dV ticket counters, one per launch in flight

// {next ticket, blocks done} of each counter; zero at load, reset by the last
// block of the launch that used it
__device__ unsigned int g_sched[kSchedSlots][2];

struct Params {
  const int* lut;       // [BH, m_blocks, topk]
  const float* lse;     // [BH, Lq], base 2
  const float* delta;   // [BH, Lq]
  bf16* dq;             // [BH, Lq, D]
  bf16* dk;             // [BH, Lk, D]
  bf16* dv;             // [BH, Lk, D]
  int Lq, Lk, kv_len, m_blocks, topk, block_m, block_n;
  int tiles, n_items;   // owned 128-row tiles per head, and in all
  int sched;            // dK/dV: this launch's counter
  float scale_log2, scale;
};

template <int D>
struct Tiles {
  static constexpr int kOwnTile = (D / kBox) * kOwnBox;     // Q, dO (dQ); K, V (dK/dV)
  static constexpr int kWalkTile = (D / kBox) * kWalkBox;   // K, V (dQ); Q, dO (dK/dV)
};

// dQ: Q, dO resident; K / V ring; the stages' slots; q full / empty, then
// full_k, full_v, empty_k, empty_v per stage.
template <int D>
struct DqSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kOffDo = T::kOwnTile;
  static constexpr int kOffK = 2 * T::kOwnTile;
  static constexpr int kOffV = kOffK + kStages * T::kWalkTile;
  static constexpr int kOffSlot = kOffV + kStages * T::kWalkTile;
  static constexpr int kOffBar = kOffSlot + kStages * 16;
  static constexpr int kBars = 2 + 4 * kStages;
  // + 1024: the kernel aligns its base itself (the swizzle pattern of TMA and
  // of the wgmma descriptors is a function of address bits 4..9)
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
};

// dK/dV: K, V resident; Q / dO / lse / delta ring; the stages' slots and the
// item's; kv full / empty, then full and empty per stage.
template <int D>
struct DkdvSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kOffV = T::kOwnTile;
  static constexpr int kOffQ = 2 * T::kOwnTile;
  static constexpr int kOffDo = kOffQ + kStages * T::kWalkTile;
  static constexpr int kOffLse = kOffDo + kStages * T::kWalkTile;
  static constexpr int kOffDelta = kOffLse + kStages * kRowBytes;
  static constexpr int kOffSlot = kOffDelta + kStages * kRowBytes;   // stages, then the item
  static constexpr int kOffBar = kOffSlot + (kStages + 1) * 16;
  static constexpr int kBars = 2 + 2 * kStages;
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
};

// ---------------------------------------------------------------------------
// dQ. grid (min(SMs, work items)), 384 threads; a work item is 128 query rows
// of one (batch, head), and a block takes items blockIdx.x, + gridDim.x, ...
// (the query tile runs fastest). Warpgroup wg owns rows 64 wg .. 64 wg + 63
// of the item; this thread's rows are 16 warp + g and + 8 of those.
// Accumulator layout of wgmma m64nN (PTX ISA), lane = 4 g + t4 of warp w of
// the warpgroup: register 4 j + e holds row 16 w + g + 8 (e / 2), column
// 8 j + 2 t4 + e % 2.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sla_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Params p) {
  using S = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  int4* slots = reinterpret_cast<int4*>(sbase + S::kOffSlot);   // {key0, lim wg 0, lim wg 1, last}
  const uint32_t bars = base + S::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerWarps * 32) {
    // ---- producer warp: lane 0 starts every TMA load and writes the slots;
    // the lanes share the LUT reads. It runs ahead of the consumers across
    // work items. ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != kConsumerWarps) return;
    const int lane = threadIdx.x % 32;
    int t = 0;   // tiles loaded so far: ring stage and phase
    auto load_tile = [&](int bh, int key0, int lim0, int lim1, int last) {
      const int s = t % kStages, parity = (t / kStages) & 1;
      mbar_wait(empty_k(s), parity ^ 1);   // passes at once on the first round
      if (lane == 0) {
        slots[s] = make_int4(key0, lim0, lim1, last);   // published by full_k's arrival
        mbar_expect_tx(full_k(s), S::kWalkTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h)
          tma_load_3d(base + S::kOffK + s * S::kWalkTile + h * kWalkBox, &map_k, full_k(s),
                      h * kBox, key0, bh);
      }
      mbar_wait(empty_v(s), parity ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full_v(s), S::kWalkTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h)
          tma_load_3d(base + S::kOffV + s * S::kWalkTile + h * kWalkBox, &map_v, full_v(s),
                      h * kBox, key0, bh);
      }
      ++t;
    };

    for (int item = blockIdx.x, n = 0; item < p.n_items; item += gridDim.x, ++n) {
      const int bh = item / p.tiles, row0 = (item % p.tiles) * kOwn;
      mbar_wait(q_empty, (n & 1) ^ 1);   // passes at once on the first item
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * S::kOwnTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h) {
          tma_load_3d(base + h * kOwnBox, &map_q, q_full, h * kBox, row0, bh);
          tma_load_3d(base + S::kOffDo + h * kOwnBox, &map_do, q_full, h * kBox, row0, bh);
        }
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
            for (long long key0 = first; key0 < end; key0 += kWalk) {
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
    const uint32_t q_addr = base + wg * (64 * 128);   // this warpgroup's 64 rows of each box
    const uint32_t do_addr = q_addr + S::kOffDo;

    float s[32], dp[32];
    float acc[D / 2];
    uint32_t ds[4][4];
    float lse_r[2], delta_r[2];
    int t = 0;   // tiles consumed before this work item

    // S = Q K^T and dP = dO V^T of ring tile u (64 rows x 64 keys each), one
    // wgmma group left in flight; returns the tile's slot
    auto start_sdp = [&](int u) -> int4 {
      const int st = u % kStages;
      const uint32_t k_addr = base + S::kOffK + st * S::kWalkTile;
      const uint32_t v_addr = base + S::kOffV + st * S::kWalkTile;
      mbar_wait(full_k(st), (u / kStages) & 1);
      const int4 info = slots[st];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(s, kmajor(q_addr, ks, kOwnBox), kmajor(k_addr, ks, kWalkBox), ks > 0);
      mbar_wait(full_v(st), (u / kStages) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dp, kmajor(do_addr, ks, kOwnBox), kmajor(v_addr, ks, kWalkBox), ks > 0);
      wgmma_commit();
      return info;
    };
    // dQ += dS K of ring tile u, K read MN-major (16 keys a k-step); one group
    auto start_dq = [&](int u) {
      const uint32_t k_addr = base + S::kOffK + (u % kStages) * S::kWalkTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ds[kk], mnmajor(k_addr, kk, kWalkBox));
      wgmma_commit();
    };
    // dS = P (dP - delta) scale in the registers of S, P = exp2(S * scale_log2
    // - lse); keys at or past this warpgroup's limit get P = 0 by a select
    auto grad_tile = [&](const int4& info) {
      const int key0 = info.x, lim = wg ? info.z : info.y;
      const bool edge = key0 + kWalk > lim;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float pv = ex2(fmaf(s[i], p.scale_log2, -lse_r[r]));
        if (edge && key0 + 8 * (i / 4) + 2 * t4 + (i % 2) >= lim) pv = 0.f;
        s[i] = pv * (dp[i] - delta_r[r]) * p.scale;
      }
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Pingpong: named barrier 1 + wg lets this warpgroup start its products;
    // the other warpgroup opens it once it has started its own. Both walk the
    // same tiles, so they take the same number of turns. Warpgroup 0 goes
    // first.
    if (wg == 1) named_arrive(1);

    for (int item = blockIdx.x, n = 0; item < p.n_items; item += gridDim.x, ++n) {
      const int bh = item / p.tiles, row0 = (item % p.tiles) * kOwn;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        const bool ok = row < p.Lq;
        lse_r[r] = ok ? p.lse[(long long)bh * p.Lq + row] : 0.f;
        delta_r[r] = ok ? p.delta[(long long)bh * p.Lq + row] : 0.f;
      }

      // Software pipeline, as flash_bwd_sm90.cu: while the tensor cores run
      // dQ += dS_t K_t after S / dP of tile t + 1, the warpgroup takes dS of
      // tile t + 1 as soon as its S and dP are complete. The walk ends at the
      // tile whose slot says last; its dQ product is peeled off.
      mbar_wait(q_full, n & 1);
      wgmma_fence();
      int4 cur = start_sdp(t);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v(t % kStages));
      grad_tile(cur);
      pack_a(ds, s);
      while (!cur.w) {
        named_sync(1 + wg);
        wgmma_fence();
        const int4 nxt = start_sdp(t + 1);
        start_dq(t);
        named_arrive(2 - wg);
        wgmma_wait<1>();   // S and dP of tile t + 1
        fence_regs(s);
        fence_regs(dp);
        release(empty_v((t + 1) % kStages));
        grad_tile(nxt);
        wgmma_wait<0>();   // dQ of tile t
        fence_regs(acc);
        release(empty_k(t % kStages));
        pack_a(ds, s);
        ++t;
        cur = nxt;
      }
      release(q_empty);    // every S and dP of this item is complete
      wgmma_fence();
      start_dq(t);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_k(t % kStages));
      ++t;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row >= p.Lq) continue;
        bf16* out = p.dq + ((long long)bh * p.Lq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t4) =
              pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV. grid (min(SMs, work items)), 384 threads; a work item is 128 keys
// of one (batch, head), K and V resident, taken by ticket (the key tile runs
// fastest). The walked tiles are the 64-query tiles of Q, dO and their lse
// and delta rows whose query block names the item's key block(s). Warpgroup
// wg owns keys 64 wg .. 64 wg + 63; this thread's keys are 16 warp + g and
// + 8 of those, its query columns 8 j + 2 t4 (+ 1) of each tile. The products
// run transposed (keys are the rows): S^T = K Q^T, dV += P^T dO,
// dP^T = V dO^T, dK += dS^T Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sla_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const Params p) {
  using S = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  int4* slots = reinterpret_cast<int4*>(sbase + S::kOffSlot);   // {query row0, weight wg 0, wg 1, end}
  int4* item_slot = slots + kStages;                             // {bh (-1: no more), key0}
  const uint32_t bars = base + S::kOffBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + kStages + s); };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);   // lane 0's arrival (with the TMA bytes) and the lanes' copies
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerWarps * 32) {
    // ---- producer warp: lane 0 takes the tickets, starts every TMA load and
    // writes the slots; the lanes scan the LUT and copy each tile's lse and
    // delta rows. ---------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != kConsumerWarps) return;
    const int lane = threadIdx.x % 32;
    unsigned int* sched = g_sched[p.sched];
    int t = 0;   // ring slots filled so far: stage and phase
    // one ring slot: a query tile with its two weights, or the item's end
    auto load_tile = [&](int bh, int row0, int w0, int w1, int end) {
      const int s = t % kStages, parity = (t / kStages) & 1;
      mbar_wait(empty(s), parity ^ 1);   // passes at once on the first round
      if (lane == 0) {
        slots[s] = make_int4(row0, w0, w1, end);   // published by full's completion
        if (end) {
          mbar_arrive(full(s));
        } else {
          mbar_expect_tx(full(s), 2 * S::kWalkTile);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h) {
            tma_load_3d(base + S::kOffQ + s * S::kWalkTile + h * kWalkBox, &map_q, full(s),
                        h * kBox, row0, bh);
            tma_load_3d(base + S::kOffDo + s * S::kWalkTile + h * kWalkBox, &map_do, full(s),
                        h * kBox, row0, bh);
          }
        }
      }
      if (!end) {
        // rows past Lq are zero-filled: with their zero Q and dO rows they
        // give dp = 0 and ds = 0, and p^T dO adds p x 0
        float* lse_s = reinterpret_cast<float*>(sbase + S::kOffLse + s * kRowBytes);
        float* delta_s = reinterpret_cast<float*>(sbase + S::kOffDelta + s * kRowBytes);
        const long long off = (long long)bh * p.Lq;
#pragma unroll
        for (int i = lane; i < kWalk; i += 32) {
          const bool ok = row0 + i < p.Lq;
          id_attn::cp_async4(lse_s + i, p.lse + (ok ? off + row0 + i : 0), ok);
          id_attn::cp_async4(delta_s + i, p.delta + (ok ? off + row0 + i : 0), ok);
        }
      }
      cp_async_mbar_arrive(full(s));
      ++t;
    };
    // this lane's query block m0 + lane: how often its LUT row names key
    // blocks nb0 and nb1 (nb1 < 0: the item's upper half is past Lk)
    auto count = [&](int bh, int m0, int nb0, int nb1, int& c0, int& c1) {
      c0 = c1 = 0;
      const int m = m0 + lane;
      if (m >= p.m_blocks) return;
      const int* row = p.lut + ((long long)bh * p.m_blocks + m) * p.topk;
#pragma unroll 4
      for (int j = 0; j < p.topk; ++j) {
        const int id = row[j];
        c0 += id == nb0;
        c1 += id == nb1;
      }
      if (nb1 < 0) c1 = 0;
    };

    int ticket = lane == 0 ? (int)atomicAdd(&sched[0], 1u) : 0;
    ticket = __shfl_sync(0xffffffffu, ticket, 0);
    for (int n = 0;; ++n) {
      const int item = ticket;
      const bool more = item < p.n_items;
      const int bh = more ? item / p.tiles : 0, key0 = more ? (item % p.tiles) * kOwn : 0;
      const int nb0 = key0 / p.block_n;
      const int nb1 = key0 + 64 < p.Lk ? (key0 + 64) / p.block_n : -1;
      int c0 = 0, c1 = 0;
      if (more) count(bh, 0, nb0, nb1, c0, c1);   // before this item's K / V can be loaded
      mbar_wait(kv_empty, (n & 1) ^ 1);           // passes at once on the first item
      if (lane == 0) {
        item_slot[0] = make_int4(more ? bh : -1, key0, 0, 0);   // published by kv_full
        if (more) {
          mbar_expect_tx(kv_full, 2 * S::kOwnTile);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h) {
            tma_load_3d(base + h * kOwnBox, &map_k, kv_full, h * kBox, key0, bh);
            tma_load_3d(base + S::kOffV + h * kOwnBox, &map_v, kv_full, h * kBox, key0, bh);
          }
        } else {
          mbar_arrive(kv_full);
        }
      }
      if (!more) break;
      for (int m0 = 0;;) {
        // the hits of this round in query order: a query block's 64-row
        // tiles below Lq, each with its two weights
        unsigned hits = __ballot_sync(0xffffffffu, c0 + c1 > 0);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int w0 = __shfl_sync(0xffffffffu, c0, src);
          const int w1 = __shfl_sync(0xffffffffu, c1, src);
          const long long first = (long long)(m0 + src) * p.block_m;
          const int end = first + p.block_m < p.Lq ? (int)(first + p.block_m) : p.Lq;
          for (int row0 = (int)first; row0 < end; row0 += kWalk) load_tile(bh, row0, w0, w1, 0);
        }
        m0 += 32;
        if (m0 >= p.m_blocks) break;
        count(bh, m0, nb0, nb1, c0, c1);
      }
      load_tile(bh, 0, 0, 0, 1);   // the item's end
      ticket = lane == 0 ? (int)atomicAdd(&sched[0], 1u) : 0;
      ticket = __shfl_sync(0xffffffffu, ticket, 0);
    }
    // This block takes no more tickets; the last block to get here resets
    // the counter for a later launch.
    if (lane == 0 && atomicAdd(&sched[1], 1u) == gridDim.x - 1) {
      atomicExch(&sched[0], 0u);
      atomicExch(&sched[1], 0u);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");   // 2 x 128 x 232 + 128 x 40
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t k_addr = base + wg * (64 * 128);   // this warpgroup's 64 keys of each box
    const uint32_t v_addr = k_addr + S::kOffV;

    float st[32], dpt[32];
    float dk_acc[D / 2], dv_acc[D / 2];
    uint32_t pa[4][4], ds[4][4];
    bool key_ok[2] = {false, false};   // set per item
    int t = 0;   // ring slots consumed so far

    // S^T = K Q^T and dP^T = V dO^T of ring tile u (64 keys x 64 queries
    // each), one wgmma group, left in flight
    auto start_sdp = [&](int u) {
      const int stg = u % kStages;
      const uint32_t q_addr = base + S::kOffQ + stg * S::kWalkTile;
      const uint32_t do_addr = base + S::kOffDo + stg * S::kWalkTile;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(st, kmajor(k_addr, ks, kOwnBox), kmajor(q_addr, ks, kWalkBox), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dpt, kmajor(v_addr, ks, kOwnBox), kmajor(do_addr, ks, kWalkBox), ks > 0);
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of ring tile u, dO and Q read MN-major
    // (16 queries a k-step); one group
    auto start_dkdv = [&](int u) {
      const int stg = u % kStages;
      const uint32_t q_addr = base + S::kOffQ + stg * S::kWalkTile;
      const uint32_t do_addr = base + S::kOffDo + stg * S::kWalkTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc, pa[kk], mnmajor(do_addr, kk, kWalkBox));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc, ds[kk], mnmajor(q_addr, kk, kWalkBox));
      wgmma_commit();
    };
    // P^T = exp2(S^T * scale_log2 - lse) * weight in the registers of S^T (0 at
    // keys >= kv_len and where the weight is 0), dS^T = P^T (dP^T - delta)
    // scale in the registers of dP^T
    auto grad_tile = [&](int u, int weight) {
      const int stg = u % kStages;
      const float* lse_s = reinterpret_cast<const float*>(sbase + S::kOffLse + stg * kRowBytes);
      const float* delta_s =
          reinterpret_cast<const float*>(sbase + S::kOffDelta + stg * kRowBytes);
      const float w = (float)weight;
      const bool live[2] = {key_ok[0] && weight > 0, key_ok[1] && weight > 0};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
        const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float pv = live[e / 2] ? ex2(fmaf(st[i], p.scale_log2, -(e % 2 ? l.y : l.x))) * w
                                       : 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - (e % 2 ? d.y : d.x)) * p.scale;
        }
      }
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Two turns a tile: the tensor cores see S^T / dP^T of warpgroup 0, of
    // warpgroup 1, dV / dK of 0, of 1, ...; each warpgroup's exp2 and dS run
    // under the other's products. Both read the same slots, so they take the
    // same number of turns.
    if (wg == 1) named_arrive(1);
    for (int n = 0;; ++n) {
      mbar_wait(kv_full, n & 1);
      const int4 item = item_slot[0];
      if (item.x < 0) break;
      const int bh = item.x, key0 = item.y;
#pragma unroll
      for (int r = 0; r < 2; ++r) key_ok[r] = key0 + wg * 64 + warp * 16 + g + 8 * r < p.kv_len;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

      for (;; ++t) {
        const int stg = t % kStages;
        mbar_wait(full(stg), (t / kStages) & 1);
        const int4 info = slots[stg];
        if (info.w) break;
        named_sync(1 + wg);
        wgmma_fence();
        start_sdp(t);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        grad_tile(t, wg ? info.z : info.y);
        pack_a(pa, st);
        pack_a(ds, dpt);
        named_sync(1 + wg);
        wgmma_fence();
        start_dkdv(t);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        release(empty(stg));
      }
      release(empty(t % kStages));   // the end slot
      ++t;
      release(kv_empty);             // K and V are read no more

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + wg * 64 + warp * 16 + g + 8 * r;
        if (key >= p.Lk) continue;
        const long long row = (long long)bh * p.Lk + key;
        bf16* outk = p.dk + row * D;
        bf16* outv = p.dv + row * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(outk + 8 * j + 2 * t4) =
              pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(outv + 8 * j + 2 * t4) =
              pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int D, bool DKDV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, Params p,
                   int BH, cudaStream_t stream) {
  using Smem = typename std::conditional<DKDV, DkdvSmem<D>, DqSmem<D>>::type;
  const int own = DKDV ? p.Lk : p.Lq;
  CUtensorMap mq, mdo, mk, mv;
  if (!make_heads_map(&mq, q, BH, p.Lq, D, DKDV ? kWalk : kOwn) ||
      !make_heads_map(&mdo, dout, BH, p.Lq, D, DKDV ? kWalk : kOwn) ||
      !make_heads_map(&mk, k, BH, p.Lk, D, DKDV ? kOwn : kWalk) ||
      !make_heads_map(&mv, v, BH, p.Lk, D, DKDV ? kOwn : kWalk))
    return cudaErrorInvalidValue;
  auto kernel = DKDV ? sla_bwd_dkdv_kernel<D> : sla_bwd_dq_kernel<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kBytes);
  if (e != cudaSuccess) return e;
  p.tiles = (own + kOwn - 1) / kOwn;
  const long long n_items = (long long)p.tiles * BH;
  const int sms = sm_count();
  if (sms <= 0 || n_items > 2147483647LL) return cudaErrorInvalidValue;
  p.n_items = (int)n_items;
  if (DKDV) {
    static std::atomic<unsigned> launches{0};
    p.sched = (int)(launches.fetch_add(1) % kSchedSlots);
  }
  const int grid = n_items < sms ? (int)n_items : sms;
  kernel<<<grid, kThreads, Smem::kBytes, stream>>>(mq, mdo, mk, mv, p);
  return cudaGetLastError();
}

template <bool DKDV>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const Params& p,
             int BH, int D, void* stream) {
  if (BH <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.kv_len < 0 || p.kv_len > p.Lk)
    return (int)cudaErrorInvalidValue;
  if (p.block_m <= 0 || p.block_m % kWalk || p.block_n <= 0 || p.block_n % kWalk ||
      p.topk <= 0 || p.m_blocks != (p.Lq + p.block_m - 1) / p.block_m ||
      (long long)p.topk * (p.block_n / kWalk) > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, DKDV>(q, k, v, dout, p, BH, s);
  if (D == 128) return (int)launch<128, DKDV>(q, k, v, dout, p, BH, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* lse, const void* delta, const void* lut, void* dq, void* dk,
                   void* dv, int Lq, int Lk, int kv_len, int topk, int block_m, int block_n,
                   float scale_log2, float scale) {
  return Params{static_cast<const int*>(lut), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), Lq, Lk, kv_len,
                block_m > 0 ? (Lq + block_m - 1) / block_m : 0, topk, block_m, block_n, 0, 0, 0,
                scale_log2, scale};
}

}  // namespace

// SLA backward, dQ: q/k/v/dout bf16 [BH, L, D], lse (base 2) / delta f32
// [BH, Lq], lut int32 [BH, ceil(Lq / block_m), topk], all contiguous -> dq
// bf16 [BH, Lq, D]. D in {64, 128}. The tensor maps hold the data pointers,
// so they are encoded per call (on the host, no allocation).
extern "C" int id_sla_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* lut, void* dq,
                             int BH, int Lq, int Lk, int D, int kv_len, int topk, int block_m,
                             int block_n, float scale_log2, float scale, void* stream) {
  return dispatch<false>(q, k, v, dout,
                         make_params(lse, delta, lut, dq, nullptr, nullptr, Lq, Lk, kv_len, topk,
                                     block_m, block_n, scale_log2, scale),
                         BH, D, stream);
}

// SLA backward, dK and dV: as id_sla_bwd_dq -> dk, dv bf16 [BH, Lk, D].
extern "C" int id_sla_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* lut, void* dk,
                               void* dv, int BH, int Lq, int Lk, int D, int kv_len, int topk,
                               int block_m, int block_n, float scale_log2, float scale,
                               void* stream) {
  return dispatch<true>(q, k, v, dout,
                        make_params(lse, delta, lut, nullptr, dk, dv, Lq, Lk, kv_len, topk,
                                    block_m, block_n, scale_log2, scale),
                        BH, D, stream);
}
