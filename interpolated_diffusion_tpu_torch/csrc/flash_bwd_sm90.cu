// Dense flash attention backward for Hopper (sm_90a): dQ and dK/dV as two
// kernels of wgmma products on tiles that arrive by TMA, one producer warp and
// two consumer warpgroups taking turns at the tensor cores.
//
// Replaces the TPU kernels of
// interpolated_diffusion_tpu/kernels/block_sparse_attention.py:
//   flash_bwd_dq_kernel     _dq_kernel_dense    (_bwd_pallas_dense, dQ call)
//   flash_bwd_dkdv_kernel   _dkdv_kernel_dense  (_bwd_pallas_dense, dK/dV call)
// The TPU kernels walk a sequential grid axis (key blocks for dQ, query blocks
// for dK/dV) and carry their f32 sums in VMEM scratch. Here a block owns 128
// query rows (dQ) or 128 key rows (dK/dV) of one (batch, head), walks the
// tiles of the other side in a loop and keeps its sums in registers, so that
// every output row is written by exactly one block: no atomics, the same bits
// every run, as the TPU's two separate calls.
//
// What bounds them on the H100: at the Wan2.1-1.3B training shapes (BH = 24,
// Lq = 7800, Dh = 128) dQ does three products (S = Q K^T, dP = dO V^T,
// dQ = dS K) and dK/dV four (S^T, dP^T, dV = P^T dO, dK = dS^T Q) over ~0.2 GB
// of q / k / v / do / outputs: far above the bf16 ridge, so the tensor-core
// rate bounds both. Their first version (mma.sync, 4 warps of 16 rows, a
// cp.async ring) read every walked tile from shared memory once per 16 rows,
// about 16 FLOP a shared byte, and ran at 18-25% of the rate. The design here
// is the flash forward's (flash_fwd_sm90.cu):
//  - the resident tiles (128 rows) and the walked tiles (64 rows) are copied
//    by TMA from 3-D tensor maps [BH, L, Dh] (a box never crosses a head; rows
//    past L arrive as zeros) into 128-byte-swizzled shared memory, in boxes 64
//    elements wide; one thread of a producer warp keeps kStages walked tiles in
//    flight through a ring guarded by mbarriers;
//  - each consumer warpgroup owns 64 of the block's rows. Every product is
//    either SS with both operands K-major (S, dP and their transposes) or RS
//    with P / dS packed to bf16 in the registers of their f32 accumulators,
//    whose layout is the A fragment of the next wgmma, and B read MN-major
//    from the same swizzled tile (K for dQ, dO and Q for dK/dV): no transpose
//    in shared memory. S, P, dP and dS never leave registers;
//  - setmaxnreg moves the producer warpgroup's registers to the consumers;
//  - the two warpgroups take turns at issuing (pingpong through named
//    barriers 1, 2), so one's exp2 and bf16 packing run under the other's
//    products. dQ's loop is also software-pipelined inside a warpgroup (S and
//    dP of the next tile run with this tile's dQ product, and dS of the next
//    tile is computed under the latter). dK/dV's is not: its accumulators
//    (dK 64 + dV 64 + S^T 32 + dP^T 32 floats a thread at Dh = 128) leave no
//    room for P and dS of one tile in flight beside S^T and dP^T of the next
//    (ptxas spilled and serialised every wgmma, note C7512), so a warpgroup
//    takes two turns a tile, one for S^T / dP^T and one for dV / dK;
//  - dQ's grid is persistent: one block an SM walks the (head, query block)
//    items, and the producer loads the next item's Q and dO while the
//    consumers finish and store this one. dK/dV has one block per 128 keys of
//    a head (at 517 keys x 24 heads, 120 blocks: one wave on 132 SMs).
// Both head dims the wrappers take (64 and 128) run these kernels.
//
// Semantics, as the TPU kernels and the plain twin (_torch_flash_bwd):
//  - s = (q . k) * scale * log2(e) in f32, keys >= Lk masked (a zero-filled
//    key is not a masked key); p = exp2(s - lse) with the forward's base-2 lse;
//  - dp = do . v in f32; ds = p * (dp - delta) * scale, delta = sum(o * do)
//    from the caller; ds rounded to bf16 before ds . k and ds^T . q, p before
//    p^T . do; sums in f32; dq, dk, dv written as bf16;
//  - query rows past Lq add nothing, rows past Lq / Lk are not written;
//  - per-row key lengths (the forward's kv_lens, int32 [BH], clamped to
//    1 .. Lk): keys at or past kv_lens[bh] get p = 0, so their dK and dV rows
//    are zero. dQ walks only the key tiles below the length; a dK/dV block
//    whose keys all lie past it writes its zero rows and walks nothing.
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

template <int D>
struct Tiles {
  static constexpr int kOwnTile = (D / kBox) * kOwnBox;     // Q, dO (dQ); K, V (dK/dV)
  static constexpr int kWalkTile = (D / kBox) * kWalkBox;   // K, V (dQ); Q, dO (dK/dV)
};

// dQ: Q, dO resident; K / V ring; q full / empty, then full_k, full_v,
// empty_k, empty_v per stage.
template <int D>
struct DqSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kOffDo = T::kOwnTile;
  static constexpr int kOffK = 2 * T::kOwnTile;
  static constexpr int kOffV = kOffK + kStages * T::kWalkTile;
  static constexpr int kOffBar = kOffV + kStages * T::kWalkTile;
  static constexpr int kBars = 2 + 4 * kStages;
  // + 1024: the kernel aligns its base itself (the swizzle pattern of TMA and
  // of the wgmma descriptors is a function of address bits 4..9)
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
};

// dK/dV: K, V resident; Q / dO / lse / delta ring; kv full, then full and
// empty per stage. lse and delta come by cp.async from the producer warp's
// lanes (a TMA box must start 16-byte aligned, and a head's rows of lse start
// at bh * Lq floats), each lane's copies counted on the stage's full barrier.
template <int D>
struct DkdvSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int kOffV = T::kOwnTile;
  static constexpr int kOffQ = 2 * T::kOwnTile;
  static constexpr int kOffDo = kOffQ + kStages * T::kWalkTile;
  static constexpr int kOffLse = kOffDo + kStages * T::kWalkTile;
  static constexpr int kOffDelta = kOffLse + kStages * kRowBytes;
  static constexpr int kOffBar = kOffDelta + kStages * kRowBytes;
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
};

// ---------------------------------------------------------------------------
// dQ. grid (min(SMs, work items)), 384 threads; a work item is 128 query rows
// of one (batch, head), and a block takes items blockIdx.x, + gridDim.x, ...
// (the query tile runs fastest, so the blocks at work share a few heads' K / V
// in L2). Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the item; this
// thread's rows are 16 warp + g and + 8 of those.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ kv_lens, int Lq, int Lk, int q_tiles, int n_items,
                    float scale_log2, float scale) {
  using S = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  auto row_keys = [&](int bh) { return kv_lens ? min(max(kv_lens[bh], 1), Lk) : Lk; };

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
    // ---- producer: one thread starts every TMA load, running ahead of the
    // consumers across work items ----------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumerWarps * 32) {
      int kv = 0;   // K / V tiles requested so far: ring stage and phase
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / q_tiles, row0 = (item % q_tiles) * kOwn;
        const int n_tiles = (row_keys(bh) + kWalk - 1) / kWalk;
        mbar_wait(q_empty, (n & 1) ^ 1);   // passes at once on the first item
        mbar_expect_tx(q_full, 2 * S::kOwnTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h) {
          tma_load_3d(base + h * kOwnBox, &map_q, q_full, h * kBox, row0, bh);
          tma_load_3d(base + S::kOffDo + h * kOwnBox, &map_do, q_full, h * kBox, row0, bh);
        }
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int s = kv % kStages, parity = (kv / kStages) & 1;
          mbar_wait(empty_k(s), parity ^ 1);   // passes at once on the first round
          mbar_expect_tx(full_k(s), S::kWalkTile);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h)
            tma_load_3d(base + S::kOffK + s * S::kWalkTile + h * kWalkBox, &map_k, full_k(s),
                        h * kBox, it * kWalk, bh);
          mbar_wait(empty_v(s), parity ^ 1);
          mbar_expect_tx(full_v(s), S::kWalkTile);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h)
            tma_load_3d(base + S::kOffV + s * S::kWalkTile + h * kWalkBox, &map_v, full_v(s),
                        h * kBox, it * kWalk, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_addr = base + wg * (64 * 128);   // this warpgroup's 64 rows of each box
    const uint32_t do_addr = q_addr + S::kOffDo;

    float s[32], dp[32];
    float acc[D / 2];
    uint32_t ds[4][4];
    float lse_r[2], delta_r[2];
    int kv = 0;   // K / V tiles consumed before this work item

    // S = Q K^T and dP = dO V^T of ring tile t (64 rows x 64 keys each), one
    // wgmma group, left in flight
    auto start_sdp = [&](int t) {
      const int st = t % kStages;
      const uint32_t k_addr = base + S::kOffK + st * S::kWalkTile;
      const uint32_t v_addr = base + S::kOffV + st * S::kWalkTile;
      mbar_wait(full_k(st), (t / kStages) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(s, kmajor(q_addr, ks, kOwnBox), kmajor(k_addr, ks, kWalkBox), ks > 0);
      mbar_wait(full_v(st), (t / kStages) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dp, kmajor(do_addr, ks, kOwnBox), kmajor(v_addr, ks, kWalkBox), ks > 0);
      wgmma_commit();
    };
    // dQ += dS K of ring tile t, K read MN-major (16 keys a k-step); one group
    auto start_dq = [&](int t) {
      const uint32_t k_addr = base + S::kOffK + (t % kStages) * S::kWalkTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ds[kk], mnmajor(k_addr, kk, kWalkBox));
      wgmma_commit();
    };
    // dS = P (dP - delta) scale in the registers of S, P = exp2(S * scale_log2
    // - lse); keys at or past the row's lk get P = 0 (only the last tile has any)
    auto grad_tile = [&](int key0, int lk) {
      const bool edge = key0 + kWalk > lk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float p = ex2(fmaf(s[i], scale_log2, -lse_r[r]));
        if (edge && key0 + 8 * (i / 4) + 2 * t4 + (i % 2) >= lk) p = 0.f;
        s[i] = p * (dp[i] - delta_r[r]) * scale;
      }
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Pingpong: named barrier 1 + wg lets this warpgroup start its products;
    // the other warpgroup opens it once it has started its own. Warpgroup 0
    // goes first.
    if (wg == 1) named_arrive(1);

    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / q_tiles, row0 = (item % q_tiles) * kOwn;
      const int lk = row_keys(bh), n_tiles = (lk + kWalk - 1) / kWalk;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        const bool ok = row < Lq;
        lse_r[r] = ok ? lse[(long long)bh * Lq + row] : 0.f;
        delta_r[r] = ok ? delta[(long long)bh * Lq + row] : 0.f;
      }

      // Software pipeline: while the tensor cores run dQ += dS_it K_it after
      // S / dP of tile it + 1, the warpgroup takes dS of tile it + 1 as soon
      // as its S and dP are complete. The last dQ product is peeled off so
      // that every iteration starts the same groups (a wgmma under a
      // condition makes ptxas serialise the chain).
      mbar_wait(q_full, n & 1);
      wgmma_fence();
      start_sdp(kv);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v(kv % kStages));
      grad_tile(0, lk);
      pack_a(ds, s);
      for (int it = 0; it + 1 < n_tiles; ++it) {
        named_sync(1 + wg);
        wgmma_fence();
        start_sdp(kv + it + 1);
        start_dq(kv + it);
        named_arrive(2 - wg);
        wgmma_wait<1>();   // S and dP of tile it + 1
        fence_regs(s);
        fence_regs(dp);
        release(empty_v((kv + it + 1) % kStages));
        grad_tile((it + 1) * kWalk, lk);
        wgmma_wait<0>();   // dQ of tile it
        fence_regs(acc);
        release(empty_k((kv + it) % kStages));
        pack_a(ds, s);
      }
      release(q_empty);    // every S and dP of this item is complete
      wgmma_fence();
      start_dq(kv + n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_k((kv + n_tiles - 1) % kStages));

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row >= Lq) continue;
        bf16* out = dq + ((long long)bh * Lq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t4) =
              pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
      kv += n_tiles;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV. grid (ceil(Lk / 128), BH), 384 threads; a block owns 128 keys of one
// (batch, head), K and V resident, and walks every 64-query tile of Q, dO and
// their lse and delta rows. Warpgroup wg owns keys 64 wg .. 64 wg + 63; this
// thread's keys are 16 warp + g and + 8 of those, its query columns
// 8 j + 2 t4 (+ 1) of each tile. The products run transposed (keys are the
// rows): S^T = K Q^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, const int* __restrict__ kv_lens, int Lq, int Lk,
                      float scale_log2, float scale) {
  using S = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + S::kOffBar;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  const int bh = blockIdx.y, key0 = blockIdx.x * kOwn;
  const int n_tiles = (Lq + kWalk - 1) / kWalk;
  const int lk = kv_lens ? min(max(kv_lens[bh], 1), Lk) : Lk;
  if (key0 >= lk) {
    // every key of this block lies past the row's length: zero rows, no walk
    const int rows = min(kOwn, Lk - key0);
    for (int i = threadIdx.x; i < rows * (D / 8); i += kThreads) {
      const long long at = ((long long)bh * Lk + key0 + i / (D / 8)) * D + (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);   // the TMA's expect_tx and the lanes' copies
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerWarps * 32) {
    // ---- producer: lane 0 of the first warp starts the TMA loads, all its
    // lanes copy the tile's lse and delta rows (40 registers: the copies' row
    // pointers) ---------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == kConsumerWarps) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * S::kOwnTile);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h) {
          tma_load_3d(base + h * kOwnBox, &map_k, kv_full, h * kBox, key0, bh);
          tma_load_3d(base + S::kOffV + h * kOwnBox, &map_v, kv_full, h * kBox, key0, bh);
        }
      }
      const float* lse_h = lse + (long long)bh * Lq;
      const float* delta_h = delta + (long long)bh * Lq;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, parity = (it / kStages) & 1;
        mbar_wait(empty(s), parity ^ 1);   // passes at once on the first round
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * S::kWalkTile);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h) {
            tma_load_3d(base + S::kOffQ + s * S::kWalkTile + h * kWalkBox, &map_q, full(s),
                        h * kBox, it * kWalk, bh);
            tma_load_3d(base + S::kOffDo + s * S::kWalkTile + h * kWalkBox, &map_do, full(s),
                        h * kBox, it * kWalk, bh);
          }
        }
        // rows past Lq are zero-filled: with their zero Q and dO rows they
        // give p = 1, dp = 0 and ds = 0, and add nothing
        float* lse_s = reinterpret_cast<float*>(sbase + S::kOffLse + s * kRowBytes);
        float* delta_s = reinterpret_cast<float*>(sbase + S::kOffDelta + s * kRowBytes);
#pragma unroll
        for (int i = lane; i < kWalk; i += 32) {
          const int row = it * kWalk + i;
          const bool ok = row < Lq;
          id_attn::cp_async4(lse_s + i, ok ? lse_h + row : lse_h, ok);
          id_attn::cp_async4(delta_s + i, ok ? delta_h + row : delta_h, ok);
        }
        cp_async_mbar_arrive(full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");   // 2 x 128 x 232 + 128 x 40
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t k_addr = base + wg * (64 * 128);   // this warpgroup's 64 keys of each box
    const uint32_t v_addr = k_addr + S::kOffV;

    float st[32], dpt[32];
    float dk_acc[D / 2], dv_acc[D / 2];
    uint32_t p[4][4], ds[4][4];
    bool key_ok[2], key_in[2];   // attended (below lk); a row of the output (below Lk)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + wg * 64 + warp * 16 + g + 8 * r;
      key_ok[r] = key < lk;
      key_in[r] = key < Lk;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // S^T = K Q^T and dP^T = V dO^T of ring tile t (64 keys x 64 queries
    // each), one wgmma group, left in flight
    auto start_sdp = [&](int t) {
      const int stg = t % kStages;
      const uint32_t q_addr = base + S::kOffQ + stg * S::kWalkTile;
      const uint32_t do_addr = base + S::kOffDo + stg * S::kWalkTile;
      mbar_wait(full(stg), (t / kStages) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(st, kmajor(k_addr, ks, kOwnBox), kmajor(q_addr, ks, kWalkBox), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dpt, kmajor(v_addr, ks, kOwnBox), kmajor(do_addr, ks, kWalkBox), ks > 0);
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of ring tile t, dO and Q read MN-major
    // (16 queries a k-step); one group
    auto start_dkdv = [&](int t) {
      const int stg = t % kStages;
      const uint32_t q_addr = base + S::kOffQ + stg * S::kWalkTile;
      const uint32_t do_addr = base + S::kOffDo + stg * S::kWalkTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc, p[kk], mnmajor(do_addr, kk, kWalkBox));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc, ds[kk], mnmajor(q_addr, kk, kWalkBox));
      wgmma_commit();
    };
    // P^T = exp2(S^T * scale_log2 - lse) in the registers of S^T (0 at keys
    // >= lk), dS^T = P^T (dP^T - delta) scale in the registers of dP^T
    auto grad_tile = [&](int t) {
      const int stg = t % kStages;
      const float* lse_s = reinterpret_cast<const float*>(sbase + S::kOffLse + stg * kRowBytes);
      const float* delta_s =
          reinterpret_cast<const float*>(sbase + S::kOffDelta + stg * kRowBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
        const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pv = ex2(fmaf(st[i], scale_log2, -(e % 2 ? l.y : l.x)));
          if (!key_ok[e / 2]) pv = 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - (e % 2 ? d.y : d.x)) * scale;
        }
      }
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Two turns a tile: the tensor cores see S^T / dP^T of warpgroup 0, of
    // warpgroup 1, dV / dK of 0, of 1, ..., and each warpgroup's exp2 and dS
    // run under the other's products. dV / dK of tile it is complete before S^T
    // of tile it + 1 starts, so P and dS are never in flight beside S^T and
    // dP^T (see the header).
    if (wg == 1) named_arrive(1);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      named_sync(1 + wg);
      wgmma_fence();
      start_sdp(it);
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grad_tile(it);
      pack_a(p, st);
      pack_a(ds, dpt);
      named_sync(1 + wg);
      wgmma_fence();
      start_dkdv(it);
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      release(empty(it % kStages));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_in[r]) continue;   // keys in lk .. Lk - 1 write their zero sums
      const long long row = (long long)bh * Lk + key0 + wg * 64 + warp * 16 + g + 8 * r;
      bf16* outk = dk + row * D;
      bf16* outv = dv + row * D;
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

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, bf16* dq, const int* kv_lens, int BH,
                      int Lq, int Lk, float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!make_heads_map(&mq, q, BH, Lq, D, kOwn) || !make_heads_map(&mdo, dout, BH, Lq, D, kOwn) ||
      !make_heads_map(&mk, k, BH, Lk, D, kWalk) || !make_heads_map(&mv, v, BH, Lk, D, kWalk))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::kBytes);
  if (e != cudaSuccess) return e;
  const int q_tiles = (Lq + kOwn - 1) / kOwn;
  const long long n_items = (long long)q_tiles * BH;
  const int sms = sm_count();
  if (sms <= 0 || n_items > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = n_items < sms ? (int)n_items : sms;
  flash_bwd_dq_kernel<D><<<grid, kThreads, DqSmem<D>::kBytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, dq, kv_lens, Lq, Lk, q_tiles, (int)n_items, scale_log2,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, bf16* dk, bf16* dv,
                        const int* kv_lens, int BH, int Lq, int Lk, float scale_log2, float scale,
                        cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!make_heads_map(&mq, q, BH, Lq, D, kWalk) || !make_heads_map(&mdo, dout, BH, Lq, D, kWalk) ||
      !make_heads_map(&mk, k, BH, Lk, D, kOwn) || !make_heads_map(&mv, v, BH, Lk, D, kOwn))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DkdvSmem<D>::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Lk + kOwn - 1) / kOwn, BH);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, DkdvSmem<D>::kBytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, dk, dv, kv_lens, Lq, Lk, scale_log2, scale);
  return cudaGetLastError();
}

bool bad_shapes(int BH, int Lq, int Lk, int D) {
  return BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0 || (D != 64 && D != 128);
}

}  // namespace

// Flash backward, dQ: q/dout bf16 [BH, Lq, D], k/v bf16 [BH, Lk, D], lse
// (base 2) / delta f32 [BH, Lq], all contiguous -> dq bf16 [BH, Lq, D].
// D in {64, 128}. kv_lens: null, or the forward's int32 [BH] keys per row.
// The tensor maps hold the data pointers, so they are encoded per call (on
// the host, no allocation) and passed by value.
extern "C" int id_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, const void* kv_lens,
                               int BH, int Lq, int Lk, int D, float scale_log2, float scale,
                               void* stream) {
  if (bad_shapes(BH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  bf16* out = static_cast<bf16*>(dq);
  const int* lens = static_cast<const int*>(kv_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, l, d, out, lens, BH, Lq, Lk, scale_log2, scale, s);
  return (int)launch_dq<128>(q, k, v, dout, l, d, out, lens, BH, Lq, Lk, scale_log2, scale, s);
}

// Flash backward, dK and dV: as id_flash_bwd_dq -> dk, dv bf16 [BH, Lk, D].
extern "C" int id_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const void* kv_lens, int BH, int Lq, int Lk, int D,
                                 float scale_log2, float scale, void* stream) {
  if (bad_shapes(BH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  bf16* ok = static_cast<bf16*>(dk);
  bf16* ov = static_cast<bf16*>(dv);
  const int* lens = static_cast<const int*>(kv_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dkdv<64>(q, k, v, dout, l, d, ok, ov, lens, BH, Lq, Lk, scale_log2, scale,
                                s);
  return (int)launch_dkdv<128>(q, k, v, dout, l, d, ok, ov, lens, BH, Lq, Lk, scale_log2, scale,
                               s);
}
