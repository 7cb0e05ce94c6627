// Dense flash attention forward for Hopper (sm_90a): wgmma products on K / V
// tiles that arrive by TMA, one producer warp and two consumer warpgroups, a
// persistent grid.
//
// Replaces the TPU kernel
// interpolated_diffusion_tpu/kernels/block_sparse_attention.py::_fwd_kernel_dense
// (_fwd_pallas_dense; public flash_attention). The TPU kernel walks a
// sequential grid axis over key blocks and carries the running max / sum /
// accumulator in VMEM scratch; here one block owns 128 query rows of one
// (batch, head) and walks the keys in a loop.
//
// What bounds it on the H100: at the WanDiT shapes (BH = 48, Lq = 7800,
// Dh = 128) self-attention is 1.5 TFLOP of products against 0.3 GB of
// q / k / v / o traffic, far above the card's bf16 ridge, so the tensor-core
// rate bounds it. A first version on warp-level mma.sync (4 warps x 16 rows)
// was held at a sixth of that rate by shared-memory traffic: every warp read
// the whole K and V tile for its own 16 rows, about 16 FLOP a shared byte.
// The design here is the usual shape of a fast Hopper kernel:
//  - Q (128 rows) and the K / V tiles (128 keys x Dh) are copied by TMA from a
//    3-D tensor map [BH, L, Dh] (a box never crosses a head; rows past L
//    arrive as zeros) into 128-byte-swizzled shared memory, in boxes 64
//    elements wide. One thread of a producer warp keeps kStages tiles in
//    flight through a ring guarded by mbarriers (full / empty, K and V apart,
//    so Q K^T starts while V is still on its way);
//  - each of the two consumer warpgroups owns 64 query rows. S = Q K^T is one
//    chain of wgmma m64n128k16 with A and B read from shared memory through
//    descriptors; S, the running max and sum and the O accumulator stay in
//    registers; P is packed to bf16 in the registers of S, whose accumulator
//    layout is the A fragment layout of the next wgmma, and O += P V reads V
//    from the same tile through an MN-major descriptor (keys are the
//    contraction index, no transpose in shared memory). A shared tile feeds
//    64 rows per read instead of 16;
//  - setmaxnreg moves the producer warpgroup's registers to the consumers
//    (S 64 + O 64 + P 32 live floats a thread at Dh = 128);
//  - the loop is software-pipelined inside a warpgroup (S of the next tile is
//    started before P V of this one, and the softmax runs under both), and
//    the two warpgroups take turns at the tensor cores (pingpong through two
//    named barriers), so one's softmax runs under the other's products;
//  - the grid is persistent: one block an SM walks the (head, query block)
//    work items, and the producer loads the next item's Q, K and V while the
//    consumers finish and store this one.
// At [48, 7800, 128] x 7800 keys it runs at about two thirds of the bf16 peak
// (PERF.md); what is left is named there.
// Both head dims the wrapper takes (64 and 128) run this kernel.
//
// Semantics, as the TPU kernel and the plain twin (_torch_flash): logits are
// scaled by scale * log2(e) and exponentiated with exp2; f32 running max and
// sum, the sum from f32 P; P rounded to bf16 for P.V with f32 accumulation;
// o = acc * (1 / l) rounded to bf16; lse = m + log2(l) (f32, base 2). Rectangular
// Lq x Lk; keys at positions >= Lk get probability 0 (their logits are set to
// -inf before the max: a zero-filled key is not a masked key); rows >= Lq are
// not written. P is rounded per 128-key tile.
//
// Per-row key lengths: with kv_lens (int32 [BH], clamped to 1 .. Lk) the keys
// of (batch, head) row bh end at kv_lens[bh] instead of Lk, as a padding mask
// over a joint text-video sequence needs. An item walks only the key tiles
// below its length (the tiles past it are never loaded) and masks the keys
// at or past it in its last tile, so the result is that of attention over the
// first kv_lens[bh] keys. A null kv_lens is the scalar Lk.
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
using id_attn::quad_max;
using id_attn::quad_sum;
using namespace id_sm90;

constexpr int kBM = 128;          // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;          // keys per tile
constexpr int kBox = 64;          // bf16 per 128-byte swizzled row of a TMA box
constexpr int kStages = 2;        // K / V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kBoxBytes = kBM * kBox * 2;   // one [128 rows, 64] box: 16 KB

template <int D>
struct Smem {
  static constexpr int kTileBytes = (D / kBox) * kBoxBytes;   // Q, or one K or V tile
  static constexpr int kOffK = kTileBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  // q full / empty, then full_k, full_v, empty_k, empty_v per stage
  static constexpr int kBars = 2 + 4 * kStages;
  // + 1024: the kernel aligns its base itself (the swizzle pattern of TMA and
  // of the wgmma descriptors is a function of address bits 4..9)
  static constexpr int kBytes = kOffBar + kBars * 8 + 1024;
};

// mbarriers, named barriers, TMA loads, descriptors and the wgmma forms come
// from sm90_common.cuh; what only this kernel uses follows.

// One 64 x 128 tile of raw logits (this thread's 2 rows x 32 columns) ->
// P = exp2(s * scale_log2 - new running max) in place; updates the running
// max and sum and returns alpha = exp2(old max - new max) for both rows. Keys
// at or past Lk are masked (only the last tile has any; key 0 is always
// visible, so no row's max stays -inf).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], float scale_log2, int key0,
                                             int Lk, int t4) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
  if (key0 + kBN > Lk) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int key = key0 + 8 * j + 2 * t4;
      if (key >= Lk) s[4 * j] = s[4 * j + 2] = -INFINITY;
      if (key + 1 >= Lk) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    const float m_new = fmaxf(m_run[r], quad_max(mx));
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(s[i] - m_run[(i % 4) / 2]);
    rowsum[(i % 4) / 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
}

// grid (min(SMs, work items)), 384 threads; a work item is 128 query rows of
// one (batch, head), and a block takes items blockIdx.x, + gridDim.x, ... (the
// query tile runs fastest, so the blocks at work share a few heads' K / V in
// L2). Accumulator layout of wgmma m64nN (PTX ISA), lane = 4 * g + t of warp w
// of the warpgroup: register 4 * j + e holds row 16 * w + g + 8 * (e / 2),
// column 8 * j + 2 * t + e % 2; the A fragment of m64k16 holds rows g, g + 8
// and columns 2t, 2t + 1 (+ 8) in the same order, so two neighbouring column
// blocks of S pack into one k-step of P.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lens, int Lq, int Lk,
                 int q_tiles, int n_items, float scale_log2) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kOffBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  // the keys of row bh, and the key tiles an item of that row walks
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
    // ---- producer warpgroup: one thread starts every TMA load. It runs ahead
    // of the consumers across work items: the next item's Q and first K / V
    // tiles load while the consumers finish and store this one. ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumerWarps * 32) {
      int kv = 0;   // K / V tiles requested so far: ring stage and phase
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / q_tiles, row0 = (item % q_tiles) * kBM;
        const int n_tiles = (row_keys(bh) + kBN - 1) / kBN;
        mbar_wait(q_empty, (n & 1) ^ 1);   // passes at once on the first item
        mbar_expect_tx(q_full, S::kTileBytes);
#pragma unroll
        for (int h = 0; h < D / kBox; ++h)
          tma_load_3d(base + h * kBoxBytes, &map_q, q_full, h * kBox, row0, bh);
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int s = kv % kStages, parity = (kv / kStages) & 1;
          mbar_wait(empty_k(s), parity ^ 1);   // passes at once on the first round
          mbar_expect_tx(full_k(s), S::kTileBytes);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h)
            tma_load_3d(base + S::kOffK + s * S::kTileBytes + h * kBoxBytes, &map_k, full_k(s),
                        h * kBox, it * kBN, bh);
          mbar_wait(empty_v(s), parity ^ 1);
          mbar_expect_tx(full_v(s), S::kTileBytes);
#pragma unroll
          for (int h = 0; h < D / kBox; ++h)
            tma_load_3d(base + S::kOffV + s * S::kTileBytes + h * kBoxBytes, &map_v, full_v(s),
                        h * kBox, it * kBN, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_addr = base + wg * (64 * 128);   // this warpgroup's 64 rows of each box

    float s[64];
    float acc[D / 2];
    float m_run[2], l_run[2], alpha[2];
    uint32_t p[8][4];
    int kv = 0;   // K / V tiles consumed before this work item

    // S = Q K^T for ring tile t: 64 rows x 128 keys, D / 16 k-steps of 32
    // bytes inside a box; one wgmma group, left in flight
    auto start_s = [&](int t) {
      const int st = t % kStages;
      const uint32_t k_addr = base + S::kOffK + st * S::kTileBytes;
      mbar_wait(full_k(st), (t / kStages) & 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss(s, smem_desc(q_addr + off, 16, 1024), smem_desc(k_addr + off, 16, 1024),
                      ks > 0);
      }
      wgmma_commit();
    };
    // O += P V for ring tile t, 16 keys a k-step; one group, left in flight
    auto start_pv = [&](int t) {
      const int st = t % kStages;
      const uint32_t v_addr = base + S::kOffV + st * S::kTileBytes;
      mbar_wait(full_v(st), (t / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(acc, p[kk], smem_desc(v_addr + kk * (16 * 128), kBoxBytes, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Pingpong: named barrier 1 + wg lets this warpgroup start its products;
    // it is opened by the other warpgroup once that one has started its own,
    // so one warpgroup's softmax runs under the other's products instead of
    // both asking for the tensor cores at once. Warpgroup 0 goes first.
    if (wg == 1) named_arrive(1);

    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / q_tiles, row0 = (item % q_tiles) * kBM;
      const int lk = row_keys(bh), n_tiles = (lk + kBN - 1) / kBN;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;

      // The loop is software-pipelined inside the warpgroup: while the tensor
      // cores run O += P_it V_it and S = Q K_{it+1}^T, the warpgroup takes the
      // softmax of tile it + 1 as soon as its S is complete. O is rescaled by
      // that tile's alpha after P_it V_it has landed, before the next P V. The
      // last P V is peeled off so that every iteration starts the same groups
      // (a wgmma under a condition makes ptxas serialise the chain).
      mbar_wait(q_full, n & 1);
      wgmma_fence();
      start_s(kv);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(kv % kStages));
      softmax_tile(s, m_run, l_run, alpha, scale_log2, 0, lk, t4);   // acc is 0: alpha unused
      pack_a(p, s);   // P (bf16) from the registers of S, 16 keys a k-step
      for (int it = 0; it + 1 < n_tiles; ++it) {
        named_sync(1 + wg);
        wgmma_fence();
        start_s(kv + it + 1);
        start_pv(kv + it);
        named_arrive(2 - wg);
        wgmma_wait<1>();   // S of tile it + 1
        fence_regs(s);
        release(empty_k((kv + it + 1) % kStages));
        softmax_tile(s, m_run, l_run, alpha, scale_log2, (it + 1) * kBN, lk, t4);
        wgmma_wait<0>();   // P V of tile it
        fence_regs(acc);
        release(empty_v((kv + it) % kStages));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
        pack_a(p, s);
      }
      release(q_empty);    // every S of this item is complete: Q may be overwritten
      wgmma_fence();
      start_pv(kv + n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v((kv + n_tiles - 1) % kStages));

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = fmaxf(quad_sum(l_run[r]), 1e-30f);
        const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row >= Lq) continue;
        const float inv = 1.f / l;
        bf16* orow = o + ((long long)bh * Lq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (t4 == 0) lse[(long long)bh * Lq + row] = m_run[r] + log2f(l);
      }
      kv += n_tiles;
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, bf16* o,
                   float* lse, const int* kv_lens, int BH, int Lq, int Lk, float scale_log2,
                   cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (e != cudaSuccess) return e;
  const int q_tiles = (Lq + kBM - 1) / kBM;
  const long long n_items = (long long)q_tiles * BH;
  const int sms = sm_count();
  if (sms <= 0 || n_items > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = n_items < sms ? (int)n_items : sms;
  flash_fwd_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, o, lse, kv_lens, Lq, Lk, q_tiles, (int)n_items, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Dense flash attention forward: q bf16 [BH, Lq, D], k/v bf16 [BH, Lk, D],
// all contiguous -> o bf16 [BH, Lq, D], lse f32 [BH, Lq] (base 2). D in
// {64, 128}. kv_lens: null, or int32 [BH] keys per row (see the header). The
// tensor maps hold the data pointers, so they are encoded per call (on the
// host, no allocation) and passed by value.
extern "C" int id_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* kv_lens, int BH, int Lq, int Lk, int D,
                            float scale_log2, void* stream) {
  if (BH <= 0 || Lq <= 0 || Lk <= 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_heads_map(&mq, q, BH, Lq, D, kBM) || !make_heads_map(&mk, k, BH, Lk, D, kBN) ||
      !make_heads_map(&mv, v, BH, Lk, D, kBN))
    return (int)cudaErrorInvalidValue;
  bf16* ob = static_cast<bf16*>(o);
  float* lb = static_cast<float*>(lse);
  const int* lens = static_cast<const int*>(kv_lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(mq, mk, mv, ob, lb, lens, BH, Lq, Lk, scale_log2, s);
  return (int)launch<128>(mq, mk, mv, ob, lb, lens, BH, Lq, Lk, scale_log2, s);
}
