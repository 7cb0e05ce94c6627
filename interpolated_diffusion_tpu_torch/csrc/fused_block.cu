// FiLM pre-norm transformer block for Hopper (sm_90a).
//
// Replaces interpolated_diffusion_tpu/kernels/fused_block.py::_kernel
// (launched by _fwd_pallas, public fused_film_block). The TPU kernel runs the
// whole block in one pallas_call with ~3.5 MB of bf16 weights resident in
// VMEM. A Hopper SM has 227 KB of shared memory, so here the block is a short
// chain of this file's kernels on one stream:
//
//   ln_film(x)            -> h    bf16   LN1 (f32 stats) + FiLM1
//   gemm<BIAS>(h, Wqkv)   -> qkv  bf16
//   small_mha(qkv)        -> o    bf16   (small_mha.cu)
//   gemm<RESID_F32>(o)    -> x2   f32    x + o @ Wout^T + b
//   ln_film(x2)           -> h    bf16   LN2 + FiLM2
//   gemm<SILU>(h, Wff1)   -> f    bf16
//   gemm<RESID_OUT>(f)    -> y    bf16   x2 + f @ Wff2^T + b
//
// What bounds it on the H100: at the bench shapes (B*L = 8192 or 65536 rows,
// D = 384, F = 1536) the four products carry ~3.5 MFLOP per row against
// ~20 KB of intermediate traffic per row (both counted from the shapes;
// ~175 FLOP/byte, under the card's bf16 ridge of ~295). Each product by itself
// sits at the ridge or under it (the output projection reads 1.5 KB and
// writes 1.5 KB a row for 0.3 MFLOP), so a GEMM here has to run the tensor
// cores at the wgmma rate AND stream its operands and its epilogue traffic
// without stalling either; with h / qkv / o / x2 / f written to and read back
// from device memory the chain as a whole is bound by those bytes, not by its
// operations (PERF.md has the split). Keeping h and f on chip is later work.
//
// The GEMM, out = epilogue(A[M, K] @ W[N, K]^T + bias), is wgmma on tiles that
// arrive by TMA (a first version on WMMA 16x16x16 with a cp.async ring and an
// epilogue through shared memory ran at ~200 TFLOP/s, a third of a library
// call):
//  - W [N, K] row-major is K-major, the B operand of wgmma as it lies (no
//    transpose); A and W tiles are copied by one producer thread from 2-D
//    tensor maps into 128-byte-swizzled shared memory behind full / empty
//    mbarriers, rows of A at or past M arriving as zeros; two consumer
//    warpgroups run wgmma m64nBNk16 with both operands read from shared
//    memory through descriptors, a k-tile (64) being one group of four;
//  - BN = 192 where it divides N: a shared-memory byte then feeds more FLOP
//    than at 128, and the widths of the path tile evenly on 132 SMs at both
//    row counts (N = 384 at M = 8192 is 128 x 2 tiles of 64 rows, two a block;
//    128 x 128 tiles would be 192, a wave and a half). Widths that 192 does
//    not divide run the BN = 128 or BN = 64 instantiation of the same kernels
//    (N and K are multiples of 64 by the wrapper's contract), so every shape
//    the wrapper accepts runs on wgmma; there is no other GEMM in this file;
//  - where the block's whole W tile [BN, K] fits shared memory beside a ring of
//    A boxes (K <= 384 at BN = 192: three of the block's four products) the
//    W-resident kernel runs: a block keeps one column tile, loads its W once
//    and streams only A. Its tiles are 64 rows, one per warpgroup, and the two
//    warpgroups take turns at the tensor cores (pingpong through two named
//    barriers): at K = 384 a tile's products are only 24 wgmma, so an epilogue
//    (bias, SiLU, residual traffic, stores) that both warpgroups ran at once
//    left the tensor cores idle for most of a tile's life; now one's epilogue
//    runs under the other's products. A persistent grid of a multiple of N / BN
//    blocks walks the row tiles. Why two kernels and not the streaming one
//    alone: a build with -DID_GEMM_STREAM_ONLY (chip_smoke.py --gemm-ab) runs
//    the K = 384 products at 65536 rows 1.19x (qkv), 1.15x (out) and 1.29x
//    (ff1) as long and the block at [1024, 64, 384] 1.14x (NVIDIA H100 80GB
//    HBM3, 700 W limit);
//  - otherwise (K = 1536, the FFN's second product) the streaming kernel runs:
//    128 x BN tiles, both warpgroups 64 rows of one tile, A and W boxes of a
//    k-tile through one ring that runs on across tiles, so the next tile's
//    operands load under this tile's epilogue; a persistent grid, the column
//    tile running fastest. The L2-to-SM path (~25 bytes a clock and SM here)
//    holds it: 983 KB a tile;
//  - the epilogue works on the accumulator registers, with no round trip
//    through shared memory (gemm_epilogue below).
//
// Rounding points are those of the TPU kernel: h, qkv, p, o and the SiLU
// output are bf16; the residual stream x2 stays f32 inside the block; y is
// rounded to bf16 at the end. LayerNorm uses eps 1e-6 and E[x^2] - mu^2.
// x, the FiLM rows gb1/gb2 [B, 2D] and the four weight matrices (torch Linear
// layout [out, in]) are bf16. The four biases and the four LN vectors are
// either all f32 (a model with f32 master parameters under bf16 compute, as
// the trainers build it: the TPU kernel's types) or all bf16 (a model held in
// bf16 throughout; read into f32, which is exact): `params_f32` says which.
#include <stdint.h>

#include "attention_common.cuh"
#include "id_kernels.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace id_sm90;
using id_attn::pack_bf16;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Element i of a bias or LN vector that is f32 or bf16 (uniform per launch).
__device__ __forceinline__ float param_at(const void* p, int i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// One warp per row: f32 mean and E[x^2], then (x - mu) * rsqrt(var + eps) *
// scale + bias, then FiLM h * (1 + gamma) + beta with the row's sample b = row / L.
template <typename T>
__global__ void __launch_bounds__(256)
ln_film_kernel(const T* __restrict__ x, const bf16* __restrict__ gb,
               const void* __restrict__ scale, const void* __restrict__ bias, int pf32,
               bf16* __restrict__ h, int M, int L, int D, int use_film, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = id_warp_sum(s);
  ss = id_warp_sum(ss);
  const float mu = s / D;
  const float var = ss / D - mu * mu;
  const float r = rsqrtf(var + eps);
  const bf16* g = gb + (long long)(row / L) * 2 * D;
  bf16* hr = h + (long long)row * D;
  for (int c = lane; c < D; c += 32) {
    float v = (to_f32(xr[c]) - mu) * r;
    v = v * param_at(scale, c, pf32) + param_at(bias, c, pf32);
    if (use_film) v = v * (1.f + to_f32(g[c])) + to_f32(g[D + c]);
    hr[c] = __float2bfloat16(v);
  }
}

enum Epilogue {
  EPI_BIAS = 0,       // out bf16 = acc + b
  EPI_BIAS_SILU = 1,  // out bf16 = silu(acc + b)
  EPI_RESID_F32 = 2,  // out f32  = resid(bf16) + (acc + b)
  EPI_RESID_OUT = 3,  // out bf16 = resid(f32) + (acc + b)
};

constexpr int kGemmBK = 64;            // a k-tile: one 128-byte swizzled row of bf16
constexpr int kGemmThreads = 384;      // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kGemmConsumerWarps = 8;
constexpr int kGemmMaxSmem = 227 * 1024;
constexpr int kABoxBytes = 64 * kGemmBK * 2;   // 64 rows of A, one k-tile: 8 KB

// Shared memory of the GEMM, two layouts; every box is a multiple of 1024
// bytes, the swizzle period, and the mbarriers follow the tiles.
// W-resident: the block's whole W tile [BN, K] first (K / 64 boxes, loaded
// once), then a ring of eight A boxes of 64 rows.
template <int BN>
struct ResidentSmem {
  static constexpr int kWBytes = BN * kGemmBK * 2;
  static constexpr int kStages = 8;
  // + 1024: the kernel aligns its base itself (the swizzle pattern of TMA and
  // of the wgmma descriptors is a function of address bits 4..9)
  static constexpr int bytes(int k_tiles) {
    return k_tiles * kWBytes + kStages * kABoxBytes + (2 * kStages + 1) * 8 + 1024;
  }
};
// Streaming: a ring of stages, each the A box [128, 64] and the W box
// [BN, 64] of one k-tile, as deep as ~200 KB allow.
template <int BN>
struct StreamSmem {
  static constexpr int kABytes = 2 * kABoxBytes;
  static constexpr int kStageBytes = kABytes + BN * kGemmBK * 2;
  static constexpr int kStages = 200 * 1024 / kStageBytes < 8 ? 200 * 1024 / kStageBytes : 8;
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// Elements col, col + 1 (col even) of a bias vector that is f32 or bf16.
__device__ __forceinline__ float2 param_pair(const void* p, int col, int f32) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + col);
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + col));
}

// 4 x 4 transpose of 32-bit words across a quad (lanes 4g .. 4g + 3, t4 the
// lane's place in it): on entry thread t holds v[j] = its word of column
// block j; on exit v[s] is thread s's word of block t. Two butterfly steps:
// inside 2 x 2 blocks, then the off-diagonal blocks.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t4) {
  const bool odd = t4 & 1, hi = t4 & 2;
  uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  if (odd) v[0] = got; else v[1] = got;
  got = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) v[2] = got; else v[3] = got;
  got = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  if (hi) v[0] = got; else v[2] = got;
  got = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) v[1] = got; else v[3] = got;
}

// The four k-steps (32 bytes inside the swizzled row) of one k-tile: A rows at
// a_addr, W rows at w_addr, one wgmma group left in flight. `first` overwrites
// the accumulator.
template <int N>
__device__ __forceinline__ void mma_k_tile(float (&acc)[N], uint32_t a_addr, uint32_t w_addr,
                                           bool first) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kGemmBK / 16; ++ks)
    wgmma_ss(acc, smem_desc(a_addr + ks * 32, 16, 1024), smem_desc(w_addr + ks * 32, 16, 1024),
             first ? ks > 0 : 1);
  wgmma_commit();
}

// This thread's bias values of the column tile at n0: b[j] holds columns
// n0 + 8 * j + 2 * t4 and the next. Loaded ahead of the products (once a block
// where the column tile is fixed), so that no epilogue waits for them.
template <int BN>
__device__ __forceinline__ void load_bias(float2 (&b)[BN / 8], const void* __restrict__ bias,
                                          int pf32, int n0, int t4) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) b[j] = param_pair(bias, n0 + 8 * j + 2 * t4, pf32);
}

// Epilogue of one thread's share of a 64 x BN accumulator, from its
// registers: rows row0 and row0 + 8, columns n0 + 8 * j + 2 * t4 (+ 1). Bias
// in f32, SiLU in f32, the residual read and added in the accumulator's own
// layout (a quad reads 32 contiguous bytes of an f32 row), then for bf16
// outputs a 4 x 4 transpose of packed words across the quad, so that every
// thread stores 16 contiguous bytes; f32 outputs go out as float2 (a quad
// writes a sector). The residual of the next group of four column blocks is
// requested before this group is stored (the compiler may not move a load
// above a store that could alias it, and one load at a time left the epilogue
// bound by latency). Rows at or past M are not read or written. Accumulator
// layout of wgmma m64nN (PTX ISA), lane = 4 * g + t of warp w of the
// warpgroup: register 4 * j + e holds row 16 * w + g + 8 * (e / 2), column
// 8 * j + 2 * t + e % 2.
template <int BN, int EPI>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[BN / 2],
                                              const float2 (&b)[BN / 8], int row0, int n0, int t4,
                                              const void* __restrict__ resid,
                                              void* __restrict__ out, int M, int N) {
  constexpr bool kResid = EPI == EPI_RESID_F32 || EPI == EPI_RESID_OUT;
  float2 res[2][4][2];   // [buffer][column block of the group][row]
  auto load_resid = [&](float2 (&dst)[4][2], int j0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long off = (long long)row * N + n0 + 8 * (j0 + jj) + 2 * t4;
        dst[jj][r] = make_float2(0.f, 0.f);
        if (row >= M) continue;
        if (EPI == EPI_RESID_F32)
          dst[jj][r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const bf16*>(resid) + off));
        else
          dst[jj][r] = *reinterpret_cast<const float2*>(static_cast<const float*>(resid) + off);
      }
  };
  if (kResid) load_resid(res[0], 0);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 4) {
    if (kResid && j0 + 4 < BN / 8) load_resid(res[(j0 / 4 + 1) & 1], j0 + 4);
    uint32_t packed[2][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        float v0 = acc[4 * j + 2 * r] + b[j].x, v1 = acc[4 * j + 2 * r + 1] + b[j].y;
        if (EPI == EPI_BIAS_SILU) {
          // v * sigmoid(v) on the special-function unit (ex2 and rcp, ~2 ulp
          // in f32, far inside the bf16 rounding that follows)
          v0 = __fdividef(v0, 1.f + __expf(-v0));
          v1 = __fdividef(v1, 1.f + __expf(-v1));
        }
        if (kResid) {
          v0 = res[(j0 / 4) & 1][jj][r].x + v0;
          v1 = res[(j0 / 4) & 1][jj][r].y + v1;
        }
        if (EPI == EPI_RESID_F32) {
          if (row < M)
            *reinterpret_cast<float2*>(static_cast<float*>(out) + (long long)row * N + n0 +
                                       8 * j + 2 * t4) = make_float2(v0, v1);
        } else {
          packed[r][jj] = pack_bf16(v0, v1);
        }
      }
    }
    if (EPI != EPI_RESID_F32) {
      // thread t of the quad now takes all 8 columns of block j0 + t
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        quad_transpose(packed[r], t4);
        const int row = row0 + 8 * r;
        if (row < M)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + (long long)row * N + n0 +
                                    8 * (j0 + t4)) =
              make_uint4(packed[r][0], packed[r][1], packed[r][2], packed[r][3]);
      }
    }
  }
}

// out[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias[N]), the W-resident kernel:
// A, W bf16 row-major behind the two tensor maps (A in [64, 64] boxes), f32
// accumulation, N = n_tiles * BN, K = k_tiles * 64. A tile is 64 rows x BN
// columns; tile `item` has rows (item / n_tiles) * 64 and column tile
// item % n_tiles. grid: a multiple of n_tiles, so that the tiles of a block
// (blockIdx.x, + gridDim.x, ...) all have its column tile, whose W it loads
// once. The block's i-th tile goes to consumer warpgroup i % 2; the A boxes of
// all its tiles pass through one ring in that order.
template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_resident_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const void* __restrict__ bias,
                     int pf32, const void* __restrict__ resid, void* __restrict__ out, int M,
                     int N, int k_tiles, int n_tiles, int n_items) {
  using S = ResidentSmem<BN>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t w_base = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t ring = w_base + k_tiles * S::kWBytes;
  const uint32_t bars = ring + S::kStages * kABoxBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S::kStages + s); };
  const uint32_t w_full = bars + 8 * 2 * S::kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGemmConsumerWarps / 2);   // a box is read by one warpgroup
    }
    mbar_init(w_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kGemmConsumerWarps * 32) {
    // ---- producer warpgroup: one thread starts every TMA load: W once, then
    // the A boxes of the block's tiles, up to the ring's depth ahead ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kGemmConsumerWarps * 32) {
      mbar_expect_tx(w_full, k_tiles * S::kWBytes);
      for (int kt = 0; kt < k_tiles; ++kt)
        tma_load_2d(w_base + kt * S::kWBytes, &map_w, w_full, kt * kGemmBK,
                    (blockIdx.x % n_tiles) * BN);
      int c = 0;   // boxes requested so far: ring stage and phase
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int m0 = (item / n_tiles) * 64;
        for (int kt = 0; kt < k_tiles; ++kt, ++c) {
          const int s = c % S::kStages;
          mbar_wait(empty(s), ((c / S::kStages) & 1) ^ 1);   // passes at once on the first round
          mbar_expect_tx(full(s), kABoxBytes);
          tma_load_2d(ring + s * kABoxBytes, &map_a, full(s), kt * kGemmBK, m0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: a 64 x BN tile each, taking turns -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    float acc[BN / 2];
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty(s));
    };
    // Pingpong: named barrier 1 + wg lets this warpgroup start a tile's
    // products; the other warpgroup opens it once it has started its own, so
    // one's epilogue (bias, SiLU, residual traffic, stores) runs under the
    // other's products instead of both leaving the tensor cores idle at once.
    // Warpgroup 0 goes first; it never has fewer tiles than warpgroup 1, so no
    // wait is left without its arrival.
    if (wg == 1) named_arrive(1);
    float2 b[BN / 8];   // the block's column tile is fixed: its bias is loaded once
    load_bias<BN>(b, bias, pf32, (blockIdx.x % n_tiles) * BN, t4);
    mbar_wait(w_full, 0);

    int i = wg;   // index of the tile among the block's
    for (int item = blockIdx.x + wg * gridDim.x; item < n_items; item += 2 * gridDim.x, i += 2) {
      const int m0 = (item / n_tiles) * 64, n0 = (item % n_tiles) * BN;
      int c = i * k_tiles;   // ring position of the tile's first box
      named_sync(1 + wg);
      // The first k-tile is peeled: it overwrites the accumulator and has no
      // box before it to hand back, so the loop body is the same every time (a
      // wgmma under a condition makes ptxas serialise the chain).
      mbar_wait(full(c % S::kStages), (c / S::kStages) & 1);
      mma_k_tile(acc, ring + (c % S::kStages) * kABoxBytes, w_base, true);
      for (int kt = 1; kt < k_tiles; ++kt) {
        const int prev = c % S::kStages;
        ++c;
        mbar_wait(full(c % S::kStages), (c / S::kStages) & 1);
        mma_k_tile(acc, ring + (c % S::kStages) * kABoxBytes, w_base + kt * S::kWBytes, false);
        wgmma_wait<1>();   // the k-tile before this one is complete
        release(prev);
      }
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(acc);
      release(c % S::kStages);
      gemm_epilogue<BN, EPI>(acc, b, m0 + warp * 16 + g, n0, t4, resid, out, M, N);
    }
  }
}

// The streaming kernel, for a W tile that does not fit shared memory (K = 1536
// at BN = 192): the same product on 128 x BN tiles, A in [128, 64] boxes, the
// two consumer warpgroups 64 rows of one tile each. grid (min(SMs, tiles)); a
// block takes tiles blockIdx.x, + gridDim.x, ..., the column tile running
// fastest, so that the blocks at work share a few row tiles of A in L2.
template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_stream_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const void* __restrict__ bias,
                   int pf32, const void* __restrict__ resid, void* __restrict__ out, int M,
                   int N, int k_tiles, int n_tiles, int n_items) {
  using S = StreamSmem<BN>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kStages * S::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S::kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGemmConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // ring position, advanced once a k-tile by the producer and by every consumer
  int stage = 0, phase = 0;
  auto advance = [&]() {
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (threadIdx.x >= kGemmConsumerWarps * 32) {
    // ---- producer warpgroup: one thread starts every TMA load and runs ahead
    // of the consumers by up to the ring's depth, across tiles ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kGemmConsumerWarps * 32) {
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int m0 = (item / n_tiles) * 128, n0 = (item % n_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);   // passes at once on the first round
          mbar_expect_tx(full(stage), S::kStageBytes);
          const uint32_t dst = base + stage * S::kStageBytes;
          tma_load_2d(dst, &map_a, full(stage), kt * kGemmBK, m0);
          tma_load_2d(dst + S::kABytes, &map_w, full(stage), kt * kGemmBK, n0);
          advance();
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows x BN columns of every tile each -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    float acc[BN / 2];
    auto start_tile = [&](bool first) {
      const uint32_t a_addr = base + stage * S::kStageBytes;
      mbar_wait(full(stage), phase);
      mma_k_tile(acc, a_addr + wg * kABoxBytes, a_addr + S::kABytes, first);
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty(s));
    };

    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int m0 = (item / n_tiles) * 128, n0 = (item % n_tiles) * BN;
      float2 b[BN / 8];
      load_bias<BN>(b, bias, pf32, n0, t4);   // arrives under the products
      start_tile(true);   // peeled, as in the resident kernel
      int prev = stage;
      advance();
      for (int kt = 1; kt < k_tiles; ++kt) {
        start_tile(false);
        wgmma_wait<1>();   // the k-tile before this one is complete
        release(prev);
        prev = stage;
        advance();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);
      gemm_epilogue<BN, EPI>(acc, b, m0 + wg * 64 + warp * 16 + g, n0, t4, resid, out, M, N);
    }
  }
}

// A row-major bf16 matrix [rows, cols] as a 2-D map with [box_rows, 64] boxes.
bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kGemmBK, (cuuint32_t)box_rows};
  return make_bf16_map(map, ptr, 2, dims, strides, box);
}

template <int BN, int EPI>
cudaError_t launch_gemm_bn(const bf16* A, const bf16* W, const void* bias, int pf32,
                           const void* resid, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  const int k_tiles = K / kGemmBK, n_tiles = N / BN;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
#ifdef ID_GEMM_STREAM_ONLY
  // a build for measurements: every product on the streaming kernel, to read
  // what the W-resident kernel buys (chip_smoke.py --gemm-ab)
  const bool resident = false;
#else
  const bool resident = ResidentSmem<BN>::bytes(k_tiles) <= kGemmMaxSmem && n_tiles <= sms;
#endif
  const int tile_rows = resident ? 64 : 128;
  const int m_tiles = (M + tile_rows - 1) / tile_rows;
  const long long n_items = (long long)m_tiles * n_tiles;
  CUtensorMap map_a, map_w;
  if (n_items > 2147483647LL || !make_map_2d(&map_a, A, M, K, tile_rows) ||
      !make_map_2d(&map_w, W, N, K, BN))
    return cudaErrorInvalidValue;
  if (resident) {
    const int smem = ResidentSmem<BN>::bytes(k_tiles);
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_resident_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int per_n = sms / n_tiles < m_tiles ? sms / n_tiles : m_tiles;
    gemm_resident_kernel<BN, EPI><<<per_n * n_tiles, kGemmThreads, smem, stream>>>(
        map_a, map_w, bias, pf32, resid, out, M, N, k_tiles, n_tiles, (int)n_items);
  } else {
    const int smem = StreamSmem<BN>::kBytes;
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_stream_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int grid = n_items < sms ? (int)n_items : sms;
    gemm_stream_kernel<BN, EPI><<<grid, kGemmThreads, smem, stream>>>(
        map_a, map_w, bias, pf32, resid, out, M, N, k_tiles, n_tiles, (int)n_items);
  }
  return cudaGetLastError();
}

// N and K multiples of 64. The widest tile that divides N serves it: 192 for
// the widths of the bench model (384, 1152, 1536), else 128, else 64.
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const void* bias, int pf32,
                        const void* resid, void* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 64 || K % kGemmBK) return cudaErrorInvalidValue;
  if (N % 192 == 0)
    return launch_gemm_bn<192, EPI>(A, W, bias, pf32, resid, out, M, N, K, stream);
  if (N % 128 == 0)
    return launch_gemm_bn<128, EPI>(A, W, bias, pf32, resid, out, M, N, K, stream);
  return launch_gemm_bn<64, EPI>(A, W, bias, pf32, resid, out, M, N, K, stream);
}

template <typename T>
cudaError_t launch_ln_film(const T* x, const bf16* gb, const void* scale, const void* bias,
                           int pf32, bf16* h, int M, int L, int D, int use_film,
                           cudaStream_t stream) {
  ln_film_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(x, gb, scale, bias, pf32, h, M, L, D,
                                                     use_film, 1e-6f);
  return cudaGetLastError();
}

}  // namespace

#define ID_TRY(call)                      \
  do {                                    \
    const cudaError_t e_ = (call);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// One FiLM pre-norm block, y = block(x), on `stream`. The caller allocates
// the scratch buffers h [M, D] bf16, qkv [M, 3D] bf16, o [M, D] bf16,
// x2 [M, D] f32, f [M, F] bf16 and the output y [M, D] bf16 (M = B * L).
// params_f32: the biases and LN vectors are f32 (else bf16).
// Requires D % 64 == 0, F % 64 == 0, D / H in {32, 64}, L <= 256.
extern "C" int id_fused_film_block(
    const void* x, const void* gb1, const void* gb2, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* wqkv, const void* bqkv, const void* wout,
    const void* bout, const void* wff1, const void* bff1, const void* wff2, const void* bff2,
    void* h, void* qkv, void* o, void* x2, void* f, void* y, int B, int L, int D, int H,
    int F, int use_film, int params_f32, float attn_scale, void* stream_ptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * L, pf = params_f32;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(h);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ob = static_cast<bf16*>(o);
  ID_TRY(launch_ln_film<bf16>(xb, static_cast<const bf16*>(gb1), ln1s, ln1b, pf, hb, M, L, D,
                              use_film, s));
  ID_TRY(launch_gemm<EPI_BIAS>(hb, static_cast<const bf16*>(wqkv), bqkv, pf, nullptr, qkvb, M,
                               3 * D, D, s));
  ID_TRY(launch_small_mha(qkvb, qkvb + D, qkvb + 2 * D, ob, B, L, H, D / H, 3 * D, 3 * D, 3 * D,
                          D, attn_scale, s));
  ID_TRY(launch_gemm<EPI_RESID_F32>(ob, static_cast<const bf16*>(wout), bout, pf, xb, x2, M, D,
                                    D, s));
  ID_TRY(launch_ln_film<float>(static_cast<const float*>(x2), static_cast<const bf16*>(gb2),
                               ln2s, ln2b, pf, hb, M, L, D, use_film, s));
  ID_TRY(launch_gemm<EPI_BIAS_SILU>(hb, static_cast<const bf16*>(wff1), bff1, pf, nullptr, f, M,
                                    F, D, s));
  ID_TRY(launch_gemm<EPI_RESID_OUT>(static_cast<const bf16*>(f),
                                    static_cast<const bf16*>(wff2), bff2, pf, x2, y, M, D, F,
                                    s));
  return 0;
}

// The GEMM alone: out[M, N] = epilogue(a[M, K] @ w[N, K]^T + bias[N]), a and w
// bf16 row-major, N and K multiples of 64. `epilogue` is one of enum Epilogue:
// 0 bias -> bf16; 1 bias + SiLU -> bf16; 2 bf16 resid[M, N] + (..) -> f32;
// 3 f32 resid[M, N] + (..) -> bf16. params_f32: bias is f32 (else bf16).
extern "C" int id_gemm_bias_act(const void* a, const void* w, const void* bias,
                                const void* resid, void* out, int M, int N, int K,
                                int epilogue, int params_f32, void* stream_ptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* wb = static_cast<const bf16*>(w);
  switch (epilogue) {
    case EPI_BIAS:
      return (int)launch_gemm<EPI_BIAS>(ab, wb, bias, params_f32, nullptr, out, M, N, K, s);
    case EPI_BIAS_SILU:
      return (int)launch_gemm<EPI_BIAS_SILU>(ab, wb, bias, params_f32, nullptr, out, M, N, K, s);
    case EPI_RESID_F32:
      return (int)launch_gemm<EPI_RESID_F32>(ab, wb, bias, params_f32, resid, out, M, N, K, s);
    case EPI_RESID_OUT:
      return (int)launch_gemm<EPI_RESID_OUT>(ab, wb, bias, params_f32, resid, out, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}
