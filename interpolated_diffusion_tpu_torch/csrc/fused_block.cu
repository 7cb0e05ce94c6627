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
// ~175 FLOP/byte, under the card's bf16 ridge of ~295), so both the MMA rate
// and the intermediates' round trips through device memory count. This
// first version uses warp-level bf16 MMA (WMMA 16x16x16, f32 accumulate) on
// 128x128x64 tiles with a three-stage cp.async ring (the best of a tile
// sweep: ~200 TFLOP/s at 65536 rows on an NVIDIA H100 80GB HBM3 at a 700 W
// limit, a third of what cuBLAS reached there), and fuses bias, SiLU and the
// residual into the GEMM epilogues so that no elementwise step makes its own
// pass over memory. wgmma, TMA and keeping h/f on chip are later work.
//
// Rounding points are those of the TPU kernel: h, qkv, p, o and the SiLU
// output are bf16; the residual stream x2 stays f32 inside the block; y is
// rounded to bf16 at the end. LayerNorm uses eps 1e-6 and E[x^2] - mu^2.
// x, the FiLM rows gb1/gb2 [B, 2D] and the four weight matrices (torch Linear
// layout [out, in]) are bf16. The four biases and the four LN vectors are
// either all f32 (a model with f32 master parameters under bf16 compute, as
// the trainers build it: the TPU kernel's types) or all bf16 (a model held in
// bf16 throughout; read into f32, which is exact): `params_f32` says which.
#include <mma.h>
#include <stdint.h>

#include "id_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

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

// Block tile BM x BN, k-tile BK, warp tile WM x WN, STAGES-deep cp.async ring.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDS = BK + 8;  // padded smem row (elements); WMMA needs ldm % 8 == 0
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr size_t SMEM = (size_t)STAGES * (BM + BN) * LDS * sizeof(bf16);
  static_assert(SMEM >= (size_t)WARPS * 256 * sizeof(float), "epilogue staging must fit");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias[N]); A, W bf16 row-major,
// f32 accumulation. Requires N % BN == 0 and K % BK == 0; M is masked.
template <class C, int EPI>
__global__ void __launch_bounds__(C::THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const void* __restrict__ bias, int pf32, const void* __restrict__ resid,
            void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);                 // [STAGES][BM][LDS]
  bf16* Ws = As + (size_t)C::STAGES * C::BM * C::LDS;             // [STAGES][BN][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (C::BN / C::WN), wn = warp % (C::BN / C::WN);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + (size_t)stage * C::BM * C::LDS;
    bf16* ws = Ws + (size_t)stage * C::BN * C::LDS;
    constexpr int CH = C::BK / 8;  // 16-byte chunks per row
    for (int c = tid; c < C::BM * CH; c += C::THREADS) {
      const int r = c / CH, kc = (c % CH) * 8;
      const int gr = m0 + r;
      const bf16* src = A + (long long)(gr < M ? gr : 0) * K + k0 + kc;
      cp_async16(as + r * C::LDS + kc, src, gr < M ? 16 : 0);  // rows >= M read as 0
    }
    for (int c = tid; c < C::BN * CH; c += C::THREADS) {
      const int r = c / CH, kc = (c % CH) * 8;
      cp_async16(ws + r * C::LDS + kc, W + (long long)(n0 + r) * K + k0 + kc, 16);
    }
  };

  const int KT = K / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s * C::BK);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread; tile kt-1 is consumed
    const int pre = kt + C::STAGES - 1;
    if (pre < KT) load_tile(pre % C::STAGES, pre * C::BK);
    cp_async_commit();
    const bf16* a = As + (size_t)(kt % C::STAGES) * C::BM * C::LDS;
    const bf16* w = Ws + (size_t)(kt % C::STAGES) * C::BN * C::LDS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * C::WM + i * 16) * C::LDS + kk, C::LDS);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(bfr[j], w + (wn * C::WN + j * 16) * C::LDS + kk, C::LDS);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to stage the epilogue

  // Epilogue: each 16x16 fragment goes through shared memory; a lane handles
  // 8 consecutive columns of one row (16-byte stores).
  float* cs = reinterpret_cast<float*>(gemm_smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < C::FM; ++i) {
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * C::WM + i * 16 + r;
      const int gc = n0 + wn * C::WN + j * 16 + c0;
      if (gr < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[r * 16 + c0 + e] + param_at(bias, gc + e, pf32);
        const long long off = (long long)gr * N + gc;
        if (EPI == EPI_RESID_F32) {
          const bf16* res = static_cast<const bf16*>(resid) + off;
          float* dst = static_cast<float*>(out) + off;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(res[e]) + v[e];
          reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          if (EPI == EPI_BIAS_SILU) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = v[e] * (1.f / (1.f + expf(-v[e])));
          }
          if (EPI == EPI_RESID_OUT) {
            const float* res = static_cast<const float*>(resid) + off;
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = res[e] + v[e];
          }
          __align__(16) bf16 packed[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(v[e]);
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) =
              *reinterpret_cast<const uint4*>(packed);
        }
      }
      __syncwarp();
    }
  }
}

template <class C, int EPI>
cudaError_t launch_gemm_cfg(const bf16* A, const bf16* W, const void* bias, int pf32,
                            const void* resid, void* out, int M, int N, int K,
                            cudaStream_t stream) {
  if (N % C::BN || K % C::BK) return cudaErrorInvalidValue;
  static bool smem_opted_in = false;  // once per instantiation; a repeat is harmless
  if (C::SMEM > 48 * 1024 && !smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<C, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return e;
    smem_opted_in = true;
  }
  const dim3 grid(N / C::BN, (M + C::BM - 1) / C::BM);
  gemm_kernel<C, EPI><<<grid, C::THREADS, C::SMEM, stream>>>(A, W, bias, pf32, resid, out, M, N,
                                                             K);
  return cudaGetLastError();
}

// The fastest of twelve tile configurations swept on the H100 at the block's
// shapes (B*L = 8192 and 65536 rows; N, K in {384, 1152, 1536}), and a
// smaller tile for the widths it does not divide.
using GemmLarge = GemmCfg<128, 128, 64, 64, 64, 3>;  // N % 128 == 0, K % 64 == 0
using GemmSmall = GemmCfg<128, 64, 32, 64, 32, 2>;   // N % 64 == 0, K % 32 == 0

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const void* bias, int pf32,
                        const void* resid, void* out, int M, int N, int K, cudaStream_t stream) {
  if (N % GemmLarge::BN == 0 && K % GemmLarge::BK == 0)
    return launch_gemm_cfg<GemmLarge, EPI>(A, W, bias, pf32, resid, out, M, N, K, stream);
  return launch_gemm_cfg<GemmSmall, EPI>(A, W, bias, pf32, resid, out, M, N, K, stream);
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
